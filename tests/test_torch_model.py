"""The port's whole eval forward against ``veloxseg_tpu``'s
``VeloxSeg.apply(train=False)`` on the CPU, same weights, same input; and
the weights' round trip through both key maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (BRATS_TINY, HECKTOR_TINY, TINY, configs,
                                normal, randomize_)
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg


def _port(cfg_dict, seed):
    tcfg, jcfg = configs(cfg_dict)
    model, _ = build_veloxseg(tcfg, device="cpu")
    randomize_(model, seed, scale=0.2)
    return model, jcfg


@pytest.mark.parametrize("name,cfg_dict", [("tiny", TINY),
                                           ("brats_tiny", BRATS_TINY),
                                           ("hecktor_tiny", HECKTOR_TINY)])
def test_eval_forward_matches_jax(name, cfg_dict):
    model, jcfg = _port(cfg_dict, seed=1)
    x = normal((1, *cfg_dict["input_size"], sum(cfg_dict["in_ch"])), seed=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    params = convert_state_dict(model.state_dict())
    # jitted: one XLA compile (~5 s) beats op-by-op dispatch (~30 s) here
    apply = jax.jit(lambda p, v: JaxVeloxSeg(jcfg).apply(
        {"params": p}, v, train=False))
    ref = np.asarray(apply(params, jnp.asarray(x)))
    assert got.shape == ref.shape == (1, *cfg_dict["input_size"],
                                      cfg_dict["n_classes"])
    assert np.isfinite(got).all()
    # fp32 on both sides, ~40 layers deep, sums taken in another order
    # (XLA's packed convs vs torch's): measured 3e-5 on a scale of 34 at
    # TINY, so 1e-5 of the output's scale leaves a 10x margin
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def test_state_dict_round_trip():
    model, _ = _port(TINY, seed=3)
    sd = model.state_dict()
    back = state_dict_from_jax(convert_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k
    model.load_state_dict(back)


def test_round_trip_skips_teachers_and_raises_on_unknown():
    model, _ = _port(TINY, seed=4)
    params = convert_state_dict(model.state_dict())
    params["rc_decoder_0"] = {"out_conv": {"kernel": np.zeros((3, 3, 3, 8, 64),
                                                               np.float32)}}
    assert set(state_dict_from_jax(params)) == set(model.state_dict())
    params["encoder"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        state_dict_from_jax(params)
