"""U-RWKV serving in the port against ``veloxseg_tpu`` on the CPU: the WKV
recurrence (``wkv_plain`` against ``wkv_scan``), the directional scans and
the q-shift permutation, the registry, the whole forward through the
weights carried across by ``urwkv_state_dict_from_jax``, and the sliding
window with the U-RWKV predictor. The CUDA kernel K6 against ``wkv_plain``
is in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.infer.sliding_window import sliding_window_inference
from veloxseg_torch.interop.zoo_params import urwkv_state_dict_from_jax
from veloxseg_torch.models import registry
from veloxseg_torch.models.zoo import urwkv as port
from veloxseg_torch.ops import wkv as wkv_ops
from veloxseg_tpu.infer import sliding_window as jsw
from veloxseg_tpu.models.zoo import urwkv as jurwkv
from veloxseg_tpu.ops.wkv import wkv_scan

AUTOPET = {"U-RWKV": {"input_channel": 2, "num_classes": 2}}


@pytest.mark.parametrize("b,t,c,decay", [(2, 27, 16, "urwkv"),
                                         (3, 40, 8, "negative")])
def test_wkv_plain_matches_wkv_scan(b, t, c, decay):
    rng = np.random.default_rng(0)
    if decay == "urwkv":
        # U-RWKV's arguments: w = spatial_decay / T, u = spatial_first / T
        d0, f0, *_ = port._fancy_init(c)
        w, u = d0 / t, f0 / t
    else:
        w = -np.exp(rng.standard_normal(c)).astype(np.float32)
        u = rng.standard_normal(c).astype(np.float32)
    k = (rng.standard_normal((b, t, c)) * 2).astype(np.float32)
    v = rng.standard_normal((b, t, c)).astype(np.float32)
    n0 = wkv_ops.wkv.launches
    got = wkv_ops.wkv(*(torch.from_numpy(np.asarray(a, np.float32))
                        for a in (w, u, k, v)))
    assert wkv_ops.wkv.launches == n0       # the CPU takes the plain loop
    ref = wkv_scan(*(jnp.asarray(a, jnp.float32) for a in (w, u, k, v)))
    # the same fp32 recurrence step by step
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_scans_and_q_shift_match_jax():
    x = normal((2, 3, 4, 5, 6), seed=1)
    spatial = (3, 4, 5)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for order, flip in port._SCAN_SPECS:
        seq = port._scan(xt, order, flip)
        ref = np.asarray(jurwkv._scan(xj, order, flip))
        np.testing.assert_array_equal(seq.numpy(), ref)
        back = port._scan_inv(seq, spatial, order, flip)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            port._q_shift_scramble(seq, spatial).numpy(),
            np.asarray(jurwkv._q_shift_scramble(jnp.asarray(ref), spatial)))
    for got, ref in zip(port._fancy_init(16), jurwkv._fancy_init(16)):
        np.testing.assert_array_equal(got, ref)


def test_registry_builds_both_models():
    assert {"U-RWKV", "VeloxSeg"} <= set(registry.available_models())
    model = registry.load_model("U-RWKV", AUTOPET, device="cpu", seed=0)
    assert isinstance(model, port.URWKV) and not model.training
    again = registry.load_model("U-RWKV", AUTOPET, device="cpu", seed=0)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="No model named"):
        registry.load_model("nnUNet", {"nnUNet": {}}, device="cpu")


@pytest.fixture(scope="module")
def models():
    """The JAX model's init params, every leaf moved off its init by seeded
    noise, and the port's U-RWKV holding the same weights."""
    x0 = jnp.zeros((1, 32, 32, 32, 2), jnp.float32)
    jmodel = jurwkv.URWKV(num_classes=2)
    params = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(0), x0, train=False)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    model = port.URWKV(2, 2)
    model.load_state_dict(urwkv_state_dict_from_jax(params), strict=True)
    apply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              train=False))
    return model.eval(), params, apply


def test_forward_matches_jax(models):
    model, params, apply = models
    # two tiles: the batch norms take statistics over both
    x = normal((2, 32, 32, 32, 2), seed=4)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    ref = np.asarray(apply(params, jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 32, 32, 32, 2)
    # fp32 through ~40 convs and batch norms, sums taken in other orders:
    # against a float64 run of the same weights the JAX forward is off by
    # 1.4e-4 of the output's max (the port by 0.4e-4), so 3e-4 of it
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=3e-4 * float(np.abs(ref).max()))


def test_sliding_window_matches_jax(models):
    model, params, apply = models
    # 3 × 2 × 1 tiles of 32³ in three calls of 2: no call is padded
    x = normal((1, 64, 48, 32, 2), seed=5)
    got = sliding_window_inference(torch.from_numpy(x), (32, 32, 32), model,
                                   sw_batch_size=2, overlap=0.25,
                                   device="cpu")
    ref = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(x), (32, 32, 32), 2, apply, overlap=0.25,
        params=params))
    assert got.shape == ref.shape == (1, 64, 48, 32, 2)
    # the forward's tolerance: blending adds a few fp32 operations
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=3e-4 * float(np.abs(ref).max()))


def test_sliding_window_ragged_call_matches_jax(models):
    model, params, apply = models
    # 6 tiles in calls of 4: the last call holds 2 tiles and two copies of
    # the first, as in the JAX loop, so the batch norms see what JAX's see
    x = normal((1, 64, 48, 32, 2), seed=6)
    got = sliding_window_inference(torch.from_numpy(x), (32, 32, 32), model,
                                   sw_batch_size=4, overlap=0.25,
                                   device="cpu")
    ref = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(x), (32, 32, 32), 4, apply, overlap=0.25,
        params=params))
    # with a last call of 2 tiles alone (MONAI's way) the result is not
    # the reference's: the batch norms would take other statistics there
    origins = jsw.compute_tile_origins((64, 48, 32), (32, 32, 32), 0.25)
    tail = np.concatenate([x[:, o[0]:o[0] + 32, o[1]:o[1] + 32,
                             o[2]:o[2] + 32] for o in origins[4:]])
    with torch.no_grad():
        alone = model(torch.from_numpy(tail)).numpy()
    padded = np.asarray(apply(params, jnp.asarray(np.concatenate(
        [tail, x[:, :32, :32, :32], x[:, :32, :32, :32]]))))[:2]
    tol = 3e-4 * float(np.abs(ref).max())
    assert float(np.abs(alone - padded).max()) > 10 * tol
    # the forward's tolerance, as above
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=tol)
