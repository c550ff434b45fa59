"""Window layouts and the PWA window gather/scatter: the port against
``veloxseg_tpu.core.windows`` and ``veloxseg_tpu.nn.pwa``."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cf, cl, normal
from veloxseg_torch.core.config import VeloxSegConfig, load_json_config
from veloxseg_torch.core.windows import compute_window_layout
from veloxseg_torch.nn import pwa as port
from veloxseg_tpu.core.windows import \
    compute_window_layout as jax_compute_window_layout
from veloxseg_tpu.nn import pwa as jpwa

_CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "config", "models_config_*.json")))


def test_all_three_configs_found():
    assert [os.path.basename(p) for p in _CONFIGS] == [
        "models_config_autopetii.json", "models_config_brats2021.json",
        "models_config_hecktor2022.json"]


@pytest.mark.parametrize("path", _CONFIGS, ids=os.path.basename)
def test_window_layout_matches_jax_for_repo_config(path):
    cfg = VeloxSegConfig.from_dict(load_json_config(path)["VeloxSeg"])
    size = tuple(s // cfg.patch_size for s in cfg.input_size)
    for i in range(cfg.num_levels):
        args = (size, cfg.min_big_window_sizes[i],
                cfg.min_small_window_sizes[i], cfg.scale_factors[i],
                cfg.num_heads[i], cfg.min_dim_head[i],
                cfg.attn_base_ch * 2 ** i)
        got = dataclasses.asdict(compute_window_layout(*args))
        ref = dataclasses.asdict(jax_compute_window_layout(*args))
        assert got == ref, (path, i)
        size = tuple(s // 2 for s in size)


# (spatial, big, small, heads, c): AutoPET-like, Hecktor's anisotropic
# windows, and small windows > 1 (max-pooled tokens, interpolated scatter)
CASES = [
    ((12, 12, 12), (3, 3, 3), (1, 1, 1), 1, 4),
    ((16, 16, 8), (4, 4, 2), (1, 1, 1), 2, 8),
    ((16, 16, 8), (4, 4, 2), (2, 2, 1), 2, 3),
]


@pytest.mark.parametrize("spatial,big,small,heads,c", CASES)
def test_gather_scatter_match_jax(spatial, big, small, heads, c):
    layout = compute_window_layout(spatial, big, small, 2, heads, c, c)
    jlayout = jax_compute_window_layout(spatial, big, small, 2, heads, c, c)
    chans = layout.num_pairs * heads * c
    x = normal((2, *spatial, chans), seed=0)
    tok = port.window_gather(cf(x), layout, c)
    jtok = np.asarray(jpwa.window_gather(jnp.asarray(x), jlayout, c))
    assert tok.shape == jtok.shape
    # reshapes and max-pooling only: exact
    np.testing.assert_array_equal(tok.numpy(), jtok)

    t = normal(jtok.shape, seed=1)
    vox = port.window_scatter(torch.from_numpy(t), layout, c, spatial)
    jvox = np.asarray(jpwa.window_scatter(jnp.asarray(t), jlayout, c,
                                          spatial))
    # linear interpolation with two taps per output: fp32 rounding only
    np.testing.assert_allclose(cl(vox), jvox, rtol=1e-6, atol=1e-6)
