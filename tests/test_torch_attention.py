"""K1, the eval window attention: the port's plain version against the JAX
Pallas kernel (interpret mode) and its XLA einsum reference. The CUDA
kernel against the plain version is in ``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.ops import pwa_attention as port
from veloxseg_tpu.ops.pwa_attention import (window_attention_pallas,
                                            window_attention_xla)

# (L, Cqk, Cv): AutoPET L0 and L3, AutoPET L1 (432 = 2 modalities x 6^3),
# Hecktor L0 (64 = 2 x 4·4·2)
SHAPES = [(54, 4, 4), (54, 16, 32), (432, 8, 8), (64, 8, 8)]


def _inputs(l, c_qk, c_v, b=2, h=2, n=5, seed=0):
    return (normal((b, h, n, c_qk, l), seed),
            normal((b, h, n, c_qk, l), seed + 1),
            normal((b, h, n, c_v, l), seed + 2),
            normal((h, l, l), seed + 3))


@pytest.mark.parametrize("l,c_qk,c_v", SHAPES)
def test_plain_matches_jax(l, c_qk, c_v):
    # n = 5 windows: ragged against any window block of the Pallas grid
    q, k, v, bias = _inputs(l, c_qk, c_v, n=3 if l > 128 else 5)
    scale = 1.0 / np.sqrt(c_qk)
    got = port.window_attention(*map(torch.from_numpy, (q, k, v, bias)),
                                scale).numpy()
    ref_xla = np.asarray(window_attention_xla(
        *map(jnp.asarray, (q, k, v, bias)), scale))
    ref_pallas = np.asarray(window_attention_pallas(
        *map(jnp.asarray, (q, k, v, bias)), scale, block_windows=2,
        interpret=True))
    assert got.shape == ref_xla.shape == (*q.shape[:3], c_v, l)
    # fp32 softmax over L <= 432 terms with O(1) values: 1e-5 absolute is
    # ~100 ulp of the outputs
    np.testing.assert_allclose(got, ref_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_counting():
    q, k, v, bias = map(torch.from_numpy, _inputs(54, 4, 4))
    before = port.window_attention.launches
    out = port.window_attention(q, k, v, bias, 0.5)
    assert port.window_attention.launches == before
    torch.testing.assert_close(
        out, port.window_attention_plain(q, k, v, bias, 0.5), rtol=0, atol=0)

