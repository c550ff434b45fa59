"""Sliding-window inference: the port against
``veloxseg_tpu.infer.sliding_window`` (tile grid, constant and gaussian
blending, zero padding of volumes smaller than the ROI). The predictor is
a fixed 1×1 linear map, so the JAX side runs its per-batch host loop and
no full-model compile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.infer import sliding_window as port
from veloxseg_tpu.infer import sliding_window as jsw


@pytest.mark.parametrize("size,roi,overlap", [
    ((200, 96, 150), (96, 96, 96), 0.25),
    ((192, 192, 192), (96, 96, 96), 0.25),
    ((37, 20, 19), (16, 16, 16), 0.5),
    ((10, 30, 8), (16, 16, 16), 0.25),
])
def test_tile_origins_match_jax(size, roi, overlap):
    assert port.compute_tile_origins(size, roi, overlap) == \
        jsw.compute_tile_origins(size, roi, overlap)


W = normal((2, 3), seed=0)
BIAS = normal((3,), seed=1)


def _torch_linear(t):
    return t @ torch.from_numpy(W) + torch.from_numpy(BIAS)


def _jax_linear(t):
    return t @ jnp.asarray(W) + jnp.asarray(BIAS)


# odd-sized volumes larger than the ROI on every axis, and smaller on some
@pytest.mark.parametrize("size", [(37, 21, 19), (11, 21, 9)])
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_blended_output_matches_jax(size, mode):
    x = normal((1, *size, 2), seed=2)
    got = port.sliding_window_inference(
        torch.from_numpy(x), (16, 16, 16), _torch_linear, sw_batch_size=3,
        overlap=0.25, mode=mode, device="cpu")
    ref = jsw.sliding_window_inference(
        jnp.asarray(x), (16, 16, 16), 3, _jax_linear, overlap=0.25,
        mode=mode)
    assert tuple(got.shape) == (1, *size, 3)
    # fp32 weighted sums of up to 8 tiles, then one division
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # a linear map blends back to itself wherever the tiles cover
    np.testing.assert_allclose(got.numpy(), x @ W + BIAS, rtol=1e-4,
                               atol=1e-4)


ROI = (16, 16, 16)
# a fixed ramp over the position inside the tile, per output channel
_RAMP = (np.linspace(0.0, 1.0, ROI[0])[:, None, None, None]
         + 2.0 * np.linspace(0.0, 1.0, ROI[1])[None, :, None, None]
         - np.linspace(0.0, 1.0, ROI[2])[None, None, :, None]
         ) * np.array([1.0, -0.5, 0.25])
RAMP = _RAMP.astype(np.float32)


# The linear map alone blends back to itself whatever the weights are. The
# ramp makes overlapping tiles disagree, so the blend weights (constant or
# gaussian, their sigma and clip) decide the result.
@pytest.mark.parametrize("size", [(37, 21, 19), (11, 21, 9)])
@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_position_dependent_blend_matches_jax(size, mode):
    x = normal((1, *size, 2), seed=3)
    got = port.sliding_window_inference(
        torch.from_numpy(x), ROI,
        lambda t: _torch_linear(t) + torch.from_numpy(RAMP), sw_batch_size=3,
        overlap=0.25, mode=mode, device="cpu")
    ref = jsw.sliding_window_inference(
        jnp.asarray(x), ROI, 3, lambda t: _jax_linear(t) + jnp.asarray(RAMP),
        overlap=0.25, mode=mode)
    # fp32 weighted sums of up to 8 tiles, then one division
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.sliding_window_inference(np.zeros((1, 8, 8, 8, 2), np.float32),
                                      (8, 8, 8), _torch_linear)
