"""Shared helpers of the ``test_torch_*`` files: the port (``veloxseg_torch``)
held against the JAX package on the CPU, same weights, same inputs.

Weights: the port module is built, its parameters are overwritten with
seeded numpy values, and its ``state_dict()`` is mapped to JAX params with
``veloxseg_tpu.interop.torch_import.convert_state_dict`` (the JAX
``init`` is never run: it is slow unjitted).
"""

from __future__ import annotations

import numpy as np
import torch

from veloxseg_torch.core.config import VeloxSegConfig as TorchConfig

TINY = dict(
    input_size=(32, 32, 32),
    patch_size=4,
    in_ch=(1, 1),
    n_classes=2,
    base_ch=8,
    attn_base_ch=8,
    depths=(1, 1, 1, 1),
    min_big_window_sizes=((2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1)),
)
# tests/test_model.py:76-77: one modality with four channels
BRATS_TINY = dict(TINY, in_ch=(4,), n_classes=4)
# tests/test_model.py:94-97: anisotropic input and windows
HECKTOR_TINY = dict(
    TINY,
    input_size=(64, 64, 32),
    min_big_window_sizes=((4, 4, 2), (4, 4, 2), (2, 2, 1), (2, 2, 1)),
)


def configs(d: dict):
    """(port config, JAX config) of one config dict."""
    from veloxseg_tpu.core.config import VeloxSegConfig as JaxConfig
    return TorchConfig(**d), JaxConfig(**d)


def randomize_(module: torch.nn.Module, seed: int, scale: float = 0.3
               ) -> torch.nn.Module:
    """Overwrite every parameter with seeded N(0, scale²) values (biases,
    norms and position tables included, so nothing sits at its init)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * scale)
                .astype(np.float32)))
    return module


def normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def cl(x: torch.Tensor) -> np.ndarray:
    """Channels-first torch tensor → channels-last numpy array."""
    return np.ascontiguousarray(torch.movedim(x, 1, -1).detach().numpy())


def cf(x: np.ndarray) -> torch.Tensor:
    """Channels-last numpy array → channels-first torch tensor."""
    return torch.movedim(torch.from_numpy(np.asarray(x, np.float32)), -1, 1)


def dense(conv_w: torch.Tensor) -> np.ndarray:
    """1×1 conv ``(O, I, 1, 1, 1)`` → JAX Dense kernel ``(I, O)``."""
    w = conv_w.detach().numpy()
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def dhwio(conv_w: torch.Tensor) -> np.ndarray:
    """Conv ``(O, I/g, k, k, k)`` → JAX DHWIO kernel."""
    return np.ascontiguousarray(
        np.transpose(conv_w.detach().numpy(), (2, 3, 4, 1, 0)))


def cuda_or_skip() -> torch.device:
    """The card for a ``cuda``-marked test; skip where there is none.
    Called inside a test, never at import, so every worker collects the
    same tests."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
