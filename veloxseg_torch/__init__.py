"""VeloxSeg in PyTorch for one NVIDIA H100: the eval forward and
sliding-window whole-volume inference.

A port of ``veloxseg_tpu`` (JAX on a TPU), which stays the reference it is
held against. The port imports ``torch`` and numpy, never JAX nor the JAX
package. Public functions keep the JAX package's channels-last layout
``(B, D, H, W, C)``; inside, tensors are channels-first. The Pallas kernels
on this path are CUDA kernels written for ``sm_90a`` (``csrc/``): the eval
window attention (K1) and the two fused JLC stages (K4f, K5f).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version.
"""

__version__ = "0.1.0"
