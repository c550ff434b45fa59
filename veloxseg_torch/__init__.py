"""VeloxSeg in PyTorch for one NVIDIA H100: the eval forward,
sliding-window whole-volume inference and training, each from the
command line too (``cli.test_main``, ``cli.train_main``).

A port of ``veloxseg_tpu`` (JAX on a TPU), which stays the reference it is
held against. The port imports ``torch`` and numpy, never JAX nor the JAX
package. Public functions keep the JAX package's channels-last layout
``(B, D, H, W, C)``; inside, tensors are channels-first. The Pallas kernels
are CUDA kernels written for ``sm_90a`` (``csrc/``): the window attention
(K1; K2f/K2b and K3f/K3b in training), the two fused JLC stages (K4f,
K5f; K4b, K5b) and U-RWKV's WKV recurrence (K6).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version.
"""

__version__ = "0.1.0"
