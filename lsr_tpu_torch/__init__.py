"""lsr_tpu_torch — the PyTorch/CUDA port of the lsr_tpu software renderer.

Mirrors lsr_tpu's sub-package layout and public names.  Plain tensor code is
PyTorch; each Pallas kernel of lsr_tpu on the ported path is a hand-written
CUDA kernel for Hopper (sm_90a) under csrc/, built at first use and loaded
through ctypes (utils/cuda_build.py).  Every kernel wrapper runs its plain
PyTorch version for CPU tensors and launches the kernel for CUDA tensors.
Entry points place their tensors on the CUDA card unless the caller passes
device="cpu" (core/util.default_device).

This package imports torch and numpy only — never jax or lsr_tpu.
"""
