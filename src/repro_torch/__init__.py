"""PyTorch/CUDA port of the `repro` package, module for module.

The JAX package under `src/repro` is the reference; every module here
names the reference module it ports.  This package imports torch and
numpy only -- never jax and nothing of `repro` -- and its kernels are
CUDA C++ written for Hopper (`kernels/csrc`), built with nvcc at first
use and bound through ctypes (`kernels/_build.py`).

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
asked for and absent: nothing falls back to the CPU silently.  On CPU
tensors every kernel wrapper runs its plain PyTorch version, which is
what the CPU tests exercise.
"""
