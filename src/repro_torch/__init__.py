"""PyTorch/CUDA port of the repro package, for one NVIDIA Hopper card.

Mirrors `src/repro/` path for path and name for name, imports nothing
from it, and never imports JAX. Its kernels are CUDA C++ for `sm_90a`
under `kernels/*/csrc/`, built at first use (`kernels/_build.py`); each
has its plain PyTorch version beside it, which runs on CPU tensors.
"""
