"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel package provides ``kernel.py`` (the wrapper: bind, launch,
launch count, and the kernel's plain version for CPU tensors),
``ops.py`` (the user-facing entry point), ``ref.py`` (the plain oracle)
and ``csrc/`` (the CUDA sources).  Kernels are built by :mod:`.build`
with ``nvcc`` at first use, never at import.
"""
