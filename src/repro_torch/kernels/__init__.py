"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel package provides ``kernel.py`` (the wrapper: build, bind,
launch, launch count), ``ops.py`` (the user-facing entry point),
``ref.py`` (the plain oracle) and ``csrc/`` (the CUDA sources).
Kernels are built with ``nvcc`` at first use, never at import.
"""
