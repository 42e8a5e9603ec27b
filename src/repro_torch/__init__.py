"""HFAV on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch.core`` holds the compiler (front end, planner, KernelPlan
IR, host half and plain interpreter); ``repro_torch.kernels`` the
hand-written CUDA kernels the plans run on.  Nothing here imports JAX
or the ``repro`` package.
"""
