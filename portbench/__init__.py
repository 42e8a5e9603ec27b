"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one
H100: see ``README.md`` beside this file and ``BENCHMARK.json`` at the
root of the repository."""
