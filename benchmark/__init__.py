"""The benchmark of the PyTorch and CUDA port, ``colddiff_torch``: see
``README.md`` here and ``BENCHMARK.json`` at the root."""
