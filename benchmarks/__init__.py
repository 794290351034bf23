"""The benchmark of the PyTorch and CUDA port, ``delphy_tpu_torch``
(``python3 -m benchmarks.run``; see ``run.py``)."""
