"""The benchmark of the PyTorch and CUDA port (``python portbench/run.py``)."""
