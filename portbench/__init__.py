"""The benchmark of the PyTorch and CUDA port `rl4co_tpu_torch` (see `run.py`)."""
