"""Tests of the benchmark's harness. They run on the CPU at tiny sizes, but
those marked ``card``, which skip without a CUDA device and run on the
machine with the H100: ``python3 -m pytest portbench/tests -m card``."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    """The CUDA device, or a skip; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the machine with the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# tiny sizes of the two configurations, for runs on the CPU
TINY_CFG = dict(embed_dim=32, num_heads=4, feedforward_hidden=64, num_loc=10, num_encoder_layers=2)
TINY_PARAMS = {
    "pomo_cvrp50.serve_aug8": dict(instances_per_dispatch=4, pool_dispatches=3, check_instances=8),
    "am_tsp100.train": dict(batch=16, pool_batches=4),
}
