"""`latest_step_dir` and `restore_checkpoint_raw` in the port
(`rl4co_tpu_torch/checkpoint.py`) against the JAX package's helpers
(`rl4co_tpu/checkpoint.py:38-56`) on the same layouts."""

import os

import pytest
import torch

from rl4co_tpu.checkpoint import latest_step_dir as jax_latest_step_dir
from rl4co_tpu_torch.checkpoint import (
    latest_step_dir,
    restore_checkpoint_raw,
    save_checkpoint,
)


@pytest.mark.parametrize("names", [["step_1", "step_10", "step_2"], ["step_7"], [],
                                   ["step_3", "other"]])
def test_latest_step_dir_is_the_jax_one_on_step_directories(tmp_path, names):
    for name in names:
        os.makedirs(tmp_path / name)
    assert latest_step_dir(str(tmp_path)) == jax_latest_step_dir(str(tmp_path))
    assert latest_step_dir(str(tmp_path / "missing")) is None
    assert jax_latest_step_dir(str(tmp_path / "missing")) is None


def test_saved_steps_and_raw_restore(tmp_path):
    tree = {"state": {"policy": {"w": torch.arange(3.0)}}, "epoch": 2}
    for step in (3, 12, 5):
        path = save_checkpoint(str(tmp_path), {**tree, "epoch": step}, step=step)
        assert path == os.path.join(str(tmp_path), f"step_{step}.pt")
    latest = latest_step_dir(str(tmp_path))
    assert latest == os.path.join(str(tmp_path), "step_12.pt")
    raw = restore_checkpoint_raw(latest)
    assert raw["epoch"] == 12 and raw["state"]["policy"]["w"].device.type == "cpu"
    assert torch.equal(raw["state"]["policy"]["w"], torch.arange(3.0))
