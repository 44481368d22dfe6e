"""The port's loggers (`rl4co_tpu_torch/loggers.py`) on the cases of the JAX
package's `tests/test_loggers.py`, and the MLflow file store against the one
the JAX package's `MLflowFileLogger` writes for the same records: the same
files with the same contents but for times, run ids and paths."""

import json
import os
import re

from rl4co_tpu.loggers import MLflowFileLogger as JaxMLflowFileLogger
from rl4co_tpu_torch.loggers import (
    AimLogger,
    CometLogger,
    CSVLogger,
    JSONLLogger,
    MLflowFileLogger,
    MultiLogger,
    NeptuneLogger,
    TensorBoardLogger,
    WandbLogger,
)


def test_jsonl_and_csv_roundtrip(tmp_path):
    ml = MultiLogger(JSONLLogger(str(tmp_path / "m.jsonl")), CSVLogger(str(tmp_path / "m.csv")))
    ml({"step": 0, "loss": 1.5, "note": "a"})
    ml({"step": 1, "loss": 1.25, "note": "b"})
    lines = (tmp_path / "m.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[1])["loss"] == 1.25
    csv_lines = (tmp_path / "m.csv").read_text().strip().splitlines()
    assert csv_lines[0] == "step,loss,note" and csv_lines[2] == "1.0,1.25,b"


def test_tensorboard_logger_writes_events(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tb = TensorBoardLogger(str(tmp_path / "tb"))
    tb({"step": 0, "loss": 2.0, "reward": -4.0})
    tb({"step": 1, "loss": 1.0, "reward": -3.0, "tag": "not-a-number"})
    tb.writer.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert "tag" not in acc.Tags()["scalars"]
    assert [(s.step, s.value) for s in acc.Scalars("loss")] == [(0, 2.0), (1, 1.0)]


def _store(root, lg):
    """Every file of an MLflow store by its path, run id and times masked."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            text = open(path).read().replace(lg.run_id, "RUN").replace(str(root), "ROOT")
            text = re.sub(r"^\d{13} ", "T ", text, flags=re.M)               # metric lines
            text = re.sub(r"(start_time|end_time): \d+", r"\1: T", text)
            out[os.path.relpath(path, root).replace(lg.run_id, "RUN")] = text
    return out


def test_mlflow_store_is_the_jax_loggers(tmp_path):
    records = [{"loss": 1.5, "it": 3, "note": "hello"}, {"loss": 1.25, "it": 4},
               {"epoch": 0, "val/reward": -5.5}]
    stores = []
    for cls, root in ((MLflowFileLogger, tmp_path / "port"), (JaxMLflowFileLogger,
                                                              tmp_path / "jax")):
        lg = cls(root=str(root), run_name="t")
        for r in records:
            lg(r)
        running = (root / "0" / lg.run_id / "meta.yaml").read_text()
        assert "status: 1" in running and "end_time: null" in running
        MultiLogger(lg).finalize()
        stores.append(_store(root, lg))
    port, jax_store = stores
    assert port == jax_store
    assert "status: 3" in port["0/RUN/meta.yaml"]
    assert port["0/RUN/metrics/loss"].splitlines() == ["T 1.5 3", "T 1.25 4"]
    assert port["0/RUN/params/note"] == "hello"


def test_import_guarded_remote_loggers_noop():
    for cls in (NeptuneLogger, CometLogger, AimLogger, WandbLogger):
        lg = cls()
        lg({"loss": 1.0, "step": 1})   # no package: a no-op
        lg.finalize()
