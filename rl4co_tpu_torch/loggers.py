"""Experiment loggers (counterpart of `rl4co_tpu/loggers.py`): callables that
take the trainer's metric dicts. JSONL and CSV files, TensorBoard event files
(`torch.utils.tensorboard`), an MLflow file store written without the
``mlflow`` package, and the fan-out `MultiLogger`; W&B, Neptune, Comet and
Aim behind `_init_guard`, no-ops where their packages are absent.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional


class JSONLLogger:
    """One JSON object per record, appended to ``path``: ``"t"`` (seconds since
    the logger was made, to the millisecond), then every metric as a float, or
    as a string where it is none (an env's name)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def __call__(self, metrics: dict) -> None:
        record = {"t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class CSVLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fieldnames: Optional[list] = None

    def __call__(self, metrics: dict) -> None:
        row = {}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        write_header = self._fieldnames is None
        if write_header:
            self._fieldnames = list(row.keys())
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                writer.writeheader()
            writer.writerow(row)


class WandbLogger:
    """Weights & Biases; a no-op without the ``wandb`` package (`_init_guard`)."""

    def __init__(self, project: str = "rl4co-tpu", **kwargs):
        def ctor():
            import wandb  # type: ignore

            return wandb.init(project=project, **kwargs)

        self.run = _init_guard("wandb", ctor)

    def __call__(self, metrics: dict) -> None:
        if self.run is None:
            return
        self.run.log(dict(metrics))

    def finalize(self) -> None:
        if self.run is not None:
            self.run.finish()


class TensorBoardLogger:
    """TensorBoard event files in ``logdir`` (`torch.utils.tensorboard`).
    Each numeric metric is a scalar at the record's ``step`` (or ``it``)
    when it has one, else at an internal counter."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(logdir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=logdir)
        self._auto_step = 0

    def __call__(self, metrics: dict) -> None:
        step = metrics.get("step", metrics.get("it", self._auto_step))
        try:
            step = int(step)
        except (TypeError, ValueError):
            step = self._auto_step
        for k, v in metrics.items():
            if k in ("step", "it"):
                continue
            try:
                self.writer.add_scalar(k, float(v), global_step=step)
            except (TypeError, ValueError):
                continue
        self.writer.flush()
        self._auto_step = max(self._auto_step + 1, step + 1)


class MLflowFileLogger:
    """An MLflow file store with no ``mlflow`` package: the ``mlruns/``
    layout the MLflow UI reads, ``meta.yaml`` per experiment and run (status
    1, RUNNING, until `finalize` writes 3, FINISHED), one ``metrics/<name>``
    file of ``timestamp value step`` lines per numeric metric and a
    ``params/<name>`` file per other value."""

    def __init__(self, root: str = "mlruns", experiment: str = "rl4co-tpu",
                 run_name: Optional[str] = None):
        import uuid

        self.exp_id = "0"
        self.run_id = uuid.uuid4().hex
        self.run_dir = os.path.join(root, self.exp_id, self.run_id)
        os.makedirs(os.path.join(self.run_dir, "metrics"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "params"), exist_ok=True)
        exp_meta = os.path.join(root, self.exp_id, "meta.yaml")
        if not os.path.exists(exp_meta):
            with open(exp_meta, "w") as f:
                f.write(
                    f"artifact_location: {os.path.abspath(root)}/{self.exp_id}\n"
                    f"experiment_id: '{self.exp_id}'\n"
                    f"lifecycle_stage: active\nname: {experiment}\n"
                )
        self._run_name = run_name or self.run_id[:8]
        self._start_ms = int(time.time() * 1000)
        self._write_meta(status=1, end_time="null")  # RUNNING
        self._step = 0

    def _write_meta(self, status: int, end_time) -> None:
        with open(os.path.join(self.run_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_uri: {os.path.abspath(self.run_dir)}/artifacts\n"
                f"end_time: {end_time}\nentry_point_name: ''\n"
                f"experiment_id: '{self.exp_id}'\nlifecycle_stage: active\n"
                f"run_id: {self.run_id}\nrun_name: {self._run_name}\n"
                f"run_uuid: {self.run_id}\nsource_name: ''\nsource_type: 4\n"
                f"source_version: ''\nstart_time: {self._start_ms}\n"
                f"status: {status}\n"
                f"tags: []\nuser_id: {os.environ.get('USER', 'rl4co')}\n"
            )

    def finalize(self) -> None:
        """Mark the run FINISHED (status 3 and its end time); called by
        `MultiLogger.finalize` when `Trainer.fit` ends; idempotent."""
        self._write_meta(status=3, end_time=int(time.time() * 1000))

    @staticmethod
    def _safe(name: str) -> str:
        return name.replace("/", "-").replace(" ", "_")

    def __call__(self, metrics: dict) -> None:
        step = metrics.get("step", metrics.get("it", self._step))
        try:
            step = int(step)
        except (TypeError, ValueError):
            step = self._step
        now_ms = int(time.time() * 1000)
        for k, v in metrics.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                # non-numeric → param file (last write wins, like mlflow)
                with open(os.path.join(self.run_dir, "params",
                                       self._safe(k)), "w") as f:
                    f.write(str(v))
                continue
            with open(os.path.join(self.run_dir, "metrics",
                                   self._safe(k)), "a") as f:
                f.write(f"{now_ms} {val} {step}\n")
        self._step = max(self._step + 1, step + 1)


def _init_guard(backend: str, ctor):
    """Run a remote logger's constructor: a package that is not installed
    gives a silent no-op (None); any other failure (a bad project, no
    credentials, an installed package that fails to import) one warning on
    stderr before the no-op, so that a misconfiguration does not discard
    metrics unsaid. Returns the run object or None."""
    import importlib.util
    import sys

    try:
        return ctor()
    except ImportError as e:
        mod = {"comet": "comet_ml"}.get(backend, backend)
        if importlib.util.find_spec(mod) is None:
            return None  # genuinely not installed — the intended no-op
        print(f"[rl4co-tpu] {backend} is installed but failed to import "
              f"({e}); continuing without {backend} logging", file=sys.stderr)
        return None
    except Exception as e:  # noqa: BLE001 - degrade, but say so
        print(f"[rl4co-tpu] {backend} logger init failed ({type(e).__name__}: "
              f"{e}); continuing without {backend} logging", file=sys.stderr)
        return None


class NeptuneLogger:
    """Neptune: each numeric metric appended to the run's series of its
    name; a no-op without the ``neptune`` package (`_init_guard`)."""

    def __init__(self, project: Optional[str] = None, **kwargs):
        def ctor():
            import neptune  # type: ignore

            return neptune.init_run(project=project, **kwargs)

        self.run = _init_guard("neptune", ctor)

    def __call__(self, metrics: dict) -> None:
        if self.run is None:
            return
        for k, v in metrics.items():
            try:
                self.run[k].append(float(v))
            except (TypeError, ValueError):
                self.run[k] = str(v)

    def finalize(self) -> None:
        if self.run is not None:
            self.run.stop()


class CometLogger:
    """Comet ML; a no-op without the ``comet_ml`` package (`_init_guard`)."""

    def __init__(self, project_name: str = "rl4co-tpu", **kwargs):
        def ctor():
            import comet_ml  # type: ignore

            return comet_ml.Experiment(project_name=project_name, **kwargs)

        self.exp = _init_guard("comet", ctor)

    def __call__(self, metrics: dict) -> None:
        if self.exp is None:
            return
        step = metrics.get("step", metrics.get("it"))
        numeric = {}
        for k, v in metrics.items():
            try:
                numeric[k] = float(v)
            except (TypeError, ValueError):
                self.exp.log_parameter(k, str(v))
        if numeric:
            try:
                self.exp.log_metrics(numeric, step=int(step) if step is not None else None)
            except (TypeError, ValueError):
                self.exp.log_metrics(numeric)

    def finalize(self) -> None:
        if self.exp is not None:
            self.exp.end()


class AimLogger:
    """Aim; a no-op without the ``aim`` package (`_init_guard`)."""

    def __init__(self, repo: Optional[str] = None, experiment: str = "rl4co-tpu"):
        def ctor():
            import aim  # type: ignore

            return aim.Run(repo=repo, experiment=experiment)

        self.run = _init_guard("aim", ctor)

    def __call__(self, metrics: dict) -> None:
        if self.run is None:
            return
        step = metrics.get("step", metrics.get("it"))
        for k, v in metrics.items():
            try:
                self.run.track(float(v), name=k,
                               step=int(step) if step is not None else None)
            except (TypeError, ValueError):
                self.run[k] = str(v)

    def finalize(self) -> None:
        if self.run is not None:
            self.run.close()


class MultiLogger:
    """Every record to each of ``loggers``; `finalize` reaches those that have
    a ``finalize`` or ``close``."""

    def __init__(self, *loggers):
        self.loggers = loggers

    def __call__(self, metrics: dict) -> None:
        for lg in self.loggers:
            lg(metrics)

    def finalize(self) -> None:
        for lg in self.loggers:
            fin = getattr(lg, "finalize", None) or getattr(lg, "close", None)
            if callable(fin):
                fin()
