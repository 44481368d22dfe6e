"""Training orchestration (counterpart of `rl4co_tpu/trainer.py`).

A plain epoch loop around the algorithm's eager train step; every step
generates a fresh batch on the device. Speed metrics: ``time/epoch_s`` and
env-steps/s, read from the host clock after the device has been
synchronised.

Checkpointing: monitor ``val/reward`` (max), keep ``best.pt`` and
``last.pt`` under ``ckpt_dir``; resume with ``fit(resume_from=...)``. The
random streams derive from (seed, stream, epoch), so a run resumed at an
epoch boundary replays the uninterrupted schedule.

``steps_per_dispatch`` has the JAX meaning: an algorithm with a
``make_train_step(batch_size, chunk)`` (`rl/multi_env.py`) runs ``chunk``
steps per dispatch, ``chunk`` the largest divisor of the epoch's steps up to
``steps_per_dispatch`` (default ``log_every``), and each dispatch is logged.
For the multi-env algorithm that is the length of each env's block of steps,
so it changes what is trained. Every other algorithm takes one
``train_step(batch_size)`` per step.

With a ``mesh`` (`rl4co_tpu_torch.parallel.mesh`), for an algorithm whose
``data_parallel`` is true (it raises for any other), every rank runs this loop:
the parameters start from rank 0's, each train step runs on the rank's rows
of the global batch (``batch_size``, which must divide by the ranks),
validation runs the whole set on every rank, and rank 0 alone logs and
writes checkpoints.

``profile_dir``: `torch.profiler` traces ``profile_steps`` train steps of the
first epoch after its first dispatch (closed before validation if the epoch
is shorter) into ``<profile_dir>/trace[_rank<r>].json``, and the trainer
logs ``profile/steps``, ``profile/wall_ms`` and ``profile/device_busy_ms``
(the sum of the device's kernel times; 0 on the CPU). The JAX trainer's
CPU-backend initialisation and key placement work around a remote TPU and
have no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional

import torch

from rl4co_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from rl4co_tpu_torch.parallel.mesh import Mesh, replicate
from rl4co_tpu_torch.rl.baselines import RolloutBaseline, WarmupBaseline
from rl4co_tpu_torch.rl.reinforce import seeded_generator

# streams of the trainer's seed: (seed, stream[, epoch])
_STREAM_HELD_OUT, _STREAM_VAL, _STREAM_EPOCH, _STREAM_TEST = range(4)


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    batch_size: int = 512
    train_data_size: int = 1_280_000   # samples per epoch
    val_data_size: int = 10_000
    val_batch_size: int = 1024
    seed: int = 1234
    log_every: int = 50
    # torch.profiler trace of `profile_steps` train steps of the first epoch,
    # after its first dispatch, into this directory
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    # When ckpt_dir is set, `fit` writes `<ckpt_dir>/last.pt` every
    # `ckpt_every` epochs and `<ckpt_dir>/best.pt` whenever the monitored
    # value improves.
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    monitor: str = "reward"            # metric of the primary val set, maximized
    # Wall-time budget: stop cleanly after the first epoch that ends beyond
    # this many hours (writing `last.pt`, so that `fit(resume_from=...)`
    # picks up the identical schedule).
    max_hours: Optional[float] = None
    # Steps per dispatch for an algorithm with `make_train_step(batch_size,
    # chunk)`: None -> the largest divisor of steps_per_epoch <= log_every;
    # 1 -> one step per dispatch.
    steps_per_dispatch: Optional[int] = None


class Trainer:
    """Minimal epoch-loop trainer around an algorithm object exposing
    ``train_step`` (or ``make_train_step``) ``/ make_eval_step / epoch_end /
    reseed / state_dict / load_state_dict`` and ``env`` (the env it
    generates validation sets on), such as `rl4co_tpu_torch.rl.reinforce.REINFORCE`.
    It runs on the algorithm's device."""

    def __init__(self, algorithm, config: Optional[TrainerConfig] = None,
                 mesh: Optional[Mesh] = None,
                 logger: Optional[Callable[[dict], None]] = None):
        self.algo = algorithm
        self.config = config or TrainerConfig()
        self.mesh = mesh
        self.logger = logger or (lambda m: print({k: _fmt(v) for k, v in m.items()}))
        if mesh is not None and mesh.rank != 0:
            self.logger = lambda m: None   # rank 0 logs
        self.history: list[dict] = []

    def _sync(self) -> None:
        if self.algo.device.type == "cuda":
            torch.cuda.synchronize(self.algo.device)

    def fit(self, resume_from: Optional[str] = None,
            val_datasets: Optional[dict] = None):
        """Run the training loop (`_fit`), then close the logger (its
        ``finalize``, if it has one) however the loop ended."""
        try:
            return self._fit(resume_from, val_datasets)
        finally:
            fin = getattr(self.logger, "finalize", None)
            if callable(fin):
                fin()

    def _fit(self, resume_from: Optional[str] = None,
             val_datasets: Optional[dict] = None):
        """Run the training loop; returns the algorithm, which holds the
        trained policy, the optimiser, the baseline state and the step count.

        Args:
            resume_from: checkpoint file written by a previous ``fit``
                (``<ckpt_dir>/last.pt`` or ``best.pt``). Restores policy,
                optimiser and baseline state, epoch counter and the rollout
                baseline's incumbent rewards, then continues.
            val_datasets: ``{name: instances}`` evaluated every epoch. The
                first entry is the primary set whose ``val/reward`` is
                monitored for ``best.pt``. Defaults to one generated set
                logged as plain ``val/*``.
        """
        cfg, algo, mesh = self.config, self.algo, self.mesh
        env, device = algo.env, algo.device
        host: dict = {}
        if mesh is not None:
            if not getattr(algo, "data_parallel", False):
                raise ValueError(f"{type(algo).__name__} does not train data-parallel")
            mesh.local_batch(cfg.batch_size)   # raises unless it divides
            replicate(algo.policy, mesh)
            bl_policy = getattr(getattr(algo, "baseline_state", None), "bl_policy", None)
            if bl_policy is not None:
                replicate(bl_policy, mesh)
        writes = mesh is None or mesh.rank == 0

        n_params = sum(p.numel() for p in algo.policy.parameters())
        self.logger({"model/params_total": n_params, "seed": cfg.seed,
                     "batch_size": cfg.batch_size, "epochs": cfg.epochs})

        # Rollout-baseline setup: held-out set + the incumbent's rewards.
        bl = getattr(algo, "baseline", None)
        if isinstance(bl, WarmupBaseline):
            bl = bl.inner
        if isinstance(bl, RolloutBaseline):
            n_eval = min(cfg.val_data_size, 2048)
            host["eval_instances"] = env.generate(
                n_eval, seeded_generator(device, cfg.seed, _STREAM_HELD_OUT), device)
            host["eval_rewards"] = algo.greedy_reward_fn()(
                algo.policy, host["eval_instances"]).cpu().numpy()

        if val_datasets is None:
            val_datasets = {"": env.generate(
                cfg.val_data_size, seeded_generator(device, cfg.seed, _STREAM_VAL), device)}

        start_epoch = 0
        best_monitor = -math.inf
        if resume_from is not None:
            restored = restore_checkpoint(resume_from, map_location=device)
            algo.load_state_dict(restored["state"])
            start_epoch = int(restored["epoch"])
            best_monitor = float(restored["best_monitor"])
            if "eval_rewards" in restored:
                host["eval_rewards"] = restored["eval_rewards"].cpu().numpy()
            self.logger({"resumed_from": resume_from, "epoch": start_epoch,
                         "best_monitor": best_monitor})

        steps_per_epoch = max(1, cfg.train_data_size // cfg.batch_size)
        chunk = self._pick_chunk(steps_per_epoch)
        dispatch = (algo.make_train_step(cfg.batch_size, chunk)
                    if hasattr(algo, "make_train_step") else None)
        eval_step = algo.make_eval_step()

        step_kwargs = {} if mesh is None else {"mesh": mesh}
        profiler = None
        fit_t0 = time.perf_counter()
        for epoch in range(start_epoch, cfg.epochs):
            algo.reseed(cfg.seed, _STREAM_EPOCH, epoch)
            self._sync()
            t0 = time.perf_counter()
            for it in range(0, steps_per_epoch, chunk):
                if cfg.profile_dir and epoch == start_epoch and it == chunk:
                    profiler = (self._start_profile(), time.perf_counter())  # not dispatch 0
                metrics = (dispatch() if dispatch
                           else algo.train_step(cfg.batch_size, **step_kwargs))
                if profiler is not None and it // chunk >= cfg.profile_steps:
                    self._stop_profile(*profiler, it // chunk)
                    profiler = None
                # the only fetches of the loop: a dispatch of several steps is
                # logged under its last step's index
                if chunk > 1:
                    self.logger({"epoch": epoch, "it": it + chunk - 1, **_fetch(metrics)})
                elif it % cfg.log_every == 0:
                    self.logger({"epoch": epoch, "it": it, **_fetch(metrics)})
            if profiler is not None:   # a short epoch: close the trace before validation
                self._stop_profile(*profiler, steps_per_epoch // chunk - 1)
                profiler = None
            self._sync()
            train_s = time.perf_counter() - t0

            # an improvement env has no episode length: T_train moves per batch
            ep_len = getattr(env, "max_steps", None) or getattr(algo, "T_train", None)
            record = {"epoch": epoch, "time/epoch_s": train_s}
            if ep_len is not None:
                record["env_steps_per_s"] = steps_per_epoch * cfg.batch_size * ep_len / train_s
            monitor_val = None
            for name, instances in val_datasets.items():
                vm = self._validate(eval_step, instances)
                prefix = f"val/{name}/" if name else "val/"
                record.update({f"{prefix}{k}": v for k, v in vm.items()})
                if monitor_val is None:
                    monitor_val = vm.get(cfg.monitor)
            self.history.append(record)
            self.logger(record)

            host = algo.epoch_end(host)

            out_of_time = (
                cfg.max_hours is not None
                and time.perf_counter() - fit_t0 > cfg.max_hours * 3600
            )

            if cfg.ckpt_dir and writes:
                tree = _ckpt_tree(algo, epoch + 1, max(
                    best_monitor, monitor_val if monitor_val is not None else -math.inf), host)
                if ((epoch + 1) % cfg.ckpt_every == 0 or epoch + 1 == cfg.epochs
                        or out_of_time):
                    save_checkpoint(f"{cfg.ckpt_dir}/last.pt", tree)
                if monitor_val is not None and monitor_val > best_monitor:
                    best_monitor = monitor_val
                    save_checkpoint(f"{cfg.ckpt_dir}/best.pt", tree)
                    self.logger({"epoch": epoch, "ckpt/best_monitor": best_monitor})

            if out_of_time:
                self.logger({"epoch": epoch, "stopped": "max_hours",
                             "max_hours": cfg.max_hours})
                break

        return algo

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.algo.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, t0: float, steps: int) -> None:
        """Close the trace of ``steps`` train steps: write it and log its
        wall time and the device's busy time over it."""
        from torch.autograd import DeviceType

        self._sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        name = "trace.json" if self.mesh is None else f"trace_rank{self.mesh.rank}.json"
        prof.export_chrome_trace(os.path.join(self.config.profile_dir, name))
        # the device's kernels; an annotated region's row there (`Optimizer.step#...`)
        # repeats its kernels' time
        busy_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.name.startswith("Optimizer."))
        self.logger({"profile/steps": steps, "profile/wall_ms": wall_ms,
                     "profile/device_busy_ms": busy_us / 1e3})

    def _pick_chunk(self, steps_per_epoch: int) -> int:
        """The largest divisor of ``steps_per_epoch`` up to the configured
        dispatch size, or 1 when the algorithm has no ``make_train_step``."""
        cfg = self.config
        if cfg.steps_per_dispatch == 1 or not hasattr(self.algo, "make_train_step"):
            return 1
        target = min(cfg.steps_per_dispatch or cfg.log_every, steps_per_epoch)
        return max(c for c in range(1, target + 1) if steps_per_epoch % c == 0)

    def test(self, datasets: Optional[dict] = None) -> dict:
        """Test phase on named datasets ``{name: instances}``; defaults to one
        freshly generated set named ``"test"``. Returns
        ``{f"test/{name}/reward": float, ...}`` and logs it."""
        cfg, algo = self.config, self.algo
        if datasets is None:
            datasets = {"test": algo.env.generate(
                cfg.val_data_size, seeded_generator(algo.device, cfg.seed, _STREAM_TEST),
                algo.device)}
        eval_step = algo.make_eval_step()
        record = {}
        for name, instances in datasets.items():
            for k, v in self._validate(eval_step, instances).items():
                record[f"test/{name}/{k}"] = v
        self.history.append(record)
        self.logger(record)
        return record

    def _validate(self, eval_step, val_instances) -> dict:
        """Full-set evaluation: every instance counts, batch means weighted by
        batch size, the ragged tail included."""
        cfg = self.config
        n = next(iter(val_instances.values())).shape[0]
        sums: dict = {}
        for start in range(0, n, cfg.val_batch_size):
            stop = min(start + cfg.val_batch_size, n)
            m = eval_step({k: v[start:stop] for k, v in val_instances.items()})
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v) * (stop - start)
        return {k: v / n for k, v in sums.items()}


def _ckpt_tree(algo, epoch: int, best_monitor: float, host: dict) -> dict:
    """Composite checkpoint: the algorithm's state, the trainer's progress and
    the rollout baseline's incumbent rewards."""
    tree = {"state": algo.state_dict(), "epoch": epoch, "best_monitor": float(best_monitor)}
    if host.get("eval_rewards") is not None:
        tree["eval_rewards"] = torch.as_tensor(host["eval_rewards"])
    return tree


def _fetch(metrics: dict) -> dict:
    """Tensors to Python numbers; other values (an env's name) as they are."""
    return {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}


def _fmt(v):
    try:
        return round(float(v), 5)
    except (TypeError, ValueError):
        return v
