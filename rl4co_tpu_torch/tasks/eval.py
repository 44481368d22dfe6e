"""Evaluation harness (counterpart of `rl4co_tpu/tasks/eval.py`).

Protocols over a fixed instance set:
    greedy | sampling | multistart_greedy | augment_dihedral_8 | augment |
    multistart_greedy_augment_dihedral_8 | multistart_greedy_augment |
    beam_search

(``augment``: 8 symmetric copies, rotations and reflections drawn from the
generator; ``beam_search``: width ``num_starts``, by default
``env.get_num_starts()``, best beam per instance.)

Each is one sweep (augment → rollout → group-max) batched over the dataset.

Dispatch sizing is the JAX package's: ``batch_size=None`` takes the
reference's ceiling of 8192 trajectories (``RL4CO_EVAL_BATCH_CEIL`` raises
it for multistart and augmented dispatches; never more than 8192
instances), capped by a rough estimate of the activations against a device
memory budget (`_hbm_instance_cap`; ``RL4CO_EVAL_HBM_BUDGET``, default 8e9
bytes). A sweep that runs out of device memory is redone whole at half the
dispatch size, at most 8 times (``oom_halvings`` in the result); any other
error raises.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from rl4co_tpu_torch.data.transforms import augment_instances
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs.base import Env
from rl4co_tpu_torch.models.policies.constructive import rollout
from rl4co_tpu_torch.utils.device import resolve_device
from rl4co_tpu_torch.utils.ops import unbatchify


@dataclasses.dataclass(frozen=True)
class EvalMethod:
    decode: str = "greedy"          # greedy | sampling | beam_search
    num_samples: int = 1
    multistart: bool = False
    num_augment: int = 1
    augment_fn: str = "dihedral8"
    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 0


EVAL_METHODS = {
    "greedy": EvalMethod(),
    "sampling": EvalMethod(decode="sampling", num_samples=1280),
    "multistart_greedy": EvalMethod(multistart=True),
    "augment_dihedral_8": EvalMethod(num_augment=8, augment_fn="dihedral8"),
    "augment": EvalMethod(num_augment=8, augment_fn="symmetric"),
    "multistart_greedy_augment_dihedral_8": EvalMethod(
        multistart=True, num_augment=8, augment_fn="dihedral8"
    ),
    "multistart_greedy_augment": EvalMethod(
        multistart=True, num_augment=8, augment_fn="symmetric"
    ),
    "beam_search": EvalMethod(decode="beam_search"),
}


def _best_of(r: torch.Tensor, acts: Optional[torch.Tensor], group: int):
    """Reduce a grouped axis by max reward, gathering the winning actions."""
    rg = unbatchify(r, group)                     # [B', group]
    best = torch.argmax(rg, dim=-1)
    r = torch.gather(rg, 1, best[:, None])[:, 0]
    if acts is not None:
        ag = unbatchify(acts, group)              # [B', group, T]
        idx = best[:, None, None].expand(-1, 1, ag.shape[-1])
        acts = torch.gather(ag, 1, idx)[:, 0]
    return r, acts


def evaluate_policy(
    env: Env,
    policy,
    instances: dict,
    method: str = "greedy",
    generator: Optional[torch.Generator] = None,
    batch_size: Optional[int] = None,
    num_starts: Optional[int] = None,
    tanh_clipping: float = 10.0,
    return_actions: bool = False,
    check_solutions: bool = False,
    warmup: bool = True,
    progress: Optional[Callable[[int, int], None]] = None,
    device="cuda",
    **method_overrides,
) -> dict:
    """Evaluate ``policy`` on ``instances`` (numpy arrays or tensors
    ``[n, ...]``); returns per-instance best rewards.

    ``batch_size=None`` dispatches ``min(ceiling // (starts·augments), 8192)``
    instances at a time (beams count as starts; the ceiling is 8192 or
    ``RL4CO_EVAL_BATCH_CEIL``), no more than `_hbm_instance_cap` allows for
    instances with ``locs [n, N, 2]``. With batch normalisation an
    instance's result depends on the instances that share its dispatch, so the
    dispatch size is part of the protocol. A ragged tail is padded up to the
    dispatch size with the first rows of the set. A sweep that runs out of
    device memory (`_is_device_oom`) is redone from the start, with the
    generator's state it began with, at half the dispatch size, up to 8
    times; the result then holds ``oom_halvings`` and the size that ran.

    ``generator``: source of the sampling draws, on ``device`` (default: a
    new one seeded with 1234). ``return_actions``: also return the per-instance best
    action sequences. ``check_solutions``: assert
    `env.check_solution_validity` on every batch's best actions (implies
    ``return_actions``). ``warmup``: run one discarded batch first, so that
    ``inference_time`` excludes one-off set-up (the kernels' build, the first
    launch of every operator); its wall time is reported as ``warmup_s``.
    ``progress``: ``callback(done, total)`` after every dispatch of the sweep
    (``done`` counts instances, the ragged tail's included), not after the
    warm-up.
    """
    device = resolve_device(device)
    m = EVAL_METHODS.get(method)
    if m is None:
        raise ValueError(f"Unknown eval method {method}. Available: {sorted(EVAL_METHODS)}")
    m = dataclasses.replace(m, **method_overrides)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(1234)

    beam = m.decode == "beam_search"
    s = ((num_starts or env.get_num_starts()) if (m.multistart or beam)
         else max(m.num_samples, 1))
    a = max(m.num_augment, 1)
    if batch_size is None:
        ceil = int(os.environ.get("RL4CO_EVAL_BATCH_CEIL", 8192))
        batch_size = max(1, min(ceil // max(1, s * a), 8192))
        n_nodes = _instance_num_nodes(instances)
        if n_nodes:
            batch_size = max(1, min(batch_size, _hbm_instance_cap(policy, n_nodes, s, a)))

    spec = DecodeSpec(
        kind="sampling" if (m.decode == "sampling" and not m.multistart) else m.decode,
        multistart=m.multistart,
        num_starts=s if m.multistart else 0,
        num_samples=m.num_samples if (m.num_samples > 1 and not m.multistart) else 0,
        temperature=m.temperature,
        top_p=m.top_p,
        top_k=m.top_k,
        tanh_clipping=tanh_clipping,
        beam_width=s if beam else 0,
        select_best=beam,  # beam search reduces the beam axis itself
    )
    repeats = s if (m.multistart or m.num_samples > 1) and not beam else 1
    return_actions = return_actions or check_solutions

    instances = {k: torch.as_tensor(v) for k, v in instances.items()}
    n = next(iter(instances.values())).shape[0]

    def run_batch(batch: dict):
        batch = {k: v.to(device) for k, v in batch.items()}
        if a > 1:
            batch = augment_instances(batch, a, m.augment_fn, generator=generator)
        with torch.no_grad():  # tours and rewards only: no graph
            out = rollout(policy, env, batch, spec, generator=generator, device=device)
        r, acts = out.reward, (out.actions if return_actions else None)
        # repeats first, then augments
        if repeats > 1:
            r, acts = _best_of(r, acts, repeats)      # [A*B]
        if a > 1:
            r, acts = _best_of(r, acts, a)            # [B]
        return r, acts

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def sweep(batch_size: int):
        """One pass over the set at a fixed dispatch size."""

        def pad_rows(x: torch.Tensor) -> torch.Tensor:
            """First ``batch_size`` rows, tiled up for tiny instance sets."""
            x = x[:batch_size]
            if x.shape[0] < batch_size:
                reps = -(-batch_size // x.shape[0])
                x = x.repeat(reps, *([1] * (x.ndim - 1)))[:batch_size]
            return x

        rewards, actions = [], []

        def consume(r, acts, batch, keep):
            rewards.append(r.cpu().numpy()[:keep])
            if return_actions:
                acts = acts.cpu().numpy()[:keep]
                actions.append(acts)
                if check_solutions:
                    for i in range(keep):
                        one = {k: v[i] for k, v in batch.items()}
                        env.check_solution_validity(one, acts[i])

        warmup_s = 0.0
        if warmup:
            t_warm = time.perf_counter()
            run_batch({k: pad_rows(v) for k, v in instances.items()})
            sync()
            warmup_s = time.perf_counter() - t_warm

        sync()
        t0 = time.perf_counter()
        for start in range(0, n - batch_size + 1, batch_size):
            batch = {k: v[start : start + batch_size] for k, v in instances.items()}
            r, acts = run_batch(batch)
            consume(r, acts, batch, batch_size)
            if progress is not None:
                progress(start + batch_size, n)
        # ragged tail: padded up to batch_size with the first rows of the set (the
        # padding rows enter the batch-norm statistics, so this is part of the
        # protocol, not a convenience)
        done_n = (n // batch_size) * batch_size
        if done_n < n:
            tail = n - done_n
            batch = {
                k: pad_rows(torch.cat([v[done_n:], v[: batch_size - tail]], dim=0))
                for k, v in instances.items()
            }
            r, acts = run_batch(batch)
            consume(r, acts, batch, tail)
            if progress is not None:
                progress(n, n)
        sync()
        return rewards, actions, time.perf_counter() - t0, warmup_s

    # out of device memory: the whole sweep again at half the dispatch size,
    # from the generator's state at the start
    start_state = generator.get_state()
    halvings = 0
    while True:
        try:
            rewards, actions, dt, warmup_s = sweep(batch_size)
            break
        except Exception as e:  # noqa: BLE001 — anything but an OOM raises
            if not _is_device_oom(e) or batch_size <= 1 or halvings >= 8:
                raise
        halvings += 1
        batch_size = max(1, batch_size // 2)
        logging.getLogger(__name__).warning(
            "eval batch out of device memory; retrying at batch_size=%d (halving %d)",
            batch_size, halvings)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        generator.set_state(start_state)

    rewards = np.concatenate(rewards)
    res = {
        "rewards": rewards,
        "mean_reward": float(rewards.mean()),
        "inference_time": dt,
        "instances_per_s": n / dt,
        "warmup_s": warmup_s,  # set-up + first dispatch, excluded from dt
        "method": method,
        "batch_size": batch_size,
    }
    if halvings:
        res["oom_halvings"] = halvings
    if return_actions:
        res["actions"] = np.concatenate(actions)
    return res


def _is_device_oom(e: BaseException) -> bool:
    """Whether ``e`` is the device running out of memory: PyTorch's
    `torch.OutOfMemoryError` or CUDA's "out of memory". A kernel's refused
    launch or a failed build is not."""
    return isinstance(e, torch.OutOfMemoryError) or (
        isinstance(e, RuntimeError) and "out of memory" in str(e))


def _instance_num_nodes(instances: dict) -> int:
    """Node count N from a ``[B, N, 2]``-shaped ``locs`` (0 if none)."""
    locs = instances.get("locs")
    if locs is not None and len(locs.shape) == 3:
        return int(locs.shape[1])
    return 0


def _hbm_instance_cap(policy, n: int, starts: int, augs: int,
                      budget_bytes: Optional[float] = None) -> int:
    """Instances per dispatch that keep the JAX package's rough activation
    estimate within the device memory budget (``RL4CO_EVAL_HBM_BUDGET``,
    default 8e9 bytes): per (augmented) instance the encoder's scores
    h·N² (two layers' live at once) and the decoder's cached K/V 3·N·d, at 2
    bytes, plus starts·N of per-trajectory state; about 2× conservative."""
    if budget_bytes is None:
        budget_bytes = float(os.environ.get("RL4CO_EVAL_HBM_BUDGET", 8e9))
    d = int(getattr(policy, "embed_dim", 128))
    h = int(getattr(policy, "num_heads", 8))
    layers = int(getattr(policy, "num_encoder_layers", 3))
    per_inst = 2.0 * (2 * min(layers, 2) * h * n * n + 8 * n * d) + starts * n * 16.0
    return max(1, int(budget_bytes / (augs * per_inst)))
