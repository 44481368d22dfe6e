"""Decap Placement Problem (DPP) and its multi-port variant (MDPP)
(counterpart of `rl4co_tpu/envs/eda/dpp.py`).

Place ``max_decaps`` decoupling capacitors on a ``size × size`` power
distribution grid, outside the probe and keep-out cells, to suppress the
impedance seen at the probing port(s). The reward is
``Σ_f (|Z_initial(f)| − |Z_final(f)|) · 1e9 / f / 10``, ``Z_final`` the
Schur complement ``z1aa − z1ap · inv(z1pp + z2) · z1pa`` of the placed
cells, over every frequency at once (`torch.linalg.inv`, batched).

The measured PDN files are a download: ``data_dir`` names a directory that
holds them (`load_pdn_data`, which raises `FileNotFoundError` without them,
as the JAX package does); ``data_dir=None`` takes the synthetic PDN, which
`synthetic_pdn` draws from numpy exactly as the JAX package does.

MDPP's state carries the probe *mask* ``[B, N]`` in ``probe`` where DPP's
carries the probe's index ``[B]`` (the JAX package's batched MDPP API does
the same).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from rl4co_tpu_torch.envs.base import Env, Instance
from rl4co_tpu_torch.envs.routing.op import freeze_done
from rl4co_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=4)
def synthetic_pdn(size: int, num_freq: int, seed: int = 0):
    """Synthetic PDN impedances ``[num_freq, size², size²]`` and their
    frequencies, numpy f32: a symmetric positive-definite mesh-like model
    whose coupling decays with grid distance and whose magnitude falls with
    frequency. The JAX package's draw, to the bit."""
    rng = np.random.default_rng(seed)
    n = size * size
    freqs = np.linspace(1e8, 2e10, num_freq).astype(np.float32)
    a = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    base = a @ a.T + 0.5 * np.eye(n, dtype=np.float32)
    xy = np.stack(np.meshgrid(np.arange(size), np.arange(size)), -1).reshape(-1, 2)
    dist = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
    base = base * np.exp(-dist / size)
    scale = (1e9 / freqs) ** 0.5
    pdn = (base[None] * scale[:, None, None] / 50.0).astype(np.float32)
    return pdn, freqs


@functools.lru_cache(maxsize=2)
def load_pdn_data(data_dir: str, chip_file: str = "10x10_pkg_chip.npy",
                  decap_file: str = "01nF_decap.npy", freq_file: str = "freq_201.npy"):
    """The measured PDN data from ``data_dir``: ``(raw_pdn [F, n, n]
    complex64, freqs [F] f32, decap [F, 1, 1] complex64)``, numpy. Raises
    `FileNotFoundError` for a missing file."""
    def load(fname):
        path = os.path.join(data_dir, fname)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"DPP data file {path!r} not found; download the reference "
                "dataset or use the synthetic PDN (data_dir=None).")
        return np.load(path)

    return (load(chip_file).astype(np.complex64), load(freq_file).astype(np.float32),
            load(decap_file).astype(np.complex64))


@functools.lru_cache(maxsize=8)
def _pdn_tensors(size: int, num_freq: int, seed: int, data_dir: Optional[str], device: str):
    """(pdn, freqs, decap or None) as tensors on ``device``, made once."""
    if data_dir is not None:
        pdn, freqs, decap = load_pdn_data(data_dir)
        if pdn.shape[-1] != size * size:
            raise ValueError(f"PDN data is {pdn.shape[-1]} nodes; env size² = {size * size}")
    else:
        (pdn, freqs), decap = synthetic_pdn(size, num_freq, seed), None
    to = lambda x: None if x is None else torch.from_numpy(np.asarray(x)).to(device)  # noqa: E731
    return to(pdn), to(freqs), to(decap)


def grid_locs(size: int, device) -> torch.Tensor:
    """Cell ``i * size + j`` at ``(j, i) / size``: `jnp.meshgrid`'s default
    ``xy`` layout."""
    r = torch.arange(size, device=device)
    x, y = torch.meshgrid(r, r, indexing="xy")
    return torch.stack([x, y], dim=-1).reshape(-1, 2).float() / size


def top_ranked(scores: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """bool ``[B, N]``: the ``count [B]`` highest ``scores`` of each row."""
    rank = torch.argsort(torch.argsort(-scores, dim=-1), dim=-1)
    return rank < count[:, None]


@dataclasses.dataclass
class DPPState:
    locs: torch.Tensor     # [B, N, 2] grid coordinates, normalised
    probe: torch.Tensor    # int64 [B] (DPP) or bool [B, N] probe mask (MDPP)
    keepout: torch.Tensor  # bool [B, N], the probe(s) included
    placed: torch.Tensor   # bool [B, N]
    i: torch.Tensor        # int64 [B]
    done: torch.Tensor     # bool [B]

    @property
    def current_node(self) -> torch.Tensor:
        return torch.zeros_like(self.i)


@dataclasses.dataclass(frozen=True)
class DPP(Env):
    name = "dpp"
    size: int = 10
    max_decaps: int = 20
    num_keepout_min: int = 1
    num_keepout_max: int = 50
    num_freq: int = 50
    pdn_seed: int = 0
    # directory of the measured PDN files; None -> the synthetic PDN
    data_dir: Optional[str] = None

    @property
    def n(self) -> int:
        return self.size * self.size

    def pdn(self, device):
        """``(pdn [F, n, n], freqs [F], decap [F, 1, 1] or None)`` on ``device``."""
        return _pdn_tensors(self.size, self.num_freq, self.pdn_seed, self.data_dir,
                            str(torch.device(device)))

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """A probe cell uniform over the grid and ``num_keepout`` (uniform in
        ``[num_keepout_min, num_keepout_max)``) keep-out cells drawn among
        the others, from ``generator``."""
        device = resolve_device(device)
        b = batch_size
        probe = torch.randint(0, self.n, (b,), generator=generator, device=device)
        num_keepout = torch.randint(self.num_keepout_min, self.num_keepout_max, (b,),
                                    generator=generator, device=device)
        scores = torch.rand((b, self.n), generator=generator, device=device)
        scores = scores.scatter(1, probe[:, None], -1.0)  # the probe is no keep-out
        return {"probe": probe, "keepout": top_ranked(scores, num_keepout)}

    def reset(self, instances: Instance) -> DPPState:
        keepout = instances["keepout"]
        probe = instances["probe"].long()
        b, dev = keepout.shape[0], keepout.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return DPPState(
            locs=grid_locs(self.size, dev).expand(b, -1, -1),
            probe=probe,
            keepout=keepout.scatter(1, probe[:, None], True),
            placed=torch.zeros_like(keepout),
            i=zeros,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: DPPState, action: torch.Tensor) -> DPPState:
        action = action.long()
        return freeze_done(dataclasses.replace(
            state,
            placed=state.placed.scatter(1, action[:, None], True),
            i=state.i + 1,
            done=state.i >= self.max_decaps - 1,
        ), state)

    def action_mask(self, state: DPPState) -> torch.Tensor:
        pad = torch.zeros_like(state.placed)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, ~(state.keepout | state.placed))

    def decap_impedance(self, placed: torch.Tensor):
        """Z after placing decaps at ``placed [B, K]``: ``(a_idx [B, n-K],
        the cells left, non-placed first in index order; zout [B, F, n-K,
        n-K])``, the Schur complement of the placed cells as the JAX
        package computes it."""
        pdn, freqs, decap = self.pdn(placed.device)
        b, k = placed.shape
        placed_mask = torch.zeros((b, self.n), dtype=torch.uint8, device=placed.device)
        placed_mask.scatter_(1, placed, 1)
        # non-placed first: a stable sort, as the JAX package's
        a_idx = torch.sort(placed_mask, dim=-1, stable=True).indices[:, : self.n - k]

        def block(rows, cols):  # pdn[:, rows, cols] per instance -> [B, F, r, c]
            return pdn[:, rows[:, :, None], cols[:, None, :]].permute(1, 0, 2, 3)

        if decap is not None:
            z2 = torch.eye(k, dtype=decap.dtype, device=decap.device)[None] * decap
        else:
            zc = 1.0 / (2 * math.pi * freqs * 1e-9)
            z2 = torch.eye(k, device=freqs.device)[None] * zc[:, None, None] / 50.0
        z1pp = block(placed, placed)
        inv = torch.linalg.inv(z1pp + z2.to(z1pp.dtype))
        zout = block(a_idx, a_idx) - block(a_idx, placed) @ inv @ block(placed, a_idx)
        return a_idx, zout

    def reward(self, state: DPPState, actions: torch.Tensor) -> torch.Tensor:
        placed = actions[:, : self.max_decaps].long()
        pdn, freqs, _ = self.pdn(placed.device)
        a_idx, zout = self.decap_impedance(placed)
        rows = torch.arange(placed.shape[0], device=placed.device)
        pos = (a_idx == state.probe[:, None]).long().argmax(dim=-1)  # the probe among a_idx
        z_final = zout[rows, :, pos, pos].abs()                         # [B, F]
        z_init = pdn[:, state.probe, state.probe].abs().t()             # [B, F]
        gap = (z_init - z_final) * 1e9 / freqs
        return gap.sum(dim=-1) / 10.0

    @property
    def num_actions(self) -> int:
        return self.n

    @property
    def max_steps(self) -> int:
        return self.max_decaps

    def _probe_cells(self, instance) -> np.ndarray:
        return np.asarray(instance["probe"]).reshape(-1, 1)

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        actions = np.asarray(actions)[..., : self.max_decaps].reshape(-1, self.max_decaps)
        keepout = np.asarray(instance["keepout"]).reshape(-1, self.n)
        probes = self._probe_cells(instance)
        for row, acts in enumerate(actions):
            if len(np.unique(acts)) != len(acts):
                raise AssertionError("Duplicate decap placement")
            if keepout[row][acts].any():
                raise AssertionError("Decap placed in keepout region")
            if np.isin(acts, probes[row]).any():
                raise AssertionError("Decap at probe")


@dataclasses.dataclass(frozen=True)
class MDPP(DPP):
    """Multi-port DPP: 2-5 probing ports; the reward is the worst port's
    (``minmax``) or the ports' mean (``meansum``)."""

    name = "mdpp"
    num_probes_min: int = 2
    num_probes_max: int = 5
    reward_type: str = "minmax"  # minmax | meansum

    def generate(self, batch_size: int,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        """``num_probes`` (uniform in ``[num_probes_min, num_probes_max]``)
        probe cells, then keep-out cells among the others, from
        ``generator``."""
        device = resolve_device(device)
        b = batch_size
        num_probes = torch.randint(self.num_probes_min, self.num_probes_max + 1, (b,),
                                   generator=generator, device=device)
        probe_mask = top_ranked(torch.rand((b, self.n), generator=generator, device=device),
                                num_probes)
        num_keepout = torch.randint(self.num_keepout_min, self.num_keepout_max, (b,),
                                    generator=generator, device=device)
        kscores = torch.rand((b, self.n), generator=generator, device=device)
        kscores = torch.where(probe_mask, -1.0, kscores)
        return {"probe_mask": probe_mask, "keepout": top_ranked(kscores, num_keepout)}

    def reset(self, instances: Instance) -> DPPState:
        keepout, probe_mask = instances["keepout"], instances["probe_mask"]
        b, dev = keepout.shape[0], keepout.device
        zeros = torch.zeros((b,), dtype=torch.long, device=dev)
        return DPPState(
            locs=grid_locs(self.size, dev).expand(b, -1, -1),
            probe=probe_mask,
            keepout=keepout | probe_mask,
            placed=torch.zeros_like(keepout),
            i=zeros,
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def reward(self, state: DPPState, actions: torch.Tensor) -> torch.Tensor:
        placed = actions[:, : self.max_decaps].long()
        pdn, freqs, _ = self.pdn(placed.device)
        a_idx, zout = self.decap_impedance(placed)
        z_final = zout.diagonal(dim1=-2, dim2=-1).abs()                    # [B, F, n-K]
        z_init = pdn.diagonal(dim1=1, dim2=2).abs()[:, a_idx].permute(1, 0, 2)
        gap = ((z_init - z_final) * (1e9 / freqs)[:, None]).sum(dim=1) / 10.0  # [B, n-K]
        # per remaining cell, back in the grid's index space; -inf elsewhere
        rewards = torch.full((placed.shape[0], self.n), -math.inf, device=placed.device)
        rewards = rewards.scatter(1, a_idx, gap)
        probe = state.probe
        if self.reward_type == "minmax":
            return torch.where(probe, rewards, math.inf).min(dim=-1).values
        return torch.where(probe, rewards, 0.0).sum(dim=-1) / probe.sum(dim=-1)

    def _probe_cells(self, instance) -> np.ndarray:
        mask = np.asarray(instance["probe_mask"]).reshape(-1, self.n)
        return [np.flatnonzero(m) for m in mask]
