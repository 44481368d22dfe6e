"""Location samplers (counterpart of `rl4co_tpu/envs/distributions.py`).

Each sampler draws ``sample(shape, generator, device) -> points`` from an
explicit `torch.Generator` on an explicit device; the JAX package's draw from
a `jax.random` key, so the same seed gives other numbers, from the same
distribution. The leading axes of ``shape`` are instances: where a JAX
sampler is called once per instance (under `vmap`), a port sampler makes the
same choice per leading index (`MixDistribution`'s variant). The
deterministic part of each clustered sampler is a function of its draws
(`cluster_points`, `mixed_points`, `gaussian_mixture_points`), which the
tests hold to the JAX package's on the JAX draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from rl4co_tpu_torch.utils.device import resolve_device


def _uniform(shape, generator, device, low=0.0, high=1.0) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def _assign(lead, n, modes, generator, device) -> torch.Tensor:
    return torch.randint(0, modes, (*lead, n), generator=generator, device=device)


def cluster_points(centers: torch.Tensor, assign: torch.Tensor, noise: torch.Tensor,
                   std: float) -> torch.Tensor:
    """Each point its assigned centre (``centers [..., K, d]``, ``assign
    [..., n]``) plus ``std`` times its ``noise [..., n, d]``, clipped to
    [0, 1]."""
    base = torch.gather(centers, -2, assign[..., None].expand(*assign.shape, centers.shape[-1]))
    return (base + std * noise).clamp(0.0, 1.0)


def mixed_points(uniform_pts: torch.Tensor, cluster_pts: torch.Tensor,
                 take_cluster: torch.Tensor) -> torch.Tensor:
    """The clustered point where ``take_cluster [..., n, 1]``, else the uniform one."""
    return torch.where(take_cluster, cluster_pts, uniform_pts)


def gaussian_mixture_points(centers: torch.Tensor, assign: torch.Tensor,
                            noise: torch.Tensor) -> torch.Tensor:
    """Assigned centres plus unit noise, min-max normalised per instance and axis."""
    base = torch.gather(centers, -2, assign[..., None].expand(*assign.shape, centers.shape[-1]))
    pts = base + noise
    lo = pts.amin(dim=-2, keepdim=True)
    hi = pts.amax(dim=-2, keepdim=True)
    return (pts - lo) / (hi - lo + 1e-9)


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float = 0.0
    high: float = 1.0

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        return _uniform(shape, generator, resolve_device(device), self.low, self.high)


@dataclasses.dataclass(frozen=True)
class Normal:
    mean: float = 0.5
    std: float = 0.2

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        return self.mean + self.std * _normal(shape, generator, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Exponential:
    rate: float = 1.0

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        out = torch.empty(shape, device=resolve_device(device))
        return out.exponential_(generator=generator) / self.rate


@dataclasses.dataclass(frozen=True)
class Poisson:
    rate: float = 1.0

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        rates = torch.full(shape, float(self.rate), device=resolve_device(device))
        return torch.poisson(rates, generator=generator).float()


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Gaussian clusters (Bi et al. 2022): centres ~ U(0.2, 0.8), points ~
    N(centre, ``std``), clipped to [0, 1]."""

    n_cluster: int = 3
    std: float = 0.07

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        *lead, n, d = shape
        centers = _uniform((*lead, self.n_cluster, d), generator, device, 0.2, 0.8)
        noise = _normal((*lead, n, d), generator, device)
        assign = _assign(lead, n, self.n_cluster, generator, device)
        return cluster_points(centers, assign, noise, self.std)


@dataclasses.dataclass(frozen=True)
class Mixed:
    """Each point uniform or clustered with odds 1/2."""

    n_cluster_mix: int = 1
    std: float = 0.07

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        *lead, n, _ = shape
        uniform_pts = _uniform(shape, generator, device)
        cluster_pts = Cluster(self.n_cluster_mix, self.std).sample(shape, generator, device)
        take = torch.rand((*lead, n, 1), generator=generator, device=device) < 0.5
        return mixed_points(uniform_pts, cluster_pts, take)


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Zhou et al. 2023: ``num_modes`` centres ~ U(0, ``cdist``), points ~
    N(centre, 1), min-max normalised to [0, 1]; ``num_modes=0`` is uniform."""

    num_modes: int = 3
    cdist: float = 10.0

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        if self.num_modes == 0:
            return _uniform(shape, generator, device)
        *lead, n, d = shape
        centers = _uniform((*lead, self.num_modes, d), generator, device, 0.0, self.cdist)
        noise = _normal((*lead, n, d), generator, device)
        assign = _assign(lead, n, self.num_modes, generator, device)
        return gaussian_mixture_points(centers, assign, noise)


@dataclasses.dataclass(frozen=True)
class MixDistribution:
    """Uniform, `Cluster` or `Mixed`, one drawn per instance (per leading
    index of ``shape``, where the JAX sampler draws one per call)."""

    n_cluster: int = 3
    n_cluster_mix: int = 1

    def sample(self, shape, generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        lead = tuple(shape[:-2])
        variant = torch.randint(0, 3, lead, generator=generator, device=device)
        options = torch.stack([Uniform().sample(shape, generator, device),
                               Cluster(self.n_cluster).sample(shape, generator, device),
                               Mixed(self.n_cluster_mix).sample(shape, generator, device)])
        pick = variant.reshape(1, *lead, 1, 1).expand(1, *shape)
        return torch.gather(options, 0, pick)[0]


SAMPLERS = {
    "uniform": Uniform,
    "normal": Normal,
    "gaussian": Normal,
    "exponential": Exponential,
    "poisson": Poisson,
    "cluster": Cluster,
    "mixed": Mixed,
    "gaussian_mixture": GaussianMixture,
    "mix_distribution": MixDistribution,
}


def get_sampler(distribution: str | float | Callable = "uniform", **kwargs):
    """A sampler by name; a number is the constant `Uniform(d, d)`; a
    callable is returned as it is."""
    if isinstance(distribution, (int, float)):
        return Uniform(low=float(distribution), high=float(distribution))
    if callable(distribution) and not isinstance(distribution, str):
        return distribution
    cls = SAMPLERS.get(distribution)
    if cls is None:
        raise ValueError(
            f"Invalid distribution {distribution}. Available: {sorted(SAMPLERS)}"
        )
    return cls(**kwargs)
