"""RL utilities (counterpart of `rl4co_tpu/rl/utils.py`): a reward scaler
over Welford running statistics, updated a batch at a time."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RewardScalerState:
    """Welford running statistics (f32 scalars)."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor

    @classmethod
    def init(cls) -> "RewardScalerState":
        """0-dim f32 tensors, which combine with a batch on any device."""
        return cls(count=torch.tensor(1e-4), mean=torch.tensor(0.0), m2=torch.tensor(0.0))


def reward_scaler_update(state: RewardScalerState, x: torch.Tensor) -> RewardScalerState:
    """Batched Welford update with the batch ``x``; its variance is the
    population variance (`jnp.var`'s, ddof 0)."""
    batch_count = torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
    batch_mean = x.mean()
    batch_var = x.var(correction=0)
    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m2 = state.m2 + batch_var * batch_count + delta.square() * state.count * batch_count / tot
    return RewardScalerState(count=tot, mean=new_mean, m2=m2)


def reward_scaler_transform(state: RewardScalerState, x: torch.Tensor,
                            scale_type: str = "scale") -> torch.Tensor:
    """``scale``: divide by the running std; ``norm``: standardise."""
    std = torch.sqrt(state.m2 / state.count + 1e-8)
    if scale_type == "scale":
        return x / std
    if scale_type == "norm":
        return (x - state.mean) / std
    raise ValueError(scale_type)
