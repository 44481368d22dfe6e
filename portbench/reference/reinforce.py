"""Plain reference of REINFORCE with the greedy rollout baseline, Adam and
clipping by global norm (Kool et al. 2019, Algorithm 1, past its warm-up:
the baseline is a frozen copy of the starting weights), over a plain policy
module of this package (`rollout(weights, cfg, inst, mode=...)`,
`max_steps(cfg)`). Imports `torch` alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

BASELINE_RTOL = 1e-5    # two greedy tours alike in length to rounding


def train_steps(am, w0: dict, cfg: dict, batches: list, sampling: torch.Generator, lr: float,
                clip: float, follow: Optional[dict] = None, betas=(0.9, 0.999),
                eps: float = 1e-8, loss_rows: int = 0) -> dict:
    """``len(batches)`` steps of the policy module ``am`` from the weights ``w0``.

    Step k draws one uniform per instance of ``batches[k]`` and decode step
    from ``sampling``, in step order, and samples one tour per instance by
    them; the baseline is the greedy tour of ``w0``. The loss
    ``-mean((R - b) · log p)`` is taken over those tours and baseline values
    or, with ``follow`` (another run's ``actions [B, T]``, ``baseline [B]``
    and ``states`` per step, as this function returns them), over the tours
    and values given, each step from the weights and Adam moments that run
    held after the step before: then the reference follows that run step by
    step, and reports how far its own draws and its own baseline agree with
    it. The gradient is clipped to global norm ``clip``; Adam. ``loss_rows``
    > 0 takes the mean over the first rows alone (a planted fault).

    Returns per step ``loss`` and ``scale`` (the mean ``|(R - b) · log p|``),
    ``actions`` and ``baseline`` (its own draws and greedy rewards), the
    share of rows whose own draws (``sample_mismatch``) or own baseline
    (``baseline_mismatch``) differ from those followed, ``states`` (the
    weights and Adam's two moments after the step, by weight) and ``update``
    (the step's change of each weight); and the first step's clipped
    gradient (``grad``), by weight."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    base = {k: v.detach() for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    out = {k: [] for k in ("loss", "scale", "actions", "baseline", "sample_mismatch",
                           "baseline_mismatch", "states", "update")}
    out["grad"] = None
    for step, inst in enumerate(batches, start=1):
        if follow is not None and step > 1:
            held, m1, m2 = follow["states"][step - 2]
            params = {k: t.detach().clone().requires_grad_(True) for k, t in held.items()}
            m = {k: t.clone() for k, t in m1.items()}
            v2 = {k: t.clone() for k, t in m2.items()}
        before = {k: t.detach().clone() for k, t in params.items()}
        b = next(iter(inst.values())).shape[0]
        uniforms = [torch.rand(b, generator=sampling, device=sampling.device)
                    for _ in range(am.max_steps(cfg))]
        with torch.no_grad():
            own = am.rollout(params, cfg, inst, mode="sample", uniforms=uniforms)["actions"][:, 0]
            own_bl = -am.rollout(base, cfg, inst, mode="greedy")["cost"][:, 0]
        acts = own if follow is None else follow["actions"][step - 1]
        bl = own_bl if follow is None else follow["baseline"][step - 1]
        out["actions"].append(own)
        out["baseline"].append(own_bl)
        out["sample_mismatch"].append(float((own != acts).any(dim=-1).float().mean()))
        out["baseline_mismatch"].append(
            float(((own_bl - bl).abs() > BASELINE_RTOL * bl.abs()).float().mean()))
        roll = am.rollout(params, cfg, inst, mode="force", actions=acts[:, None, :])
        terms = (-roll["cost"][:, 0] - bl) * roll["ll"][:, 0]
        loss = -(terms[:loss_rows] if loss_rows else terms).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = clip / torch.clamp(norm, min=clip)
        grads = {k: g * scale for k, g in zip(params, grads)}
        if out["grad"] is None:
            out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            bc1, bc2 = 1 - betas[0] ** step, 1 - betas[1] ** step
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).add_(g * g, alpha=1 - betas[1])
                p.sub_(lr / bc1 * m[k] / (torch.sqrt(v2[k]) / math.sqrt(bc2) + eps))
        out["loss"].append(float(loss.detach()))
        out["scale"].append(float(terms.detach().abs().mean()))
        out["states"].append(({k: t.detach().clone() for k, t in params.items()},
                              {k: t.clone() for k, t in m.items()},
                              {k: t.clone() for k, t in v2.items()}))
        out["update"].append({k: params[k].detach() - before[k] for k in params})
    return out
