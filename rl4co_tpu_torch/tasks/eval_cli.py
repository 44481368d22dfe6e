"""Evaluation command line (counterpart of `rl4co_tpu/tasks/eval_cli.py`):

    python -m rl4co_tpu_torch.tasks.eval_cli --problem tsp --num-loc 50 \
        --method greedy --ckpt-path rl4co_tpu_torch/golden/am_tsp50_params.npz \
        --data-path data/tsp/test50_seed1234.npz --batch-size 8192

An Attention Model policy of ``--embed-dim`` and ``--num-encoder-layers``
(else AM's published widths) on ``--problem``, its weights from
``--ckpt-path`` by suffix: ``.pt``, a checkpoint of the port's trainer
(``best.pt`` / ``last.pt``), or ``.npz``, a params tree written by
`rl4co_tpu_torch.convert.save_params_npz`. Orbax directories of the JAX
package are not read (the npz export is their way in). Without
``--ckpt-path`` the weights are drawn after ``torch.manual_seed(0)``.
``--data-path`` is an npz of instances (`load_instances_npz`), else
``--size`` instances are generated from ``--seed``. It prints the result of
`evaluate_policy` without the per-instance rewards, as one JSON line.
``--device`` is ``cuda`` by default; ``cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from rl4co_tpu_torch.checkpoint import restore_checkpoint
from rl4co_tpu_torch.convert import load_params, load_params_npz
from rl4co_tpu_torch.data.io import load_instances_npz
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.rl.reinforce import seeded_generator
from rl4co_tpu_torch.tasks.eval import EVAL_METHODS, evaluate_policy
from rl4co_tpu_torch.utils.device import resolve_device


def load_policy_weights(policy: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill ``policy`` from a trainer checkpoint (``.pt``) or a params tree
    (``.npz``)."""
    if path.endswith(".npz"):
        return load_params(policy, load_params_npz(path))
    if path.endswith(".pt"):
        device = next(policy.parameters()).device
        policy.load_state_dict(restore_checkpoint(path, map_location=device)["state"]["policy"])
        return policy
    raise ValueError(f"--ckpt-path {path!r}: expected a .pt checkpoint or a params .npz")


def main(argv=None):
    """The command line; returns `evaluate_policy`'s result."""
    p = argparse.ArgumentParser(description="rl4co-tpu evaluation (PyTorch port)")
    p.add_argument("--problem", default="tsp")
    p.add_argument("--num-loc", type=int, default=50)
    p.add_argument("--method", default="greedy", choices=sorted(EVAL_METHODS))
    p.add_argument("--size", type=int, default=1000, help="instances to evaluate")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--data-path", default=None, help="npz dataset (else generated)")
    p.add_argument("--ckpt-path", default=None,
                   help="the port's .pt checkpoint or a params .npz")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--num-encoder-layers", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    env = get_env(args.problem, num_loc=args.num_loc)
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name=env.name, embed_dim=args.embed_dim,
                                  num_encoder_layers=args.num_encoder_layers, device=device)
    if args.ckpt_path:
        load_policy_weights(policy, args.ckpt_path)
    policy.eval()

    if args.data_path:
        instances = load_instances_npz(args.data_path)
    else:
        instances = env.generate(args.size, seeded_generator(device, args.seed), device)

    res = evaluate_policy(
        env, policy, instances, method=args.method, batch_size=args.batch_size,
        generator=torch.Generator(device=device).manual_seed(args.seed), device=device,
    )
    print(json.dumps({k: v for k, v in res.items() if k != "rewards"}))
    return res


if __name__ == "__main__":
    main()
