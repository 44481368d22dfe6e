"""Canonical reference-convention datasets: generate, load, evaluate.

The port's counterpart of `examples/13_canonical_datasets.py`. The
reference pins its optimality-gap experiments to stored npz test sets (test
seed 1234 / validation seed 4321, 10 000 instances);
`generate_reference_convention` reproduces those numpy streams bit for bit,
so that a model trained here is scored on the same instances as one trained
on the reference. This example generates a small set, loads it through the
reference-format converter and evaluates an untrained policy on it greedily
(the single-query pointer kernel).

Run: python3 rl4co_tpu_torch/examples/13_canonical_datasets.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.data.generate import generate_reference_convention  # noqa: E402
from rl4co_tpu_torch.data.io import load_reference_npz, save_instances_npz  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.tasks.eval import evaluate_policy  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_loc=10, n=64, device="cuda"):
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        # 1. generate with the reference's exact numpy stream (the command line:
        #    python -m rl4co_tpu_torch.data.generate --problem tsp --num-loc 10
        #    --seed 1234 --convention reference)
        path = os.path.join(td, f"test{num_loc}_seed1234.npz")
        save_instances_npz(generate_reference_convention("tsp", num_loc, n, seed=1234), path)

        # 2. load through the reference-format converter (for CVRP it also
        #    divides integer demands by the capacity)
        instances = load_reference_npz(path, "tsp")
    print("loaded", {k: v.shape for k, v in instances.items()})

    # 3. evaluate any policy on the pinned instances
    env = get_env("tsp", num_loc=num_loc)
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name="tsp", embed_dim=32, num_encoder_layers=1,
                                  num_heads=4, feedforward_hidden=64, device=device)
    res = evaluate_policy(env, policy, instances, method="greedy", batch_size=n,
                          check_solutions=True, device=device)
    cost = -float(res["mean_reward"])
    print(f"greedy mean tour length (untrained): {cost:.3f} "
          f"on {len(res['rewards'])} canonical instances")
    return {"greedy_mean_cost": cost, "instances": len(res["rewards"])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
