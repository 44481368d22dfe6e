"""The 16-variant multi-task VRP (MTVRP) environment.

The port's counterpart of `examples/08_mtvrp.py`: one env covering every
combination of open routes, backhauls, duration limits and time windows,
mixed within a batch; greedy decoding (the single-query pointer kernel),
every solution checked against its own variant, then the env's classical
solve hook (its in-tree greedy construction; the pyvrp, LKH and OR-Tools
adapters when those packages are installed).

Run: python3 rl4co_tpu_torch/examples/08_mtvrp.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402

VARIANTS = ["cvrp", "ovrp", "vrpb", "vrpl", "vrptw", "ovrptw", "all"]


def main(num_loc=10, batch=16, device="cuda"):
    device = resolve_device(device)
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name="mtvrp", device=device)
    costs = {}
    for preset in VARIANTS:
        env = get_env("mtvrp", num_loc=num_loc, variant_preset=preset)
        test = env.generate(batch, seeded_generator(device, 1), device)
        with torch.no_grad():
            out = rollout(policy, env, test, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                          device=device)
        # every solution is checked against its own variant's flags
        env.check_solution_validity({k: v.cpu().numpy() for k, v in test.items()},
                                    out.actions.cpu().numpy())
        costs[preset] = -float(out.reward.mean())
        print(f"variant_preset={preset:<8} greedy mean cost {costs[preset]:8.4f}  "
              f"(all {batch} valid)")

    # classical baseline through the env's solve hook
    env = get_env("mtvrp", num_loc=num_loc, variant_preset="cvrp")
    test = env.generate(4, seeded_generator(device, 3), device)
    _, solve_costs = env.solve(test, max_runtime=1.0)
    costs["classical_solve"] = torch.as_tensor(solve_costs, dtype=torch.float64).mean().item()
    print(f"classical solve hook: mean cost {costs['classical_solve']:.4f}")
    return costs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
