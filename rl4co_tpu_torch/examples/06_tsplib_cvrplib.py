"""Evaluate a policy on TSPLIB / CVRPLIB benchmark files.

The port's counterpart of `examples/06_tsplib_cvrplib.py`; the parsers are
in-tree (`rl4co_tpu_torch/data/tsplib.py`). Point --tsp-dir / --vrp-dir at
directories of real benchmark files; without them the script writes two
tiny instances so that it runs self-contained. Sampling 16 tours per
instance runs the grouped pointer kernel (the samples share the instance's
keys and values).

Run: python3 rl4co_tpu_torch/examples/06_tsplib_cvrplib.py [--device cpu]
"""

import argparse
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu_torch.data.tsplib import (  # noqa: E402
    read_cvrplib_solution,
    read_tsplib,
    read_tsplib_tour,
    tour_cost,
    tsplib_to_tsp_batch,
    vrplib_to_cvrp_batch,
)
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402

DEMO_TSP = """NAME: demo16\nTYPE: TSP\nDIMENSION: 16\nEDGE_WEIGHT_TYPE: EUC_2D\nNODE_COORD_SECTION\n""" + "\n".join(
    f"{i + 1} {100 * (i % 4)} {100 * (i // 4)}" for i in range(16)
) + "\nEOF\n"

DEMO_VRP = """NAME: demo-vrp\nTYPE: CVRP\nDIMENSION: 9\nEDGE_WEIGHT_TYPE: EUC_2D\nCAPACITY: 30\nNODE_COORD_SECTION\n""" + "\n".join(
    f"{i + 1} {50 * (i % 3)} {50 * (i // 3)}" for i in range(9)
) + "\nDEMAND_SECTION\n1 0\n" + "\n".join(
    f"{i + 1} {4 + i}" for i in range(1, 9)
) + "\nDEPOT_SECTION\n1\n-1\nEOF\n"


def _sampled(policy, env, batch, num_samples, device):
    with torch.no_grad():
        return rollout(policy, env, batch,
                       DecodeSpec(kind="sampling", num_samples=num_samples, select_best=True,
                                  tanh_clipping=10.0),
                       generator=seeded_generator(device, 1), device=device)


def eval_tsp_file(path, policy, device, num_samples=16):
    """The best of ``num_samples`` sampled tours, costed in TSPLIB's
    arithmetic; returns ``(tour, cost)``."""
    problem = read_tsplib(path)
    env, batch = tsplib_to_tsp_batch(problem, device=device)   # normalised to [0,1]^2
    out = _sampled(policy, env, batch, num_samples, device)
    tour = out.actions[0].cpu().numpy()[: problem["dimension"]]
    cost = tour_cost(problem, tour)
    line = f"{problem['name']:<14} N={problem['dimension']:<5} cost={cost:<10.0f}"
    opt_file = path.replace(".tsp", ".opt.tour")
    if os.path.exists(opt_file):
        bks = tour_cost(problem, read_tsplib_tour(opt_file))
        line += f" BKS={bks:<10.0f} gap={(cost - bks) / bks:.2%}"
    print(line)
    return tour, cost


def eval_vrp_file(path, policy, device, num_samples=16):
    """The best of ``num_samples`` sampled solutions, checked; returns
    ``(actions, normalised cost)``."""
    problem = read_tsplib(path)
    env, batch = vrplib_to_cvrp_batch(problem, device=device)
    out = _sampled(policy, env, batch, num_samples, device)
    actions = out.actions[0].cpu().numpy()
    env.check_solution_validity({k: v[0].cpu().numpy() for k, v in batch.items()}, actions)
    cost = -float(out.reward[0])
    line = f"{problem['name']:<14} N={problem['dimension']:<5} normalized cost={cost:.4f}"
    sol_file = path.replace(".vrp", ".sol")
    if os.path.exists(sol_file):
        line += f" BKS cost={read_cvrplib_solution(sol_file)['cost']}"
    print(line)
    return actions, cost


def main(tsp_dir=None, vrp_dir=None, num_samples=16, device="cuda"):
    device = resolve_device(device)
    tsp_files = sorted(glob.glob(os.path.join(tsp_dir, "*.tsp"))) if tsp_dir else []
    vrp_files = sorted(glob.glob(os.path.join(vrp_dir, "*.vrp"))) if vrp_dir else []
    results = {}
    with tempfile.TemporaryDirectory() as d:
        if not tsp_files and not vrp_files:
            tsp_files = [os.path.join(d, "demo16.tsp")]
            vrp_files = [os.path.join(d, "demo-vrp.vrp")]
            for path, text in ((tsp_files[0], DEMO_TSP), (vrp_files[0], DEMO_VRP)):
                with open(path, "w") as f:
                    f.write(text)
        torch.manual_seed(0)
        tsp_policy = AttentionModelPolicy(env_name="tsp", device=device)
        for p in tsp_files:
            results[os.path.basename(p)] = eval_tsp_file(p, tsp_policy, device, num_samples)
        torch.manual_seed(0)
        vrp_policy = AttentionModelPolicy(env_name="cvrp", device=device)
        for p in vrp_files:
            results[os.path.basename(p)] = eval_vrp_file(p, vrp_policy, device, num_samples)
    return {name: {"solution": np.asarray(sol).tolist(), "cost": cost}
            for name, (sol, cost) in results.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsp-dir", default=None)
    ap.add_argument("--vrp-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.tsp_dir, args.vrp_dir, device=args.device)
