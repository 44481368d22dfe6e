"""Host local search: polish model tours with 2-opt / CVRP search.

The port's counterpart of `examples/07_local_search.py`. The searches are the
port's own C++ (`rl4co_tpu_torch/csrc/local_search.cpp`, built with g++ at
first use) and run on the host between device segments; the tours come from
greedy and sampling rollouts through the single-query pointer kernel.

Run: python3 rl4co_tpu_torch/examples/07_local_search.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.envs.routing.local_search import (  # noqa: E402
    cvrp_local_search,
    tsp_local_search,
)
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def tour_length(locs, tours):
    seq = np.take_along_axis(locs, tours[..., None].astype(np.int64), axis=-2)
    return np.linalg.norm(seq - np.roll(seq, -1, axis=-2), axis=-1).sum(-1)


def vrp_cost(locs_wd, actions):
    """Route cost with the start and end at the depot (row 0; the action
    sequences hold the depot visits as 0s)."""
    seq = np.take_along_axis(locs_wd, actions[..., None].astype(np.int64), axis=-2)
    first = np.linalg.norm(seq[:, 0] - locs_wd[:, 0], axis=-1)
    last = np.linalg.norm(seq[:, -1] - locs_wd[:, 0], axis=-1)
    mid = np.linalg.norm(seq[:, 1:] - seq[:, :-1], axis=-1).sum(-1)
    return first + mid + last


def main(num_loc=20, batch=32, device="cuda"):
    device = resolve_device(device)
    costs = {}
    # ---- TSP: greedy tours -> batched 2-opt ----
    env = get_env("tsp", num_loc=num_loc)
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name="tsp", device=device)
    test = env.generate(batch, seeded_generator(device, 1), device)
    with torch.no_grad():
        out = rollout(policy, env, test, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                      device=device)
    locs = test["locs"].cpu().numpy()
    tours = out.actions.cpu().numpy().astype(np.int32)
    improved = tsp_local_search(locs, tours, max_iterations=1000)
    costs["tsp_model"], costs["tsp_2opt"] = (float(tour_length(locs, t).mean())
                                             for t in (tours, improved))
    print(f"TSP-{num_loc}: model {costs['tsp_model']:.4f} -> 2-opt {costs['tsp_2opt']:.4f}")

    # ---- CVRP: sampled solutions -> host neighbourhood search ----
    venv = get_env("cvrp", num_loc=num_loc)
    torch.manual_seed(0)
    vpolicy = AttentionModelPolicy(env_name="cvrp", device=device)
    vtest = venv.generate(batch, seeded_generator(device, 3), device)
    with torch.no_grad():
        vout = rollout(vpolicy, venv, vtest, DecodeSpec(kind="sampling", tanh_clipping=10.0),
                       generator=seeded_generator(device, 4), device=device)
    locs_wd = np.concatenate([vtest["depot"].cpu().numpy()[:, None, :],
                              vtest["locs"].cpu().numpy()], axis=1)
    demand_wd = np.concatenate([np.zeros((batch, 1), np.float32),
                                vtest["demand"].cpu().numpy()], axis=1)
    acts = vout.actions.cpu().numpy().astype(np.int32)
    polished = cvrp_local_search(locs_wd, demand_wd, acts, capacity=1.0)
    venv.check_solution_validity({k: v.cpu().numpy() for k, v in vtest.items()}, polished)
    costs["cvrp_model"], costs["cvrp_ls"] = (float(vrp_cost(locs_wd, a).mean())
                                             for a in (acts, polished))
    print(f"CVRP-{num_loc}: model {costs['cvrp_model']:.4f} -> "
          f"host LS {costs['cvrp_ls']:.4f}")
    return costs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
