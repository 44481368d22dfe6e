"""Decoding strategies side by side on one policy.

The port's counterpart of `examples/04_decoding_strategies.py`: greedy,
sampling, top-k, top-p, temperature, multistart, beam search, then the
evaluation harness. Greedy decoding runs the single-query pointer kernel;
sampling with repeats, multistart and beam search run the grouped one (the
repeats, starts or beams of an instance share its keys and values).

Run: python3 rl4co_tpu_torch/examples/04_decoding_strategies.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.models.policies.beam_search import beam_search_rollout  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.tasks.eval import evaluate_policy  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_loc=10, batch=64, device="cuda"):
    device = resolve_device(device)
    torch.manual_seed(0)
    env = get_env("tsp", num_loc=num_loc)
    policy = AttentionModelPolicy(env_name="tsp", device=device)
    test = env.generate(batch, seeded_generator(device, 1), device)
    costs = {}

    # --- low level: a DecodeSpec drives the rollout directly ---
    specs = {
        "greedy": DecodeSpec(kind="greedy", tanh_clipping=10.0),
        "sampling(x8)": DecodeSpec(kind="sampling", num_samples=8,
                                   select_best=True, tanh_clipping=10.0),
        "top-k=5": DecodeSpec(kind="sampling", top_k=5, num_samples=8,
                              select_best=True, tanh_clipping=10.0),
        "top-p=0.9": DecodeSpec(kind="sampling", top_p=0.9, num_samples=8,
                                select_best=True, tanh_clipping=10.0),
        "temp=0.5": DecodeSpec(kind="sampling", temperature=0.5,
                               num_samples=8, select_best=True,
                               tanh_clipping=10.0),
        "multistart_greedy": DecodeSpec(kind="greedy", multistart=True,
                                        num_starts=num_loc,
                                        tanh_clipping=10.0),
    }
    with torch.no_grad():
        for name, spec in specs.items():
            out = rollout(policy, env, test, spec, generator=seeded_generator(device, 2),
                          device=device)
            costs[name] = -float(out.reward.mean())
            print(f"{name:<20} mean cost {costs[name]:8.4f}")

        # beam search keeps `beam_width` partial tours with parent backtracking
        beam = beam_search_rollout(policy, env, test, 4,
                                   spec=DecodeSpec(kind="greedy", tanh_clipping=10.0))
    costs["beam_search(4)"] = -float(beam.reward.mean())
    print(f"{'beam_search(4)':<20} mean cost {costs['beam_search(4)']:8.4f}")

    # --- high level: the evaluation harness ---
    for method in ("greedy", "augment_dihedral_8", "beam_search"):
        # the test set is one dispatch (by default a dispatch holds up to 8 192)
        res = evaluate_policy(env, policy, test, method=method, batch_size=batch,
                              check_solutions=True, device=device)
        costs[f"eval[{method}]"] = -float(res["mean_reward"])
        print(f"eval[{method:<20}] mean cost {costs[f'eval[{method}]']:8.4f}")
    return costs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
