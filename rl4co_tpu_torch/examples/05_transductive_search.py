"""Transductive (test-time) search: ActiveSearch, EAS-Emb, EAS-Lay.

The port's counterpart of `examples/05_transductive_search.py`. Each search
iteration is a multistart sampling rollout under autograd (the grouped
pointer kernel at every step); EAS also replays the incumbent tours (the
single-query kernel).

Run: python3 rl4co_tpu_torch/examples/05_transductive_search.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.models.zoo.eas import ActiveSearch, EASEmb, EASLay  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_loc=10, n_instances=4, max_iters=10, device="cuda"):
    device = resolve_device(device)
    torch.manual_seed(0)
    env = get_env("tsp", num_loc=num_loc)
    policy = AttentionModelPolicy(env_name="tsp", device=device)
    instances = env.generate(n_instances, seeded_generator(device, 1), device)

    with torch.no_grad():
        base = rollout(policy, env, instances, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                       device=device)
    costs = {"zero_shot_greedy": -float(base.reward.mean())}
    print(f"zero-shot greedy cost: {costs['zero_shot_greedy']:.4f}")

    searches = {
        # every parameter fine-tuned on the instance batch (Active Search)
        "active_search": ActiveSearch(env=env, policy=policy, max_iters=max_iters, lr=1e-3),
        # only the per-instance node embeddings are adapted (EAS-Emb)
        "eas_emb": EASEmb(env=env, policy=policy, max_iters=max_iters, augment_size=1),
        # a small added layer is adapted (EAS-Lay)
        "eas_lay": EASLay(env=env, policy=policy, max_iters=max_iters, hidden_dim=16),
    }
    for name, search in searches.items():
        res = search.search(instances, generator=seeded_generator(device, 3))
        costs[name] = -float(res["best_reward"].mean())
        print(f"{name:<14} best cost after search: {costs[name]:.4f}")
    return costs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
