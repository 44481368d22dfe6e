"""Quickstart: train AttentionModel on TSP and evaluate greedily.

The port's counterpart of `examples/01_quickstart.py`: env -> policy ->
REINFORCE with the greedy rollout baseline -> Trainer -> greedy evaluation.
Every decode step of the rollouts runs the single-query pointer kernel.

Run: python3 rl4co_tpu_torch/examples/01_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import REINFORCE, seeded_generator  # noqa: E402
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_loc=10, epochs=2, batch_size=64, train_data_size=2_048, val_data_size=256,
         test_size=256, device="cuda"):
    device = resolve_device(device)
    torch.manual_seed(0)   # the policy's initial weights
    env = get_env("tsp", num_loc=num_loc)
    policy = AttentionModelPolicy(env_name=env.name, device=device)
    algo = REINFORCE(env=env, policy=policy, baseline="rollout", lr=1e-4)

    trainer = Trainer(algo, TrainerConfig(
        epochs=epochs, batch_size=batch_size, train_data_size=train_data_size,
        val_data_size=val_data_size, val_batch_size=256,
    ))
    trainer.fit()

    # greedy evaluation on fresh instances
    test = env.generate(test_size, seeded_generator(device, 4321), device)
    with torch.no_grad():
        out = rollout(policy, env, test, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                      device=device)
    cost = -float(out.reward.mean())
    print(f"greedy mean tour length on TSP-{num_loc}: {cost:.4f}")
    return {"greedy_mean_cost": cost}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
