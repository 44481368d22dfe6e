"""Reptile meta-learning over a task distribution of problem sizes.

The port's counterpart of `examples/11_meta_reptile.py`: each epoch samples
a task (a TSP size), trains AM with REINFORCE from the meta-weights for a
few steps (sampling rollouts through the single-query pointer kernel), then
moves the meta-weights: θ_meta ← θ_meta + β (θ_task − θ_meta).

Run: python3 rl4co_tpu_torch/examples/11_meta_reptile.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.meta import Reptile, ReptileConfig  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import REINFORCE  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(tasks=({"num_loc": 8}, {"num_loc": 10}, {"num_loc": 12}), epochs=3,
         steps_per_task=4, batch_size=32, device="cuda"):
    device = resolve_device(device)

    def make_algo(task: dict):
        env = get_env("tsp", **task)
        policy = AttentionModelPolicy(env_name="tsp", embed_dim=64, num_encoder_layers=2,
                                      device=device)
        return REINFORCE(env=env, policy=policy, baseline="exponential", lr=1e-4)

    cfg = ReptileConfig(meta_beta=0.9, beta_decay=True, tasks=tuple(tasks))
    torch.manual_seed(0)
    meta_params = Reptile(make_algo, cfg).run(epochs=epochs, steps_per_task=steps_per_task,
                                              batch_size=batch_size)
    n_params = sum(p.numel() for p in meta_params.values())
    assert all(torch.isfinite(p).all() for p in meta_params.values())
    print(f"meta-trained params: {n_params} weights across {len(cfg.tasks)} task sizes")
    return {"meta_params": n_params}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
