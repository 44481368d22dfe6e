"""Scheduling: FJSP / JSSP with Learning-to-Dispatch (L2D).

The port's counterpart of `examples/09_scheduling.py`: L2D's HetGNN policy
trained on FJSP, the encode-once attention variant on JSSP, and the
standard-format instance file parser's round trip. L2D's pointer scores
run through the plain glimpse (no pointer kernel on this path).

Run: python3 rl4co_tpu_torch/examples/09_scheduling.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs.scheduling.fjsp import FJSP, JSSP  # noqa: E402
from rl4co_tpu_torch.envs.scheduling.parser import parse_fjsp_file, write_fjsp_file  # noqa: E402
from rl4co_tpu_torch.models.zoo.l2d import (  # noqa: E402
    L2DAttnModel,
    L2DAttnPolicy,
    L2DModel,
    L2DPolicy,
    l2d_attn_rollout,
)
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_jobs=4, num_mas=3, batch=4, steps=3, device="cuda"):
    device = resolve_device(device)
    out_numbers = {}
    # ---- FJSP with the HetGNN-based L2D policy ----
    env = FJSP(num_jobs=num_jobs, num_mas=num_mas, max_ops_per_job=3)
    torch.manual_seed(0)
    policy = L2DPolicy(embed_dim=32, num_encoder_layers=1, actor_hidden_dim=32, device=device)
    model = L2DModel(env=env, policy=policy)
    model.reseed(1)
    for _ in range(steps):
        m = model.train_step(batch)
    out_numbers["fjsp_loss"], out_numbers["fjsp_reward"] = float(m["loss"]), float(m["reward"])
    print(f"FJSP L2D: loss {out_numbers['fjsp_loss']:.4f} "
          f"reward (-makespan) {out_numbers['fjsp_reward']:.4f}")

    # ---- JSSP with the encode-once attention variant ----
    jenv = JSSP(num_jobs=num_jobs, num_mas=num_mas)
    torch.manual_seed(0)
    jpolicy = L2DAttnPolicy(embed_dim=32, num_heads=4, num_encoder_layers=1, device=device)
    jmodel = L2DAttnModel(env=jenv, policy=jpolicy)
    jmodel.reseed(1)
    jmodel.train_step(batch)
    instances = jenv.generate(batch, seeded_generator(device, 2), device)
    with torch.no_grad():
        out = l2d_attn_rollout(jpolicy, jenv, instances, DecodeSpec(kind="greedy"))
    out_numbers["jssp_greedy_makespan"] = -float(out.reward.mean())
    print(f"JSSP L2DAttn greedy makespan: {out_numbers['jssp_greedy_makespan']:.2f}")

    # ---- standard-format instance files (write -> parse round trip) ----
    inst = {k: v[0].cpu().numpy() for k, v in instances.items()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "instance.fjs")
        write_fjsp_file(path, inst)
        parsed = parse_fjsp_file(path)
    print(f"parser round-trip ok: {parsed['num_jobs']} jobs, {parsed['num_mas']} machines")
    out_numbers["parsed_jobs"], out_numbers["parsed_machines"] = (
        int(parsed["num_jobs"]), int(parsed["num_mas"]))
    return out_numbers


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
