"""Data-parallel training across processes, one rank per card.

The port's counterpart of `examples/12_multichip_dp.py`. Each rank is a
process joined to the others by `torch.distributed`
(`rl4co_tpu_torch/parallel/mesh.py`): every rank generates the global batch
from the same stream and keeps its rows, the parameters start from rank 0's
(`replicate`), batch norm, the baselines and the draws are global, and the
gradients are averaged before each optimiser step, so the ranks take the
one-process step. The sampling rollouts and the rollout baseline's greedy
ones run the single-query pointer kernel in every rank.

`main` is rank 0 and starts the other ranks as processes of this script:
one per card (NCCL), or two on the one card over gloo when there is one,
or two on the CPU with ``--device cpu``. On several hosts, start one
process per rank with ``python -m rl4co_tpu_torch.train --distributed``
instead.

Run: python3 rl4co_tpu_torch/examples/12_multichip_dp.py [--device cpu]
"""

import argparse
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.parallel.mesh import init_distributed, replicate  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import REINFORCE  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402

RANK_TIMEOUT_S = 600


def default_ranks(device) -> int:
    """One rank per card (two when there is one card), two on the CPU."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 2)
    return 2


def rank_device(device, ranks: int) -> str:
    """What each rank asks `init_distributed` for: a named card is shared by
    every rank (gloo); plain ``cuda`` gives rank r card r (NCCL)."""
    if torch.device(device).type == "cuda" and ranks > torch.cuda.device_count():
        return "cuda:0"
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def train(rank, ranks, port, device, num_loc, batch_per_rank, steps):
    """One rank's run: the mesh, the policy replicated from rank 0, ``steps``
    data-parallel REINFORCE steps on the global batch. Returns the metrics."""
    mesh, dev = init_distributed(rank_device(device, ranks), rank=rank, world=ranks,
                                 local_rank=rank, addr="localhost", port=port)
    try:
        if rank == 0:
            print(f"mesh: dp={mesh.world}, rank 0 on {dev}")
        torch.manual_seed(0)
        env = get_env("tsp", num_loc=num_loc)
        policy = replicate(AttentionModelPolicy(env_name="tsp", embed_dim=64,
                                                num_encoder_layers=2, device=dev), mesh)
        algo = REINFORCE(env=env, policy=policy, baseline="rollout",
                         train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
        history = []
        for it in range(steps):
            metrics = algo.train_step(batch_per_rank * mesh.world, mesh=mesh)
            history.append({k: float(metrics[k]) for k in ("loss", "reward")})
            if rank == 0:
                print(f"step {it}: loss {history[-1]['loss']:+.4f} "
                      f"reward {history[-1]['reward']:+.4f}")
        # the same Trainer(algo, cfg, mesh=mesh) runs whole epochs this way
        return history
    finally:
        dist.destroy_process_group()


def main(num_loc=10, batch_per_rank=16, steps=3, ranks=None, device="cuda"):
    resolve_device(device)
    ranks = ranks or default_ranks(device)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = ["--num-loc", str(num_loc), "--batch-per-rank", str(batch_per_rank),
            "--steps", str(steps), "--ranks", str(ranks), "--port", str(port),
            "--device", str(device)]
    others = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args,
                                "--rank", str(r)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(1, ranks)]
    try:
        history = train(0, ranks, port, device, num_loc, batch_per_rank, steps)
        for r, p in enumerate(others, start=1):
            out = p.communicate(timeout=RANK_TIMEOUT_S)[0]
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in others:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"ranks": ranks, "steps": history}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--num-loc", type=int, default=10)
    ap.add_argument("--batch-per-rank", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None)
    # set by rank 0 for the ranks it starts
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=None)
    a = ap.parse_args()
    if a.rank == 0:
        main(a.num_loc, a.batch_per_rank, a.steps, a.ranks, a.device)
    else:
        train(a.rank, a.ranks, a.port, a.device, a.num_loc, a.batch_per_rank, a.steps)
