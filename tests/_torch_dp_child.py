"""One rank of the port's two-process data-parallel run on the CPU (gloo), for
tests/test_torch_dp.py. Imports no JAX. Usage:

    python tests/_torch_dp_child.py <rank> <world> <port> <out_dir>

Writes ``<out_dir>/rank<r>.npz``: for each configuration of `CONFIGS` the
metrics of its train steps and the parameters after them, and the global
batch norm's output rows, input gradient rows and parameter gradients on
this rank's rows of `norm_inputs()`.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GLOBAL_BATCH, STEPS = 16, 2
# (normalization, baseline): AM at embed 16, one layer, TSP-8
CONFIGS = (("batch", "rollout"), ("batch", "mean"), ("instance", "rollout"),
           ("instance", "mean"))
METRICS = ("loss", "reward", "bl_val", "entropy")


def norm_inputs():
    """A global batch-norm input [4, 5, 3], its cotangent and the affine
    parameters, from a numpy seed."""
    rs = np.random.RandomState(7)
    return (rs.randn(4, 5, 3).astype(np.float32), rs.randn(4, 5, 3).astype(np.float32),
            rs.randn(3).astype(np.float32), rs.randn(3).astype(np.float32))


def train_config(norm: str, baseline: str, mesh=None) -> dict:
    """``STEPS`` REINFORCE steps at the global batch, the epoch end between
    them (the rollout baseline's warm-up ends and its t-test runs); with
    ``mesh`` on this rank's rows. Returns the metrics and parameters."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models import AttentionModelPolicy
    from rl4co_tpu_torch.parallel.mesh import replicate
    from rl4co_tpu_torch.rl.reinforce import REINFORCE, seeded_generator

    cpu = torch.device("cpu")
    env = get_env("tsp", num_loc=8)
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name="tsp", embed_dim=16, num_encoder_layers=1,
                                  feedforward_hidden=32, num_heads=2, normalization=norm,
                                  device="cpu")
    algo = REINFORCE(env, policy, baseline=baseline,
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    if mesh is not None:
        replicate(algo.policy, mesh)
    held_out = env.generate(32, seeded_generator(cpu, 9), cpu)
    host = {"eval_instances": held_out,
            "eval_rewards": algo.greedy_reward_fn()(algo.policy, held_out).numpy()}
    out = {}
    for step in range(STEPS):
        algo.reseed(42, step)
        kwargs = {} if mesh is None else {"mesh": mesh}
        metrics = algo.train_step(GLOBAL_BATCH, **kwargs)
        for k in METRICS:
            out[f"step{step}/{k}"] = metrics[k].item()
        host = algo.epoch_end(host)
    for name, p in algo.policy.named_parameters():
        out[f"param/{name}"] = p.detach().numpy().copy()
    return out


def global_batch_norm(mesh) -> dict:
    """Normalization("batch") on this rank's rows inside a sharded step:
    the output, the input's gradient and the affine parameters' gradients
    of ``sum(y * cotangent)``."""
    from rl4co_tpu_torch.models.nn.ops import Normalization
    from rl4co_tpu_torch.parallel.mesh import sharded

    x, ct, scale, bias = norm_inputs()
    b = x.shape[0] // mesh.world
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    norm = Normalization(3, "batch")
    with torch.no_grad():
        norm.scale.copy_(torch.tensor(scale))
        norm.bias.copy_(torch.tensor(bias))
    xt = torch.tensor(x[rows], requires_grad=True)
    with sharded(mesh, b):
        y = norm(xt)
        (y * torch.tensor(ct[rows])).sum().backward()
    return {"norm/y": y.detach().numpy(), "norm/dx": xt.grad.numpy(),
            "norm/dscale": norm.scale.grad.numpy(), "norm/dbias": norm.bias.grad.numpy()}


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4])
    torch.set_num_threads(1)
    from rl4co_tpu_torch.parallel.mesh import init_distributed

    mesh, _ = init_distributed("cpu", rank=rank, world=world, local_rank=rank,
                               addr="localhost", port=port)
    try:
        out = global_batch_norm(mesh)
        for norm, baseline in CONFIGS:
            out.update({f"{norm}-{baseline}/{k}": v
                        for k, v in train_config(norm, baseline, mesh).items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
