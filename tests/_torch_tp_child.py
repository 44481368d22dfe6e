"""One rank of the port's tensor- and expert-parallel runs on the CPU (gloo),
for tests/test_torch_tp.py. Imports no JAX. Usage:

    python tests/_torch_tp_child.py <rank> <world> <port> <port2> <out_dir>

With ``world`` 4 the ranks form a ``(dp 2, model 2)`` mesh and write
``<out_dir>/tp22_rank<r>.npz``: for each configuration of `CONFIGS_22` the
metrics of its train steps, the tours of its train rollouts and the whole
parameters after them (`full_state_dict`); the replayed loss and whole
gradients of `replay_inputs` (`JAX_REPLAY`); a checkpoint of the first
configuration (``<out_dir>/tp_ckpt.pt``, written by rank 0) restored into a
fresh split algorithm, and one more step of both. Ranks 0 and 1 then join a
second group of two (on ``port2``) as a ``(dp 1, model 2)`` mesh and write
``tp12_rank<r>.npz`` for `CONFIGS_12`.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GLOBAL_BATCH, STEPS, N, MIN_DIM = 16, 2, 8, 8
SMALL = dict(embed_dim=16, num_heads=2, num_encoder_layers=1, feedforward_hidden=32)
METRICS = ("loss", "reward", "bl_val", "entropy")
# AM (batch norm) under the rollout baseline behind its warm-up and under the
# mean baseline; POMO (K1's grouped decode); MVMoE's four experts, two per rank
CONFIGS_22 = ("am-rollout", "am-mean", "pomo", "mvmoe")
CONFIGS_12 = ("am-rollout", "am-mean")


def make_algo(name: str):
    """The configuration's algorithm on the CPU, weights from torch seed 0."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models import AttentionModelPolicy
    from rl4co_tpu_torch.models.zoo.mvmoe import MVMoEPolicy
    from rl4co_tpu_torch.models.zoo.pomo import POMO, make_pomo_policy
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    env = get_env("tsp", num_loc=N)
    spec = DecodeSpec(kind="sampling", tanh_clipping=10.0)
    torch.manual_seed(0)
    if name == "pomo":
        return POMO(env, make_pomo_policy("tsp", device="cpu", **SMALL), train_spec=spec)
    if name == "mvmoe":
        policy = MVMoEPolicy(env_name="tsp", normalization="instance", num_experts=4,
                             moe_topk=2, device="cpu", **SMALL)
        return REINFORCE(env, policy, baseline="mean", train_spec=spec)
    policy = AttentionModelPolicy(env_name="tsp", device="cpu", **SMALL)
    return REINFORCE(env, policy, baseline=name.split("-")[1], train_spec=spec)


def split(algo, mesh) -> None:
    from rl4co_tpu_torch.parallel.mesh import shard_params_model_axis

    shard_params_model_axis(algo.policy, mesh, min_dim=MIN_DIM)


def whole_params(policy) -> dict:
    from rl4co_tpu_torch.parallel.mesh import full_state_dict

    names = {n for n, _ in policy.named_parameters()}
    return {k: v.numpy().copy() for k, v in full_state_dict(policy).items() if k in names}


def train_config(name: str, mesh=None) -> dict:
    """``STEPS`` train steps at the global batch, the epoch end between them
    (the rollout baseline's warm-up ends and its t-test runs); with ``mesh``
    the policy split over its model axis first. Returns the metrics, each
    step's tours (this rank's rows) and the whole parameters after them;
    without ``mesh``, each step's gradients too."""
    from rl4co_tpu_torch.rl.reinforce import seeded_generator

    algo = make_algo(name)
    if mesh is not None:
        split(algo, mesh)
    out, host = {}, {}
    if name == "am-rollout":
        held_out = algo.env.generate(32, seeded_generator(torch.device("cpu"), 9), "cpu")
        host = {"eval_instances": held_out,
                "eval_rewards": algo.greedy_reward_fn()(algo.policy, held_out).numpy()}
    tours = []
    inner = algo.train_rollout

    def train_rollout(*args, **kwargs):
        o = inner(*args, **kwargs)
        tours.append(o.actions.numpy().copy())
        return o

    algo.train_rollout = train_rollout
    for step in range(STEPS):
        algo.reseed(42, step)
        metrics = algo.train_step(GLOBAL_BATCH, **({} if mesh is None else {"mesh": mesh}))
        for k in METRICS:
            out[f"step{step}/{k}"] = metrics[k].item()
        out[f"tours{step}"] = tours[-1]
        if mesh is None:   # the one-process gradients (which of them carry a signal)
            out.update({f"grad{step}/{k}": (p.grad if p.grad is not None else
                                            torch.zeros_like(p)).numpy().copy()
                        for k, p in algo.policy.named_parameters()})
        host = algo.epoch_end(host)
    out.update({f"param/{k}": v for k, v in whole_params(algo.policy).items()})
    return out


def replay_inputs():
    """TSP-8 instances and feasible tours (random permutations) to replay."""
    rs = np.random.RandomState(5)
    locs = rs.random_sample((GLOBAL_BATCH, N, 2)).astype(np.float32)
    actions = np.stack([rs.permutation(N) for _ in range(GLOBAL_BATCH)]).astype(np.int64)
    return locs, actions


def replay_policy():
    """AM at `SMALL`'s widths on `convert.random_params_numpy`'s seed-0 tree."""
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.models import AttentionModelPolicy

    tree = random_params_numpy(0, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"])
    return load_params(AttentionModelPolicy(env_name="tsp", device="cpu", **SMALL), tree)


def replayed_loss(mesh) -> dict:
    """The mean-baseline REINFORCE loss of this rank's rows of
    `replay_inputs` (its tours replayed), the global metrics, and every
    parameter's gradient after the dp average, whole."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.parallel.mesh import gather_share, global_means, sharded, tp_parameters
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    algo = REINFORCE(get_env("tsp", num_loc=N), replay_policy(), baseline="mean",
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    split(algo, mesh)
    locs, actions = replay_inputs()
    b = mesh.local_batch(GLOBAL_BATCH)
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    with sharded(mesh, b):
        loss, (metrics, _) = algo.loss({"locs": torch.from_numpy(locs[rows])},
                                       replay_actions=torch.from_numpy(actions[rows]))
        loss.backward()
        mesh.average_gradients(algo.policy)
        metrics = global_means(metrics)
    specs = {name: sm for name, _, sm in tp_parameters(algo.policy)}
    out = {f"replay/{k}": v.item() for k, v in metrics.items()}
    for name, p in algo.policy.named_parameters():
        g = p.grad if name not in specs else gather_share(p.grad, *specs[name])
        out[f"replay/grad/{name}"] = g.numpy().copy()
    return out


def checkpoint_round_trip(mesh, out_dir) -> dict:
    """AM under the rollout baseline, one step, then its `state_dict` (whole)
    written by rank 0; a fresh split algorithm restores it; one more step of
    both from the same stream. Returns the whole parameters saved, restored,
    and after the further step of each."""
    from rl4co_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    path = os.path.join(out_dir, "tp_ckpt.pt")
    algo = make_algo("am-rollout")
    split(algo, mesh)
    algo.reseed(42, 0)
    algo.train_step(GLOBAL_BATCH, mesh=mesh)
    state = algo.state_dict()
    if mesh.process_rank == 0:
        save_checkpoint(path, {"state": state})
    torch.distributed.barrier()
    again = make_algo("am-rollout")
    split(again, mesh)
    again.load_state_dict(restore_checkpoint(path, "cpu")["state"])
    out = {f"ckpt/restored/{k}": v for k, v in whole_params(again.policy).items()}
    for tag, a in (("live", algo), ("resumed", again)):
        a.reseed(42, 1)
        a.train_step(GLOBAL_BATCH, mesh=mesh)
        out.update({f"ckpt/{tag}/{k}": v for k, v in whole_params(a.policy).items()})
    return out


def run(configs, mesh, out_dir, tag, extra=()):
    out = {}
    for name in configs:
        out.update({f"{name}/{k}": v for k, v in train_config(name, mesh).items()})
    for fn in extra:
        out.update(fn())
    np.savez(os.path.join(out_dir, f"{tag}_rank{mesh.process_rank}.npz"), **out)


def main():
    rank, world, port, port2, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    torch.set_num_threads(1)
    from rl4co_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed("cpu", rank=rank, world=world, local_rank=rank, addr="localhost",
                     port=port)
    try:
        mesh = make_mesh(dp=2, model=2)
        run(CONFIGS_22, mesh, out_dir, "tp22",
            (lambda: replayed_loss(mesh), lambda: checkpoint_round_trip(mesh, out_dir)))
    finally:
        torch.distributed.destroy_process_group()
    if rank < 2:
        init_distributed("cpu", rank=rank, world=2, local_rank=rank, addr="localhost",
                         port=port2)
        try:
            run(CONFIGS_12, make_mesh(dp=1, model=2), out_dir, "tp12")
        finally:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
