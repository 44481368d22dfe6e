"""Training entry point and workload specs (counterpart of `rl4co_tpu/train.py`).

A `WorkloadSpec` describes one training run; `build(spec)` gives the
algorithm and its `Trainer`. As a command line, with the JAX package's flags
and model names, plus ``--device``:

    python -m rl4co_tpu_torch.train --model am-multienv --env op,pctsp \
        --num-loc 20 --batch-size 512 --epochs 1 --device cuda

The default ``--device`` is ``cuda`` (raising without a card); ``--device cpu``
runs on the CPU. ``--log-file``, ``--tensorboard`` and ``--mlflow`` write the
metrics as JSONL, TensorBoard event files and an MLflow file store;
``--profile-dir`` traces ``--profile-steps`` train steps with
`torch.profiler`. Data parallelism (`rl4co_tpu_torch.parallel.mesh`):
``--distributed`` joins the processes that the caller started (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
``--dp N`` above 1 starts N-1 more processes of this command itself and runs
rank 0 here, over N local cards (raising with fewer, or with a card index in
``--device``) or, with ``--device cpu``, N processes on the CPU; ``--dp 0``
takes every local card when there are more than one. The default is one
process, where the JAX command line's is ``--dp 0``: of the port's
algorithms only REINFORCE's (AM, POMO and the models built on them, but
MDAM, SymNCO and PolyNet) train data-parallel, and the others raise under a
mesh. ``--batch-size`` is the global batch; rank 0 logs and writes the
checkpoints. ``--search`` runs Active Search, EAS-Emb or EAS-Lay with the trained
policy on ``--search-size`` generated instances after training and prints
the JAX command line's JSON line ``{"search": ..., "best_reward": ...}``.
``dact``, ``n2s`` and ``neuopt`` ignore ``--env`` and train on their own
improvement MDPs with n-step PPO, as in the JAX package. ``--ckpt-dir`` writes the port's ``best.pt`` and
``last.pt``; ``--resume-from`` takes one of those files.

Behaviours of the JAX package kept as they are: ``am-multienv`` and
``ptrnet`` ignore ``--baseline`` (the first takes an exponential baseline per
env, the second its own moving average); ``am-multienv`` builds its policy at
AM's published widths whatever else is asked; a multi-env run validates on its
first env only; PtrNet computes in f32 under ``bf16-mixed``; ``deepaco`` and
``gfacs`` ignore ``--baseline``, ``--precision`` (they train in f32) and the
policy's arguments, and build their published defaults; ``mdam`` ignores
``--baseline`` (its per-path means are built in) and trains in f32;
``ham`` turns any env but PDP, mPDP and MDCPDP into PDP, ``matnet`` any env
but ATSP into ATSP (both with ``--num-loc``); ``l2d``, ``l2d-attn`` and
``l2d-ppo`` turn a routing env into FJSP (JSSP for ``l2d-attn``) at the env's
defaults, and ignore ``--baseline`` and ``--precision``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
from typing import Optional

import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One training workload."""

    env_name: str = "tsp"          # a comma list for am-multienv
    env_kwargs: tuple = ()         # (key, value) pairs
    model: str = "am"              # a name of MODEL_NAMES
    policy_kwargs: tuple = ()
    lr: float = 1e-4
    baseline: str = "rollout"
    epochs: int = 100
    batch_size: int = 512
    train_data_size: int = 1_280_000
    val_data_size: int = 10_000
    seed: int = 1234
    tanh_clipping: float = 10.0
    # bf16 forward on f32 masters (the reference's precision="16-mixed")
    precision: str = "bf16-mixed"     # bf16-mixed | f32
    ckpt_dir: Optional[str] = None
    device: str = "cuda"

    def env(self):
        return get_env(self.env_name, **dict(self.env_kwargs))


# Every model name of the JAX package's CLI, in its order.
MODEL_NAMES = (
    "am", "am-xl", "pomo", "symnco", "ppo", "a2c", "polynet", "deepaco",
    "gfacs", "mdam", "ptrnet", "ham", "matnet", "mvmoe", "mvmoe-pomo",
    "l2d", "l2d-attn", "l2d-ppo", "dact", "n2s", "neuopt", "am-multienv",
)


def build(spec: WorkloadSpec, mesh=None, logger=None, profile_dir: Optional[str] = None,
          profile_steps: int = 5):
    """(algorithm, trainer) of ``spec``. The policy's weights are drawn after
    ``torch.manual_seed(spec.seed)``, so the same spec builds the same
    untrained policy; with a ``mesh`` every rank builds it alike."""
    if spec.model not in MODEL_NAMES:
        raise ValueError(f"Unknown model {spec.model}. Available: {MODEL_NAMES}")
    # am-multienv takes a comma env list and builds its own env dict
    env = spec.env() if "," not in spec.env_name else None
    compute_dtype = "bfloat16" if spec.precision == "bf16-mixed" else None
    train_spec = DecodeSpec(kind="sampling", tanh_clipping=spec.tanh_clipping,
                            compute_dtype=compute_dtype)
    torch.manual_seed(spec.seed)
    algo = _build_model(spec, env, dict(spec.policy_kwargs), train_spec)
    cfg = TrainerConfig(
        epochs=spec.epochs,
        batch_size=spec.batch_size,
        train_data_size=spec.train_data_size,
        val_data_size=spec.val_data_size,
        seed=spec.seed,
        ckpt_dir=spec.ckpt_dir,
        profile_dir=profile_dir,
        profile_steps=profile_steps,
    )
    return algo, Trainer(algo, cfg, mesh=mesh, logger=logger)


def _build_model(spec: WorkloadSpec, env, pkw: dict, train_spec: DecodeSpec):
    name, lr, device = spec.model, spec.lr, spec.device
    pkw = {**pkw, "device": device}

    if name in ("am", "am-xl"):
        from rl4co_tpu_torch.models import AttentionModelPolicy
        from rl4co_tpu_torch.rl.reinforce import REINFORCE

        if name == "am-xl":  # 6 encoder layers, instance norm
            pkw = {"num_encoder_layers": 6, "normalization": "instance", **pkw}
        return REINFORCE(env=env, policy=AttentionModelPolicy(env_name=env.name, **pkw),
                         baseline=spec.baseline, train_spec=train_spec, lr=lr)
    if name in ("ppo", "a2c"):
        from rl4co_tpu_torch.models import AttentionModelPolicy

        if name == "ppo":
            from rl4co_tpu_torch.rl.ppo import PPO as algo_cls
        else:
            from rl4co_tpu_torch.rl.a2c import A2C as algo_cls
        return algo_cls(env=env, policy=AttentionModelPolicy(env_name=env.name, **pkw),
                        train_spec=train_spec, lr=lr)
    if name == "pomo":
        from rl4co_tpu_torch.models.zoo.pomo import POMO, make_pomo_policy

        return POMO(env, policy=make_pomo_policy(env.name, **pkw), train_spec=train_spec, lr=lr)
    if name == "symnco":
        from rl4co_tpu_torch.models.zoo.symnco import SymNCO, SymNCOPolicy

        return SymNCO(env, policy=SymNCOPolicy(env_name=env.name, **pkw),
                      train_spec=train_spec, lr=lr)
    if name == "polynet":
        from rl4co_tpu_torch.models.zoo.polynet import PolyNet, PolyNetPolicy

        return PolyNet(env, policy=PolyNetPolicy(env_name=env.name, **pkw),
                       train_spec=train_spec, lr=lr)
    if name == "ptrnet":
        from rl4co_tpu_torch.models.zoo.ptrnet import PointerNetwork, PointerNetworkModel

        return PointerNetworkModel(env, policy=PointerNetwork(**pkw), train_spec=train_spec,
                                   lr=lr)
    if name == "deepaco":  # the JAX CLI passes neither the policy's arguments nor a spec
        from rl4co_tpu_torch.models.zoo.deepaco import DeepACO

        return DeepACO(env, lr=lr, device=device)
    if name == "gfacs":
        from rl4co_tpu_torch.models.zoo.gfacs import GFACS

        return GFACS(env, lr=lr, device=device)
    if name in ("mvmoe", "mvmoe-pomo"):
        from rl4co_tpu_torch.models.zoo.mvmoe import MVMoE_AM, MVMoE_POMO

        ctor = MVMoE_POMO if name == "mvmoe-pomo" else MVMoE_AM
        return ctor(env, policy_kwargs=pkw, train_spec=train_spec, lr=lr)
    if name == "mdam":  # MDAM sets its own baseline whatever --baseline says
        from rl4co_tpu_torch.models.zoo.mdam import MDAM, MDAMPolicy

        return MDAM(env, MDAMPolicy(env_name=env.name, **pkw), baseline=spec.baseline,
                    train_spec=train_spec, lr=lr)
    if name == "ham":  # a PDP method: any other env becomes PDP
        from rl4co_tpu_torch.models.zoo.ham import HeterogeneousAttentionModel

        if env.name not in ("pdp", "mpdp", "mdcpdp"):
            env = get_env("pdp", **dict(spec.env_kwargs))
        return HeterogeneousAttentionModel(env, policy_kwargs=pkw, train_spec=train_spec,
                                           lr=lr)
    if name == "matnet":  # an ATSP method
        from rl4co_tpu_torch.models.zoo.matnet import MatNet

        if env.name != "atsp":
            env = get_env("atsp", **dict(spec.env_kwargs))
        return MatNet(env, policy_kwargs=pkw, train_spec=train_spec, lr=lr)
    if name in ("l2d", "l2d-attn", "l2d-ppo"):
        from rl4co_tpu_torch.models.zoo.l2d import (L2DAttnModel, L2DAttnPolicy, L2DModel,
                                                    L2DPolicy)

        if env.name not in ("fjsp", "jssp"):  # the env's defaults, as the JAX CLI
            env = get_env("jssp" if name == "l2d-attn" else "fjsp")
        if name == "l2d":
            return L2DModel(env, L2DPolicy(**pkw), lr=lr)
        if name == "l2d-attn":
            return L2DAttnModel(env, L2DAttnPolicy(**pkw), lr=lr)
        from rl4co_tpu_torch.rl.stepwise_ppo import StepwisePPO

        return StepwisePPO(env, L2DPolicy(**{"with_critic": True, **pkw}), lr=lr)
    if name in ("dact", "n2s", "neuopt"):
        # the improvement trio on their own MDPs (they ignore --env), n-step PPO
        from rl4co_tpu_torch.models.zoo.dact import DACT
        from rl4co_tpu_torch.models.zoo.n2s import N2S
        from rl4co_tpu_torch.models.zoo.neuopt import NeuOpt

        ctor = {"dact": DACT, "n2s": N2S, "neuopt": NeuOpt}[name]
        return ctor(lr_policy=lr, policy_kwargs=pkw)
    # am-multienv: one shared-trunk policy over the comma list of envs
    from rl4co_tpu_torch.rl.multi_env import MultiEnvREINFORCE

    envs = {n: get_env(n, **dict(spec.env_kwargs)) for n in spec.env_name.split(",")}
    return MultiEnvREINFORCE(envs=envs, train_spec=train_spec, lr=lr, device=device)


def main(argv: Optional[list] = None):
    """The command line; returns the trained algorithm."""
    p = argparse.ArgumentParser(description="rl4co-tpu training (PyTorch port)")
    p.add_argument("--env", default="tsp")
    p.add_argument("--model", default="am", choices=MODEL_NAMES)
    p.add_argument("--search", default=None,
                   choices=["active_search", "eas-emb", "eas-lay"],
                   help="post-train transductive search on the test set")
    p.add_argument("--search-size", type=int, default=64)
    p.add_argument("--search-iters", type=int, default=0,
                   help="override search max_iters (0 = method default)")
    p.add_argument("--num-loc", type=int, default=20)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--train-size", type=int, default=100_000)
    p.add_argument("--val-size", type=int, default=1_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--baseline", default="rollout")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--log-file", default=None, help="JSONL metrics file")
    p.add_argument("--tensorboard", default=None, metavar="LOGDIR",
                   help="also write TensorBoard event files to LOGDIR")
    p.add_argument("--mlflow", default=None, metavar="MLRUNS_DIR",
                   help="also write an MLflow file-store run (mlruns layout)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace of --profile-steps train steps of the first "
                        "epoch, after its first")
    p.add_argument("--profile-steps", type=int, default=5)
    p.add_argument("--ckpt-dir", default=None,
                   help="save best.pt (val/reward max) and last.pt here")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint file written by a previous run (…/last.pt or …/best.pt)")
    p.add_argument("--precision", default="bf16-mixed", choices=["bf16-mixed", "f32"])
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks on this machine (0 = all local cards when >1)")
    p.add_argument("--distributed", action="store_true",
                   help="join the processes the caller started (RANK, WORLD_SIZE, "
                        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:<i> or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    dp = args.dp
    if dp == 0 and not args.distributed and torch.device(args.device).type == "cuda":
        dp = torch.cuda.device_count()
    if dp > 1 and torch.device(args.device).index is not None:
        raise ValueError(f"--dp {dp} puts its ranks on cards 0..{dp - 1}: give --device cuda, "
                         f"not {args.device}")
    children, mesh, device = [], None, args.device
    if args.distributed or dp > 1:
        from rl4co_tpu_torch.parallel.mesh import init_distributed

        if args.distributed:
            mesh, dev = init_distributed(args.device)
        else:
            children, port = _start_local_ranks(argv, dp, args.device)
            mesh, dev = init_distributed(args.device, rank=0, world=dp, local_rank=0,
                                         addr="localhost", port=port)
        device = str(dev)
        print(f"Data-parallel mesh: dp={mesh.world}, rank {mesh.rank} on {device}")
    try:
        algo = _train(args, mesh, device)
    except BaseException:
        for child in children:
            child.kill()
        raise
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    for child in children:
        if child.wait() != 0:
            raise RuntimeError(f"data-parallel rank process {child.args} exited with "
                               f"{child.returncode}")
    return algo


def _start_local_ranks(argv: list, dp: int, device: str):
    """Ranks 1..dp-1 of ``--dp dp``: this command again with ``--distributed``
    in place of ``--dp``, one process per rank; returns them and the port of
    rank 0's rendezvous."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < dp:
        raise ValueError(f"--dp {dp} needs {dp} cards; {torch.cuda.device_count()} visible")
    rest, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--dp":
            skip = True
        elif not a.startswith("--dp="):
            rest.append(a)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "WORLD_SIZE": str(dp), "LOCAL_WORLD_SIZE": str(dp),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    children = [subprocess.Popen(
        [sys.executable, "-m", "rl4co_tpu_torch.train", *rest, "--distributed"],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}) for r in range(1, dp)]
    return children, port


def _train(args, mesh, device: str):
    spec = WorkloadSpec(
        env_name=args.env,
        env_kwargs=(("num_loc", args.num_loc),),
        model=args.model,
        lr=args.lr,
        baseline=args.baseline,
        epochs=args.epochs,
        batch_size=args.batch_size,
        train_data_size=args.train_size,
        val_data_size=args.val_size,
        seed=args.seed,
        precision=args.precision,
        ckpt_dir=args.ckpt_dir,
        device=device,
    )
    logger = None
    if (args.log_file or args.tensorboard or args.mlflow) and (mesh is None or mesh.rank == 0):
        from rl4co_tpu_torch.loggers import (JSONLLogger, MLflowFileLogger, MultiLogger,
                                             TensorBoardLogger)

        parts = [lambda m: print(json.dumps({k: str(v) for k, v in m.items()}))]
        if args.log_file:
            parts.append(JSONLLogger(args.log_file))
        if args.tensorboard:
            parts.append(TensorBoardLogger(args.tensorboard))
        if args.mlflow:
            parts.append(MLflowFileLogger(root=args.mlflow, run_name=f"{args.model}-{args.env}"))
        logger = MultiLogger(*parts)
    print(f"Workload: {spec}")
    algo, trainer = build(spec, mesh=mesh, logger=logger, profile_dir=args.profile_dir,
                          profile_steps=args.profile_steps)
    algo = trainer.fit(resume_from=args.resume_from)
    if args.search:
        result = run_search(args.search, algo, args.search_size, spec.seed + 1,
                            args.search_iters)
        print(json.dumps({"search": args.search,
                          "best_reward": float(result["best_reward"].mean())}))
    return algo


SEARCHES = ("active_search", "eas-emb", "eas-lay")


def run_search(search: str, algo, size: int, seed: int, iters: int = 0) -> dict:
    """The transductive search ``search`` with the trained policy on ``size``
    instances generated from ``seed`` (the JAX command line's
    ``PRNGKey(seed + 1)``; the port's own stream), ``iters`` iterations (0:
    the method's default)."""
    from rl4co_tpu_torch.models.zoo.eas import ActiveSearch, EASEmb, EASLay
    from rl4co_tpu_torch.rl.reinforce import seeded_generator

    if search not in SEARCHES:
        raise ValueError(f"Unknown search {search!r}")
    cls = {"active_search": ActiveSearch, "eas-emb": EASEmb, "eas-lay": EASLay}[search]
    kwargs = {"max_iters": iters} if iters else {}
    generator = seeded_generator(algo.device, seed)
    instances = algo.env.generate(size, generator, algo.device)
    return cls(algo.env, algo.policy, **kwargs).search(instances, generator)


if __name__ == "__main__":
    main()
