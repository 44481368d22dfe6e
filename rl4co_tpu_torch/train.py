"""Training entry point and workload specs (counterpart of `rl4co_tpu/train.py`).

A `WorkloadSpec` describes one training run; `build(spec)` gives the
algorithm and its `Trainer`. As a command line, with the JAX package's flags
and model names, plus ``--device``:

    python -m rl4co_tpu_torch.train --model am-multienv --env op,pctsp \
        --num-loc 20 --batch-size 512 --epochs 1 --device cuda

The default ``--device`` is ``cuda`` (raising without a card); ``--device cpu``
runs on the CPU. Models whose modules are not ported yet, and the flags of
back ends not ported yet (``--search``, ``--tensorboard``, ``--mlflow``,
``--dp`` above 1, ``--distributed``), raise `NotImplementedError` naming
their ROADMAP.md item. ``--ckpt-dir`` writes the port's ``best.pt`` and
``last.pt``; ``--resume-from`` takes one of those files.

Behaviours of the JAX package kept as they are: ``am-multienv`` and
``ptrnet`` ignore ``--baseline`` (the first takes an exponential baseline per
env, the second its own moving average); ``am-multienv`` builds its policy at
AM's published widths whatever else is asked; a multi-env run validates on its
first env only; PtrNet computes in f32 under ``bf16-mixed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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

# the names whose modules are not ported yet -> their ROADMAP.md item
UNPORTED_MODELS = {
    "ppo": 11, "a2c": 11,
    "deepaco": 12, "gfacs": 12,
    "dact": 13, "n2s": 13, "neuopt": 13,
    "mdam": 14, "ham": 14, "matnet": 14, "l2d": 14, "l2d-attn": 14, "l2d-ppo": 14,
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to rl4co_tpu_torch yet "
                               f"(ROADMAP.md, item {item})")


def build(spec: WorkloadSpec, logger=None):
    """(algorithm, trainer) of ``spec``. The policy's weights are drawn after
    ``torch.manual_seed(spec.seed)``, so the same spec builds the same
    untrained policy."""
    if spec.model in UNPORTED_MODELS:
        raise not_ported(f"model {spec.model!r}", UNPORTED_MODELS[spec.model])
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
    )
    return algo, Trainer(algo, cfg, logger=logger)


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
    if name in ("mvmoe", "mvmoe-pomo"):
        from rl4co_tpu_torch.models.zoo.mvmoe import MVMoE_AM, MVMoE_POMO

        ctor = MVMoE_POMO if name == "mvmoe-pomo" else MVMoE_AM
        return ctor(env, policy_kwargs=pkw, train_spec=train_spec, lr=lr)
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
                   help="post-train transductive search on the test set (not ported)")
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
                   help="also write TensorBoard event files to LOGDIR (not ported)")
    p.add_argument("--mlflow", default=None, metavar="MLRUNS_DIR",
                   help="also write an MLflow file-store run (not ported)")
    p.add_argument("--ckpt-dir", default=None,
                   help="save best.pt (val/reward max) and last.pt here")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint file written by a previous run (…/last.pt or …/best.pt)")
    p.add_argument("--precision", default="bf16-mixed", choices=["bf16-mixed", "f32"])
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel size (0 or 1: one device; above 1 is not ported)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host training (not ported)")
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)

    for flag, value, item in (("--search", args.search, 13),
                              ("--tensorboard", args.tensorboard, 15),
                              ("--mlflow", args.mlflow, 15),
                              ("--dp above 1", args.dp > 1, 15),
                              ("--distributed", args.distributed, 15)):
        if value:
            raise not_ported(flag, item)

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
        device=args.device,
    )
    logger = None
    if args.log_file:
        from rl4co_tpu_torch.loggers import JSONLLogger, MultiLogger

        logger = MultiLogger(lambda m: print(json.dumps({k: str(v) for k, v in m.items()})),
                             JSONLLogger(args.log_file))
    print(f"Workload: {spec}")
    _, trainer = build(spec, logger=logger)
    return trainer.fit(resume_from=args.resume_from)


if __name__ == "__main__":
    main()
