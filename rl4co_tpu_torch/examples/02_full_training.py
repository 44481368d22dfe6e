"""Full training workflow: bf16-mixed, checkpointing, resume, named val sets.

The port's counterpart of `examples/02_full_training.py`: the rollout runs on
bf16-rounded parameters (f32 master weights), the trainer writes `best.pt`
and `last.pt`, a second trainer resumes from `last.pt` for a third epoch, and
a test phase runs over named datasets.

Run: python3 rl4co_tpu_torch/examples/02_full_training.py [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import REINFORCE, seeded_generator  # noqa: E402
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(num_loc=10, epochs=2, batch_size=64, train_data_size=1_024, val_size=128,
         device="cuda"):
    device = resolve_device(device)
    torch.manual_seed(0)
    env = get_env("tsp", num_loc=num_loc)
    policy = AttentionModelPolicy(env_name=env.name, device=device)
    # bf16 forward pass with f32 master parameters ("16-mixed")
    algo = REINFORCE(env=env, policy=policy, baseline="rollout",
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0,
                                           compute_dtype="bfloat16"),
                     lr=1e-4)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg = TrainerConfig(epochs=epochs, batch_size=batch_size, train_data_size=train_data_size,
                            val_data_size=val_size, val_batch_size=val_size,
                            ckpt_dir=ckpt_dir, monitor="reward")

        # named validation sets, evaluated every epoch (logged as val/<name>/...);
        # they share the env's num_loc and vary the instance distribution
        val_sets = {
            "uniform": env.generate(val_size, seeded_generator(device, 10), device),
            "clustered": get_env("tsp", num_loc=num_loc, loc_distribution="cluster").generate(
                val_size, seeded_generator(device, 11), device),
        }
        Trainer(algo, cfg).fit(val_datasets=val_sets)
        written = sorted(os.listdir(ckpt_dir))
        print("checkpoints written:", written)

        # resume: one more epoch, with the optimiser and baseline state of `last.pt`
        trainer2 = Trainer(algo, dataclasses.replace(cfg, epochs=epochs + 1))
        trainer2.fit(resume_from=os.path.join(ckpt_dir, "last.pt"), val_datasets=val_sets)

        # post-fit test phase over named datasets
        results = trainer2.test(datasets={
            "test_uniform": env.generate(val_size, seeded_generator(device, 12), device),
        })
    results = {k: float(v) for k, v in results.items()}
    print("test:", {k: round(v, 4) for k, v in results.items()})
    return {"checkpoints": written, **results}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
