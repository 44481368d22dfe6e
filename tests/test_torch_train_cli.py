"""The port's training command line against the JAX package's
(`rl4co_tpu/train.py`, `tests/test_train_cli.py`): the same model names,
every ported name built and trained for one epoch at the JAX smoke test's
sizes, every name and flag whose module is not ported refused with its
ROADMAP.md item, the JSONL log's records against the JAX command line's, a
resumed run, and the mixed OP + PCTSP configuration end to end."""

import json

import numpy as np
import pytest
import torch

from rl4co_tpu.train import MODEL_NAMES as JAX_MODEL_NAMES
from rl4co_tpu.train import main as jax_main
from rl4co_tpu_torch.train import MODEL_NAMES, UNPORTED_MODELS, WorkloadSpec, build, main
from test_train_cli import SMOKE_OVERRIDES

torch.set_num_threads(1)

PORTED = sorted(set(MODEL_NAMES) - set(UNPORTED_MODELS))
TINY = ["--num-loc", "6", "--batch-size", "4", "--train-size", "8", "--val-size", "4",
        "--epochs", "1", "--device", "cpu"]


def test_model_names_equal_the_jax_tuple():
    assert MODEL_NAMES == JAX_MODEL_NAMES
    assert PORTED == ["am", "am-multienv", "am-xl", "mvmoe", "mvmoe-pomo", "polynet", "pomo",
                      "ptrnet", "symnco"]


def tiny_spec(model, **kw):
    """`tests/test_train_cli.py::tiny_spec` in the port, on the CPU."""
    base = dict(env_name="tsp", env_kwargs=(("num_loc", 6),), model=model, epochs=1,
                batch_size=4, train_data_size=8, val_data_size=4, baseline="mean",
                precision="f32", device="cpu")
    base.update(kw)
    return WorkloadSpec(**base)


@pytest.mark.parametrize("model", [m for m in PORTED if m != "am-multienv"])
def test_build_and_train_one_epoch(model):
    spec = tiny_spec(model, **SMOKE_OVERRIDES[model])
    algo, trainer = build(spec, logger=lambda m: None)
    assert next(algo.policy.parameters()).device.type == "cpu"
    trainer.fit()
    val = trainer.history[-1].get("val/reward")
    assert val is not None and np.isfinite(float(val))


def test_build_seeds_the_policy():
    spec = tiny_spec("am", policy_kwargs=(("embed_dim", 16), ("num_encoder_layers", 1)))
    first, second = build(spec)[0].policy, build(spec)[0].policy
    assert all(torch.equal(p, q) for p, q in zip(first.parameters(), second.parameters()))


@pytest.mark.parametrize("model", sorted(UNPORTED_MODELS))
def test_unported_models_raise_with_their_roadmap_item(model):
    item = UNPORTED_MODELS[model]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, item {item}"):
        main(["--model", model, *TINY])
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, item {item}"):
        build(tiny_spec(model))


@pytest.mark.parametrize("flags,item", [
    (["--search", "eas-emb"], 13), (["--tensorboard", "tb"], 15), (["--mlflow", "ml"], 15),
    (["--dp", "2"], 15), (["--distributed"], 15)],
    ids=["search", "tensorboard", "mlflow", "dp", "distributed"])
def test_unported_flags_raise_with_their_roadmap_item(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, item {item}"):
        main(["--model", "am", *TINY, *flags])


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_log_file_writes_the_jax_record_keys(tmp_path, capsys):
    args = ["--model", "am", "--env", "tsp", "--num-loc", "6", "--batch-size", "4",
            "--train-size", "8", "--val-size", "4", "--epochs", "1", "--precision", "f32",
            "--baseline", "mean"]
    jax_main(args + ["--dp", "1", "--log-file", str(tmp_path / "jax.jsonl")])
    main(args + ["--device", "cpu", "--log-file", str(tmp_path / "port.jsonl")])
    want, got = read_jsonl(tmp_path / "jax.jsonl"), read_jsonl(tmp_path / "port.jsonl")
    # the same records with the same keys (the JAX trainer's metrics come back
    # from the device with their keys sorted; the order is no part of a record)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert all(isinstance(v, float) for r in got for v in r.values())
    # the print of every record on stdout, as the JAX command line prints it
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [sorted(r) for r in printed[-len(got):]] == [sorted(set(r) - {"t"}) for r in got]


def test_mixed_op_pctsp_trains_resumes_and_logs_the_env(tmp_path, capsys):
    """`--model am-multienv --env op,pctsp` at AM's widths (the JAX package's
    builds the policy at its defaults whatever else is asked): one epoch of 4
    steps in one dispatch (OP), then a second epoch resumed from `last.pt`,
    whose dispatch starts again at the first env."""
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log.jsonl")
    args = ["--model", "am-multienv", "--env", "op,pctsp", "--num-loc", "6", "--batch-size",
            "4", "--train-size", "16", "--val-size", "4", "--device", "cpu", "--ckpt-dir", ckpt,
            "--log-file", log, "--baseline", "rollout"]
    first = main(args + ["--epochs", "1"])
    assert first.step == 4 and first.policy.embed_dim == 128
    assert first.baselines["op"].name == "exponential"  # --baseline ignored
    second = main(args + ["--epochs", "2", "--resume-from", f"{ckpt}/last.pt"])
    assert second.step == 8
    for a, b in zip(first.policy.parameters(), second.policy.parameters()):
        assert a.shape == b.shape
    records = read_jsonl(log)
    assert [r["env"] for r in records if "env" in r] == ["op", "op"]
    assert [r["epoch"] for r in records if "val/reward" in r] == [0.0, 1.0]
    assert any("resumed_from" in r for r in records)
    capsys.readouterr()


def test_new_entry_points_refuse_to_run_without_a_card():
    """`tests/test_torch_imports.py::test_entry_points_refuse_to_run_without_a_card`
    for this slice's entry points: each defaults to the card and raises."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.policies.multi_env import MultiEnvAttentionPolicy
    from rl4co_tpu_torch.models.zoo.ptrnet import PointerNetwork
    from rl4co_tpu_torch.rl.multi_env import MultiEnvREINFORCE
    from rl4co_tpu_torch.tasks import eval_cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    envs = {n: get_env(n, num_loc=5) for n in ("op", "pctsp")}
    for make in (lambda: main(["--model", "am", "--num-loc", "5", "--epochs", "1"]),
                 lambda: eval_cli.main(["--num-loc", "5", "--size", "2"]),
                 lambda: MultiEnvAttentionPolicy(embed_dim=16, num_encoder_layers=1),
                 lambda: MultiEnvREINFORCE(envs),
                 lambda: PointerNetwork(embed_dim=8, hidden_dim=8),
                 lambda: envs["op"].generate(2), lambda: envs["pctsp"].generate(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
