"""The port's training command line against the JAX package's
(`rl4co_tpu/train.py`, `tests/test_train_cli.py`): the same model names,
every name built and trained for one epoch at the JAX smoke test's sizes,
``--tensorboard``, ``--mlflow`` and ``--profile-dir`` writing their files
beside the JAX command line's (the data-parallel flags are in
`test_torch_dp.py`), the JSONL log's records against the JAX command line's,
a resumed run, and the mixed OP + PCTSP configuration end to end."""

import json

import numpy as np
import pytest
import torch

from rl4co_tpu.train import MODEL_NAMES as JAX_MODEL_NAMES
from rl4co_tpu.train import main as jax_main
from rl4co_tpu_torch.train import MODEL_NAMES, WorkloadSpec, build, main
from test_train_cli import SMOKE_OVERRIDES

torch.set_num_threads(1)

PORTED = sorted(MODEL_NAMES)
TINY = ["--num-loc", "6", "--batch-size", "4", "--train-size", "8", "--val-size", "4",
        "--epochs", "1", "--device", "cpu"]


def test_model_names_equal_the_jax_tuple():
    assert MODEL_NAMES == JAX_MODEL_NAMES
    assert PORTED == ["a2c", "am", "am-multienv", "am-xl", "dact", "deepaco", "gfacs", "ham",
                      "l2d", "l2d-attn", "l2d-ppo", "matnet", "mdam", "mvmoe", "mvmoe-pomo",
                      "n2s", "neuopt", "polynet", "pomo", "ppo", "ptrnet", "symnco"]


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
    if model in ("dact", "n2s", "neuopt"):   # the JAX smoke test's short horizons
        algo.n_step, algo.T_train, algo.T_test, algo.ppo_epochs = 2, 2, 4, 1
    trainer.fit()
    val = trainer.history[-1].get("val/reward")
    assert val is not None and np.isfinite(float(val))


def test_build_seeds_the_policy():
    spec = tiny_spec("am", policy_kwargs=(("embed_dim", 16), ("num_encoder_layers", 1)))
    first, second = build(spec)[0].policy, build(spec)[0].policy
    assert all(torch.equal(p, q) for p, q in zip(first.parameters(), second.parameters()))


def test_back_end_flags_write_their_files(tmp_path):
    """``--tensorboard``, ``--mlflow`` and ``--profile-dir`` in one CPU run
    (two steps, the second profiled): the TensorBoard scalars of the logged
    steps and epoch, the MLflow run (finished, a metrics file per numeric
    metric, JAX's layout), the trace and its record."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    main(["--model", "am", *TINY, "--baseline", "mean", "--precision", "f32",
          "--tensorboard", str(tmp_path / "tb"), "--mlflow", str(tmp_path / "mlruns"),
          "--profile-dir", str(tmp_path / "prof"), "--profile-steps", "1"])
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert {"loss", "reward", "val/reward", "profile/device_busy_ms"} <= set(tags)
    assert [s.step for s in acc.Scalars("loss")] == [0]
    (run,) = [d for d in (tmp_path / "mlruns" / "0").iterdir() if d.is_dir()]
    assert "status: 3" in (run / "meta.yaml").read_text()
    assert (tmp_path / "mlruns" / "0" / "meta.yaml").exists()
    assert {"loss", "val-reward", "profile-wall_ms"} <= {f.name for f in (run / "metrics").iterdir()}
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags,error", [(["--dp", "2"], "needs 2 cards"),
                                         (["--distributed"], "RANK")],
                         ids=["dp", "distributed"])
def test_data_parallel_flags_need_their_ranks(flags, error, monkeypatch):
    """``--dp 2`` on cuda raises with fewer than two cards (as the JAX
    package's `make_mesh` asserts); ``--distributed`` needs the launcher's
    ``RANK``."""
    monkeypatch.delenv("RANK", raising=False)
    argv = [a for a in ["--model", "am", *TINY] if a not in ("--device", "cpu")]
    with pytest.raises((ValueError, KeyError, RuntimeError), match=error):
        main([*argv, *flags])


@pytest.mark.parametrize("flags,ranks", [([], 1), (["--dp", "1"], 1), (["--dp", "0"], 2)],
                         ids=["default", "dp1", "dp0"])
def test_dp_takes_every_card_only_when_asked(flags, ranks, monkeypatch):
    """With two cards visible, ``--device cuda`` trains in one process unless
    ``--dp 0`` asks for every card (the port's default is one process: most
    of its algorithms do not train data-parallel). The training itself and
    the rank processes are stubbed: what is held is the number of ranks."""
    from rl4co_tpu_torch import train

    class Started(Exception):
        pass

    def start(argv, dp, device):
        raise Started(dp)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(train, "_start_local_ranks", start)
    monkeypatch.setattr(train, "_train", lambda args, mesh, device: (mesh, device))
    argv = ["--model", "ppo", "--device", "cuda", *flags]
    if ranks == 1:
        assert train.main(argv) == (None, "cuda")
    else:
        with pytest.raises(Started) as got:
            train.main(argv)
        assert got.value.args == (ranks,)


def test_dp_refuses_a_card_index(monkeypatch):
    """``--dp`` puts rank r on card r, so a card named in ``--device`` is an
    error rather than every rank on one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--device cuda, not cuda:1"):
        main(["--model", "am", "--dp", "2", "--device", "cuda:1"])


@pytest.mark.parametrize("model", ["ppo", "symnco"])
def test_a_model_that_does_not_train_data_parallel_refuses_a_mesh(model):
    """The Trainer takes a mesh only for an algorithm whose ``data_parallel``
    is true: PPO (no such attribute of its own) and SymNCO (whose loss takes
    batch means of its own) raise before a step."""
    from rl4co_tpu_torch.parallel.mesh import Mesh

    spec = WorkloadSpec(env_name="tsp", env_kwargs=(("num_loc", 6),), model=model,
                        epochs=1, batch_size=4, train_data_size=8, val_data_size=4,
                        device="cpu")
    _, trainer = build(spec, mesh=Mesh(rank=0, world=1))
    with pytest.raises(ValueError, match="does not train data-parallel"):
        trainer.fit()


@pytest.mark.parametrize("search", ["active_search", "eas-emb", "eas-lay"])
def test_search_runs_after_training_and_prints_the_jax_line(search, capsys):
    """``--search`` as the JAX command line runs it (`rl4co_tpu/train.py:316-335`):
    the search on ``--search-size`` generated instances after training, one
    JSON line with the mean best reward."""
    main(["--model", "pomo", "--env", "cvrp", *TINY, "--baseline", "shared", "--precision",
          "f32", "--search", search, "--search-size", "2", "--search-iters", "2"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"search"')]
    assert len(lines) == 1 and lines[0]["search"] == search
    assert np.isfinite(lines[0]["best_reward"]) and lines[0]["best_reward"] < 0


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


@pytest.mark.parametrize("model", ["deepaco", "gfacs"])
def test_nar_models_train_two_steps_and_resume(model, tmp_path, capsys):
    """`--model deepaco|gfacs` at TSP-10 on the CPU: the JAX command line's
    algorithm at its published defaults (NARGNN 64 wide, 15 GNN layers, 30
    ants), two steps, a finite loss, then a second epoch resumed from
    `last.pt`."""
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log.jsonl")
    args = ["--model", model, "--env", "tsp", "--num-loc", "10", "--batch-size", "2",
            "--train-size", "4", "--val-size", "2", "--device", "cpu", "--ckpt-dir", ckpt,
            "--log-file", log, "--precision", "bf16-mixed"]
    first = main(args + ["--epochs", "1"])
    assert first.step == 2 and first.n_ants_train == 30
    assert first.policy.embed_dim == 64 and first.policy.graph_network.num_layers == 15
    assert (model == "gfacs") == hasattr(first.policy, "z_net_0")
    assert all(p.dtype == torch.float32 for p in first.policy.parameters())  # f32 training
    second = main(args + ["--epochs", "2", "--resume-from", f"{ckpt}/last.pt"])
    assert second.step == 4
    records = read_jsonl(log)
    losses = [r["loss"] for r in records if "loss" in r]
    assert losses and all(np.isfinite(v) for v in losses)
    assert [r["epoch"] for r in records if "val/reward" in r] == [0.0, 1.0]
    assert all(np.isfinite(r["val/reward"]) for r in records if "val/reward" in r)
    if model == "gfacs":
        assert all(np.isfinite(r["logZ"]) for r in records if "logZ" in r)
    capsys.readouterr()


@pytest.mark.parametrize("model,env", [("pomo", "mtvrp"), ("am", "sdvrp")])
def test_multi_task_vrp_envs_train_two_steps_and_resume(model, env, tmp_path, capsys):
    """``--env mtvrp --model pomo`` (the mixed ``all`` preset: ``--num-loc``
    is the only env argument, as in the JAX command line) and ``--env sdvrp
    --model am`` (its dynamic embedding under bf16-mixed, the default) at
    N 10 on the CPU: two steps at the published widths, finite losses, then
    a second epoch resumed from `last.pt`."""
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log.jsonl")
    args = ["--model", model, "--env", env, "--num-loc", "10", "--batch-size", "2",
            "--train-size", "4", "--val-size", "2", "--device", "cpu", "--ckpt-dir", ckpt,
            "--log-file", log]
    first = main(args + ["--epochs", "1"])
    assert first.step == 2 and first.env.name == env and first.policy.embed_dim == 128
    assert first.env.variant_preset == "all" if env == "mtvrp" else first.policy.has_dynamic_embedding
    second = main(args + ["--epochs", "2", "--resume-from", f"{ckpt}/last.pt"])
    assert second.step == 4
    records = read_jsonl(log)
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)  # one record per epoch
    assert [r["epoch"] for r in records if "val/reward" in r] == [0.0, 1.0]
    assert all(np.isfinite(r["val/reward"]) for r in records if "val/reward" in r)
    capsys.readouterr()


@pytest.mark.parametrize("model", ["ppo", "a2c"])
def test_actor_critic_models_resume_as_a_straight_run_and_load_in_the_eval_cli(
        model, tmp_path, capsys):
    """``--model ppo|a2c`` at AM's published widths on TSP-6 on the CPU: two
    epochs straight, and one epoch then a second resumed from `last.pt`,
    end with equal policies, critics and optimiser steps; the eval command
    line loads the checkpoint's policy and gives its greedy reward."""
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.tasks import eval_cli

    def run(ckpt, epochs, resume=None):
        args = ["--model", model, "--env", "tsp", "--num-loc", "6", "--batch-size", "4",
                "--train-size", "8", "--val-size", "4", "--device", "cpu", "--precision", "f32",
                "--ckpt-dir", str(tmp_path / ckpt), "--epochs", str(epochs)]
        return main(args + (["--resume-from", resume] if resume else []))

    straight = run("straight", 2)
    run("split", 1)
    resumed = run("split", 2, str(tmp_path / "split" / "last.pt"))
    assert straight.step == resumed.step == 4
    assert straight.optimizer.count == resumed.optimizer.count == (32 if model == "ppo" else 4)
    for mod in ("policy", "critic"):
        for (name, a), b in zip(getattr(straight, mod).named_parameters(),
                                getattr(resumed, mod).parameters()):
            assert torch.equal(a, b), (mod, name)
    res = eval_cli.main(["--problem", "tsp", "--num-loc", "6", "--size", "4", "--device", "cpu",
                         "--ckpt-path", str(tmp_path / "split" / "last.pt")])
    inst = resumed.env.generate(4, seeded_generator(torch.device("cpu"), 1234), "cpu")
    want = resumed.make_eval_step()(inst)["reward"].item()
    np.testing.assert_allclose(res["mean_reward"], want, rtol=1e-6)
    capsys.readouterr()


def test_new_entry_points_refuse_to_run_without_a_card():
    """`tests/test_torch_imports.py::test_entry_points_refuse_to_run_without_a_card`
    for this slice's entry points: each defaults to the card and raises."""
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.policies.multi_env import MultiEnvAttentionPolicy
    from rl4co_tpu_torch.models.zoo.deepaco import DeepACO
    from rl4co_tpu_torch.models.zoo.gfacs import GFACS
    from rl4co_tpu_torch.models.zoo.nargnn import NARGNNEncoder
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
                 lambda: NARGNNEncoder(embed_dim=8, num_layers_graph_encoder=1),
                 lambda: DeepACO(get_env("tsp", num_loc=5)),
                 lambda: GFACS(get_env("tsp", num_loc=5)),
                 lambda: envs["op"].generate(2), lambda: envs["pctsp"].generate(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
