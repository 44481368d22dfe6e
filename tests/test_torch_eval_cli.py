"""The port's evaluation command line and name tables against the JAX
package's (`rl4co_tpu/tasks/eval_cli.py`, `rl4co_tpu/decoding.py`,
`rl4co_tpu/tasks/eval.py`).

The JAX command line draws its weights from `init_policy_params` (it reads
checkpoints from Orbax directories only); the test hands it a seeded tree
there, of the shapes that function makes, and the same tree, exported with
`save_params_npz`, to the port's ``--ckpt-path``, with the same
``--data-path``. The printed JSON must
hold the same keys, method and dispatch size, and a mean reward within
1e-5; the timing fields are the machine's.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import get_decoding_strategy as jax_get_decoding_strategy
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu.tasks import eval_cli as jax_eval_cli
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate
from rl4co_tpu_torch.convert import random_params_numpy, save_params_npz
from rl4co_tpu_torch.decoding import get_decoding_strategy
from rl4co_tpu_torch.tasks import eval_cli
from rl4co_tpu_torch.tasks.eval import evaluate_policy

from _torch_port import policy_pair, random_locs, tree_to_jax

torch.set_num_threads(1)

TIMING = ("inference_time", "instances_per_s", "warmup_s")


@pytest.mark.parametrize("problem,method", [("op", "multistart_greedy")])
def test_cli_json_equals_the_jax_cli_json(problem, method, tmp_path, capsys, monkeypatch):
    num_loc, dims = 7, ["--embed-dim", "16", "--num-encoder-layers", "1"]
    env = jax_get_env(problem, num_loc=num_loc)
    data = str(tmp_path / "data.npz")
    np.savez(data, **{k: np.asarray(v) for k, v in
                      env.generate_batch(jax.random.PRNGKey(3), 10).items()})
    tree = random_params_numpy(7, 16, 1, 512, env_name=problem)
    ckpt = str(tmp_path / "params.npz")
    save_params_npz(tree, ckpt)
    common = ["--problem", problem, "--num-loc", str(num_loc), "--method", method,
              "--data-path", data, "--batch-size", "4", *dims]
    # the JAX command line takes its weights from `init_policy_params`: hand
    # it the exported tree there (the shapes its own initialisation makes)
    shapes = jax.eval_shape(lambda k: init_policy_params(
        JaxPolicy(env_name=problem, embed_dim=16, num_encoder_layers=1), env, k),
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(np.shape, shapes["params"]) == jax.tree_util.tree_map(
        np.shape, tree)
    monkeypatch.setattr(jax_eval_cli, "init_policy_params", lambda *a: tree_to_jax(tree))
    jax_eval_cli.main(common)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = eval_cli.main(common + ["--ckpt-path", ckpt, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) and "rewards" not in got
    for k, v in want.items():
        if k == "mean_reward":
            assert abs(got[k] - v) <= 1e-5, (got[k], v)
        elif k not in TIMING:
            assert got[k] == v, k
    assert res["rewards"].shape == (10,)


def test_cli_reads_a_checkpoint_of_the_trainer(tmp_path, capsys):
    from rl4co_tpu_torch.train import main as train_main

    ckpt = str(tmp_path / "ckpt")
    train_main(["--model", "am", "--env", "tsp", "--num-loc", "6", "--batch-size", "4",
                "--train-size", "8", "--val-size", "4", "--epochs", "1", "--precision", "f32",
                "--baseline", "mean", "--ckpt-dir", ckpt, "--device", "cpu"])
    capsys.readouterr()
    res = eval_cli.main(["--num-loc", "6", "--size", "5", "--batch-size", "5",
                         "--ckpt-path", f"{ckpt}/last.pt", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mean_reward"] == pytest.approx(float(res["rewards"].mean()))
    with pytest.raises(ValueError, match="expected a .pt"):
        eval_cli.main(["--ckpt-path", str(tmp_path / "ckpt"), "--device", "cpu"])


NAMES = ["greedy", "sampling", "multistart_greedy", "multistart_sampling", "evaluate",
         "beam_search"]


@pytest.mark.parametrize("name", NAMES)
def test_get_decoding_strategy_gives_the_jax_fields(name):
    want = dataclasses.asdict(jax_get_decoding_strategy(name, tanh_clipping=10.0))
    got = dataclasses.asdict(get_decoding_strategy(name, tanh_clipping=10.0))
    assert got == want


def test_get_decoding_strategy_refuses_an_unknown_name():
    for fn in (jax_get_decoding_strategy, get_decoding_strategy):
        with pytest.raises(ValueError, match="Unknown decode type"):
            fn("nucleus")


def test_progress_is_called_as_jax_calls_it():
    n, count = 6, 10
    jpol, params, tpol = policy_pair(seed=5, embed_dim=16, num_encoder_layers=1,
                                     feedforward_hidden=16)
    locs = {"locs": random_locs(6, count, n)}
    want, got = [], []
    jax_evaluate(jax_get_env("tsp", num_loc=n), jpol, params, locs, "greedy", batch_size=4,
                 progress=lambda done, total: want.append((done, total)))
    from rl4co_tpu_torch.envs import get_env

    evaluate_policy(get_env("tsp", num_loc=n), tpol, locs, "greedy", batch_size=4,
                    progress=lambda done, total: got.append((done, total)), device="cpu")
    assert got == want == [(4, 10), (8, 10), (10, 10)]
