"""The port's evaluation dispatch sizing against `rl4co_tpu/tasks/eval.py`.

- `_hbm_instance_cap` equals the JAX function over a grid of widths, node
  counts, starts, augments and budgets (arithmetic only).
- With ``batch_size=None`` `evaluate_policy` picks the JAX package's
  dispatch size for AM's and AM-XL's widths at N 20, 200 and 1000, greedy,
  multistart and dihedral-8, with and without ``RL4CO_EVAL_BATCH_CEIL`` and
  ``RL4CO_EVAL_HBM_BUDGET``. Both packages run their own `evaluate_policy`
  on four instances with the rollout replaced by a stand-in of the right
  shapes, so that only the sizing runs.
- An out-of-memory error injected into the sweep (PyTorch's
  `torch.OutOfMemoryError`, or CUDA's "out of memory" text) halves the
  dispatch and redoes the whole sweep: the rewards are those of a run at the
  halved size, sampling draws included. Any other error propagates at once.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.tasks import eval as jeval
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.tasks import eval as teval

torch.set_num_threads(1)

WIDTHS = {"am": dict(embed_dim=128, num_heads=8, num_encoder_layers=3),
          "am-xl": dict(embed_dim=128, num_heads=8, num_encoder_layers=6)}
METHODS = ("greedy", "multistart_greedy", "augment_dihedral_8")
ENVIRONS = ({}, {"RL4CO_EVAL_BATCH_CEIL": "65536"}, {"RL4CO_EVAL_HBM_BUDGET": "1e9"})


@pytest.mark.parametrize("d,h,layers", [(128, 8, 3), (128, 8, 6), (256, 16, 5), (64, 4, 1)])
def test_hbm_instance_cap_is_the_jax_function(d, h, layers, monkeypatch):
    policy = types.SimpleNamespace(embed_dim=d, num_heads=h, num_encoder_layers=layers)
    for budget in (None, "1e9", "8e10"):
        if budget is None:
            monkeypatch.delenv("RL4CO_EVAL_HBM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("RL4CO_EVAL_HBM_BUDGET", budget)
        for n in (10, 20, 50, 100, 200, 500, 1000, 2000):
            for starts, augs in ((1, 1), (n, 1), (1, 8), (n, 8), (1280, 1)):
                assert (teval._hbm_instance_cap(policy, n, starts, augs)
                        == jeval._hbm_instance_cap(policy, n, starts, augs)), (n, starts, augs)


def _stub_env(n):
    return types.SimpleNamespace(get_num_starts=lambda: n, name="tsp")


def _jax_batch_size(policy, n, method):
    """The JAX `evaluate_policy`'s dispatch size, its rollout a stand-in."""
    def rollout(policy, params, env, batch, key, spec, *args, **kwargs):
        rows = batch["locs"].shape[0] * max(spec.num_starts, 1)
        return types.SimpleNamespace(reward=jnp.zeros(rows), actions=None)

    orig, jeval.rollout = jeval.rollout, rollout
    try:
        locs = np.random.RandomState(0).random_sample((4, n, 2)).astype(np.float32)
        return jeval.evaluate_policy(_stub_env(n), policy, None, {"locs": locs}, method,
                                     warmup=False)["batch_size"]
    finally:
        jeval.rollout = orig


def _port_batch_size(policy, n, method):
    def rollout(policy, env, batch, spec, **kwargs):
        rows = batch["locs"].shape[0] * max(spec.num_starts, 1)
        return types.SimpleNamespace(reward=torch.zeros(rows), actions=None)

    orig, teval.rollout = teval.rollout, rollout
    try:
        locs = np.random.RandomState(0).random_sample((4, n, 2)).astype(np.float32)
        return teval.evaluate_policy(_stub_env(n), policy, {"locs": locs}, method,
                                     warmup=False, device="cpu")["batch_size"]
    finally:
        teval.rollout = orig


@pytest.mark.parametrize("environ", ENVIRONS, ids=["default", "ceil", "budget"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_batch_size_none_picks_the_jax_dispatch_size(width, environ, monkeypatch):
    for key in ("RL4CO_EVAL_BATCH_CEIL", "RL4CO_EVAL_HBM_BUDGET"):
        monkeypatch.delenv(key, raising=False)
    for key, value in environ.items():
        monkeypatch.setenv(key, value)
    policy = types.SimpleNamespace(**WIDTHS[width])
    seen = set()
    for n in (20, 200, 1000):
        for method in METHODS:
            want = _jax_batch_size(policy, n, method)
            assert _port_batch_size(policy, n, method) == want, (n, method)
            seen.add(want)
    assert len(seen) > 3   # the cap and the ceiling both bind somewhere
    if not environ:   # the example of the JAX package's docstring: AM, TSP-1000, greedy
        assert _port_batch_size(policy, 1000, "greedy") == 121


N, COUNT = 8, 8


def _oom_policy(monkeypatch, fail_above, error):
    """AM on the CPU whose rollouts of more than ``fail_above`` rows raise
    ``error``; returns it and the dispatch sizes it was asked for."""
    torch.manual_seed(0)
    policy = AttentionModelPolicy(env_name="tsp", embed_dim=16, num_heads=2,
                                  num_encoder_layers=1, feedforward_hidden=32, device="cpu")
    seen = []
    inner = teval.rollout

    def rollout(policy, env, batch, spec, **kwargs):
        rows = batch["locs"].shape[0]
        seen.append(rows)
        if rows > fail_above:
            raise error
        return inner(policy, env, batch, spec, **kwargs)

    monkeypatch.setattr(teval, "rollout", rollout)
    return policy, seen


@pytest.mark.parametrize("error", [torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                                          "allocate 2.00 GiB"),
                                   RuntimeError("CUDA error: out of memory")],
                         ids=["torch-oom", "cuda-text"])
@pytest.mark.parametrize("method", ["greedy", "sampling"])
def test_an_oom_halves_the_dispatch_and_redoes_the_sweep(method, error, monkeypatch):
    env = get_env("tsp", num_loc=N)
    locs = np.random.RandomState(3).random_sample((COUNT + 3, N, 2)).astype(np.float32)
    kwargs = dict(num_samples=4) if method == "sampling" else {}
    policy, seen = _oom_policy(monkeypatch, 2, error)
    got = teval.evaluate_policy(env, policy, {"locs": locs}, method, batch_size=8,
                                generator=torch.Generator().manual_seed(5), device="cpu",
                                **kwargs)
    assert got["oom_halvings"] == 2 and got["batch_size"] == 2
    assert seen[:2] == [8, 4] and set(seen[2:]) == {2}
    monkeypatch.undo()
    want = teval.evaluate_policy(env, policy, {"locs": locs}, method, batch_size=2,
                                 generator=torch.Generator().manual_seed(5), device="cpu",
                                 **kwargs)
    assert "oom_halvings" not in want
    np.testing.assert_array_equal(got["rewards"], want["rewards"])


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: too many resources requested "
                                                "for launch"),
                                   RuntimeError("nvcc failed to build pointer_kernel.cu"),
                                   ValueError("out of memory")],
                         ids=["launch", "build", "not-a-runtime-error"])
def test_any_other_error_propagates(error, monkeypatch):
    policy, seen = _oom_policy(monkeypatch, 0, error)
    with pytest.raises(type(error), match=str(error)):
        teval.evaluate_policy(get_env("tsp", num_loc=N), policy,
                              {"locs": np.zeros((4, N, 2), np.float32)}, "greedy",
                              batch_size=4, device="cpu")
    assert seen == [4]   # no retry
    assert not teval._is_device_oom(error)


def test_oom_is_recognised_as_the_jax_package_does_for_these_errors():
    for e in (torch.OutOfMemoryError("CUDA out of memory"),
              RuntimeError("CUDA error: out of memory")):
        assert teval._is_device_oom(e) and jeval._is_device_oom(e)
