"""The port's classical-solver adapters (`rl4co_tpu_torch/envs/routing/
solver_adapters/`) and MTVRP baselines (`mtvrp_baselines.py`) against the
JAX package's, on the cases of `tests/test_solver_adapters.py`: the
conversions equal the JAX package's on the same instances, the adapters
drive fake solver modules to the same actions and rewards, a missing package
raises ImportError, and `MTVRP.solve`'s greedy default (one sample: no noise)
gives JAX's `greedy_solve` tours and costs."""

import types

import jax
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.envs.routing import mtvrp_baselines as jax_baselines
from rl4co_tpu.envs.routing.solver_adapters import convert as jax_convert
from rl4co_tpu.envs.routing.solver_adapters import solve_batch as jax_solve_batch
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.envs.routing import mtvrp_baselines
from rl4co_tpu_torch.envs.routing.solver_adapters import convert, solve_batch
from rl4co_tpu_torch.envs.routing.solver_adapters import lkh as lkh_adapter
from rl4co_tpu_torch.envs.routing.solver_adapters import ortools as ortools_adapter
from rl4co_tpu_torch.envs.routing.solver_adapters import pyvrp as pyvrp_adapter
from test_solver_adapters import make_fake_pyvrp

torch.set_num_threads(1)


def mtvrp_instances(n=3, num_loc=6, seed=0):
    """JAX-generated MTVRP instances as numpy arrays."""
    env = jax_get_env("mtvrp", num_loc=num_loc)
    return {k: np.asarray(v) for k, v in
            jax.device_get(env.generate_batch(jax.random.PRNGKey(seed), n)).items()}


def assert_same_dicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_split_batch_is_the_jax_one(as_tensors):
    inst = mtvrp_instances()
    given = {k: torch.tensor(v) for k, v in inst.items()} if as_tensors else inst
    assert_same_dicts(convert.split_batch(given), jax_convert.split_batch(inst))
    cvrp = {k: np.asarray(v) for k, v in jax.device_get(
        jax_get_env("cvrp", num_loc=5).generate_batch(jax.random.PRNGKey(0), 2)).items()}
    per = convert.split_batch(cvrp)
    assert_same_dicts(per, jax_convert.split_batch(cvrp))
    assert per[0]["demand_linehaul"].shape == (6,) and per[0]["demand_linehaul"][0] == 0.0


def test_scale_int_and_routes_to_action():
    arr = convert.scale_int(np.array([0.5, np.inf, 1.23456]), 1000)
    assert arr.tolist() == [500, convert.INT32_MAX, 1235]
    assert convert.scale_int(np.float64(2.0), 10) == 20
    assert convert.routes_to_action([[1, 2], [3]]) == [1, 2, 0, 3, 0]


def test_pyvrp_adapter_with_fake_module(monkeypatch):
    from rl4co_tpu.envs.routing.solver_adapters import pyvrp as jax_adapter

    inst = mtvrp_instances(n=2, num_loc=5)
    results = []
    for adapter, solve in ((pyvrp_adapter, solve_batch), (jax_adapter, jax_solve_batch)):
        captured = {}
        fake = make_fake_pyvrp(captured)
        monkeypatch.setattr(adapter, "_import_pyvrp", lambda f=fake: (f, lambda max_runtime: None))
        actions, rewards = solve(inst, "pyvrp", max_runtime=1.0)
        results.append((actions, rewards, captured["matrix"],
                        [vars(c) for c in captured["clients"]]))
    (a, r, m, c), (ja, jr, jm, jc) = results
    assert a.shape == (2, 6) and (a[:, :5] == np.arange(1, 6)).all()
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(r, -4.2)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(m, jm)
    assert c == jc


def test_pyvrp_backhaul_precedence_arcs():
    captured = {}
    fake = make_fake_pyvrp(captured)
    locs = np.array([[0.5, 0.5], [0.1, 0.1], [0.9, 0.9]])
    inst = {"locs": locs, "demand_linehaul": np.array([0.0, 0.3, 0.0]),
            "demand_backhaul": np.array([0.0, 0.0, 0.2]),
            "time_windows": np.array([[0, 3.0], [0, 3.0], [0, 3.0]]),
            "service_time": np.zeros(3), "vehicle_capacity": np.float64(1.0),
            "distance_limit": np.float64(np.inf), "open_route": np.bool_(False),
            "backhaul_class": np.int64(1),
            "cost_matrix": np.linalg.norm(locs[:, None] - locs[None], axis=-1)}
    pyvrp_adapter.instance_to_data(fake, inst)
    assert captured["matrix"][2, 1] == np.iinfo(np.int32).max   # backhaul -> linehaul
    assert captured["matrix"][1, 2] != np.iinfo(np.int32).max


def test_missing_packages_raise_importerror():
    with pytest.raises(ImportError, match="PyVRP"):
        pyvrp_adapter._import_pyvrp()
    with pytest.raises(ImportError):
        lkh_adapter._import_lkh()
    with pytest.raises(ImportError):
        ortools_adapter._import_ortools()


def test_lkh_adapter_with_fake_module(monkeypatch):
    from rl4co_tpu.envs.routing.solver_adapters import lkh as jax_adapter

    inst = mtvrp_instances(n=1, num_loc=4)
    texts = []
    for adapter, solve in ((lkh_adapter, solve_batch), (jax_adapter, jax_solve_batch)):
        parsed = {}

        class FakeProblem:
            @staticmethod
            def parse(text, parsed=parsed):
                parsed["text"] = text
                return "PROBLEM"

        fake = types.SimpleNamespace(LKHProblem=FakeProblem,
                                     solve=lambda solver_loc, problem, time_limit, runs:
                                     ([[1, 3], [2, 4]], 123456.0))
        monkeypatch.setattr(adapter, "_import_lkh", lambda f=fake: f)
        actions, rewards = solve(inst, "lkh", max_runtime=1.0, problem_type="VRPTW")
        assert actions.tolist() == [[1, 3, 0, 2, 4, 0]]
        np.testing.assert_allclose(rewards, [-123456.0 / convert.LKH_SCALING_FACTOR])
        texts.append(parsed["text"])
    assert texts[0] == texts[1]
    assert "TYPE : CVRPTW" in texts[0] and texts[0].rstrip().endswith("EOF")
    with pytest.raises(ValueError, match="not expressible"):
        lkh_adapter.instance_to_problem(None, {}, "VRPB")


def test_solve_dispatch_and_external_via_fake(monkeypatch):
    captured = {}
    fake = make_fake_pyvrp(captured)
    monkeypatch.setattr(pyvrp_adapter, "_import_pyvrp", lambda: (fake, lambda max_runtime: None))
    inst = mtvrp_instances(n=2, num_loc=5)
    actions, cost = mtvrp_baselines.solve(inst, solver="pyvrp")
    assert actions.shape == (2, 6)
    np.testing.assert_allclose(cost, 4.2)
    with pytest.raises(ValueError, match="Unknown solver"):
        mtvrp_baselines.solve(inst, solver="nope")
    with pytest.raises(ValueError, match="env="):
        mtvrp_baselines.solve(inst)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_default_is_the_jax_greedy_solve(seed):
    inst = mtvrp_instances(n=8, num_loc=10, seed=seed)
    want_actions, want_cost = jax_baselines.greedy_solve(
        jax_get_env("mtvrp", num_loc=10), {k: jax.numpy.asarray(v) for k, v in inst.items()},
        num_samples=1)
    env = get_env("mtvrp", num_loc=10)
    actions, cost = env.solve({k: torch.tensor(v) for k, v in inst.items()}, num_samples=1)
    np.testing.assert_array_equal(actions.numpy(), np.asarray(want_actions))
    np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost), rtol=1e-6)
    more_actions, more_cost = env.solve({k: torch.tensor(v) for k, v in inst.items()},
                                        num_samples=4)
    assert bool((more_cost <= cost + 1e-6).all())   # sample 0 is the greedy one
    env.check_solution_validity({k: torch.tensor(v) for k, v in inst.items()}, more_actions)
