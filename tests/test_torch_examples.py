"""The port's examples (`rl4co_tpu_torch/examples/`) on the CPU.

- Each example's ``main`` runs through `chip_smoke.drive_examples`, the
  card's phase, at small sizes (N <= 12 but for example 06's fixed 16-node
  demo, batch <= 8, at most 2 steps or iterations) with ``device="cpu"``,
  the pointer kernel's forward counting its launches by the query's rank as
  the card's wrapper does: each example launches the kernels that
  `chip_smoke.EXAMPLES` names for it and no other, and returns finite
  numbers. Example 12 runs its second rank as a gloo process on the CPU.
- Example 03's k-center env against the JAX example's on the same numpy
  instances and actions: masks equal at every step, rewards within 1e-6; and
  `get_env("kcenter")` is the port's class once registered.
- Example 06's demo TSPLIB and CVRPLIB files are the JAX example's, and the
  costs it reports are the JAX package's costs of the same solutions
  (TSPLIB's rounded arithmetic exactly, the normalised CVRP cost within 1e-5).
- No example imports JAX or the JAX package, and each raises without a card
  by default.
"""

import ast
import importlib.util
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_HERE)
sys.path[:0] = [_HERE, ROOT]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rl4co_tpu_torch.envs import ENV_REGISTRY, get_env  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.context import CONTEXT_EMBEDDING_REGISTRY  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.init import INIT_EMBEDDING_REGISTRY  # noqa: E402
from rl4co_tpu_torch.ops import pointer_kernel  # noqa: E402

torch.set_num_threads(1)

SMALL = {
    "01_quickstart": dict(num_loc=8, epochs=1, batch_size=8, train_data_size=16,
                          val_data_size=8, test_size=8),
    "02_full_training": dict(num_loc=8, epochs=1, batch_size=8, train_data_size=8, val_size=8),
    "03_new_env_and_model": dict(num_loc=10, k=3, epochs=1, batch_size=8, train_data_size=16,
                                 val_data_size=8),
    "04_decoding_strategies": dict(num_loc=8, batch=8),
    "05_transductive_search": dict(num_loc=8, n_instances=2, max_iters=2),
    "06_tsplib_cvrplib": dict(num_samples=4),
    "07_local_search": dict(num_loc=10, batch=8),
    "08_mtvrp": dict(num_loc=8, batch=4),
    "09_scheduling": dict(num_jobs=3, num_mas=2, batch=2, steps=2),
    "10_generator_distributions": dict(n=50),
    "11_meta_reptile": dict(tasks=({"num_loc": 6}, {"num_loc": 8}), epochs=2, steps_per_task=1,
                            batch_size=4),
    "12_multichip_dp": dict(num_loc=8, batch_per_rank=4, steps=2),
    "13_canonical_datasets": dict(num_loc=8, n=8),
}
REGISTRIES = (ENV_REGISTRY, INIT_EMBEDDING_REGISTRY, CONTEXT_EMBEDDING_REGISTRY)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def registries():
    """The env and embedding registries as they were, after the test
    (example 03 registers its k-center env)."""
    saved = [dict(r) for r in REGISTRIES]
    yield
    for reg, keep in zip(REGISTRIES, saved):
        reg.clear()
        reg.update(keep)


@pytest.fixture
def counted_launches(monkeypatch):
    """The kernel's forward counting a launch per call, by the query's rank,
    into the wrapper's `LAUNCHES`; the card's synchronisation a no-op."""
    forward = pointer_kernel._PointerLogits.forward

    def counting(ctx, q, *args):
        name = "pointer_step_single" if q.ndim == 2 else "pointer_step_grouped"
        pointer_kernel.LAUNCHES[name] += 1
        return forward(ctx, q, *args)

    monkeypatch.setattr(pointer_kernel._PointerLogits, "forward", staticmethod(counting))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_every_example_has_its_sizes_here_and_its_kernels_on_the_card():
    names = sorted(f[:-3] for f in os.listdir(chip_smoke.EXAMPLES_DIR) if f.endswith(".py"))
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                       if f.endswith(".py"))
    assert names == jax_names == sorted(SMALL) == sorted(chip_smoke.EXAMPLES)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_the_cpu_through_its_kernels(name, counted_launches, registries):
    report, launches = chip_smoke.drive_examples(torch.device("cpu"), SMALL, names=(name,))
    assert set(report) == set(launches) == {name}
    assert report[name]["seconds"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_imports_no_jax_and_needs_a_card_by_default(name):
    path = os.path.join(chip_smoke.EXAMPLES_DIR, f"{name}.py")
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".")[0] in ("jax", "flax", "optax", "rl4co_tpu")
                           for m in mods), (name, mods)
    module = chip_smoke.load_example(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            module.main()


def test_kcenter_env_is_the_jax_examples(registries):
    port = chip_smoke.load_example("03_new_env_and_model")
    jax_ex = _load(os.path.join(ROOT, "examples", "03_new_env_and_model.py"), "jax_example_03")
    port.register()
    assert get_env("kcenter", num_loc=12, k=3).__class__ is port.KCenter
    assert INIT_EMBEDDING_REGISTRY["kcenter"] is port.KCenterInitEmbedding
    assert CONTEXT_EMBEDDING_REGISTRY["kcenter"] is port.KCenterContext

    n, k, b = 12, 3, 4
    rs = np.random.RandomState(0)
    locs = rs.random_sample((b, n, 2)).astype(np.float32)
    actions = np.stack([rs.permutation(n)[:k] for _ in range(b)])
    actions = np.concatenate([actions, np.zeros((b, 1), np.int64)], axis=1)  # a padding step
    env, jenv = port.KCenter(num_loc=n, k=k), jax_ex.KCenter(num_loc=n, k=k)
    state = env.reset({"locs": torch.from_numpy(locs)})
    jstate = jenv.reset_batch({"locs": jnp.asarray(locs)})
    for t in range(k + 1):
        np.testing.assert_array_equal(env.action_mask(state).numpy(),
                                      np.asarray(jenv.action_mask_batch(jstate)))
        state = env.step(state, torch.from_numpy(actions[:, t]))
        jstate = jenv.step_batch(jstate, jnp.asarray(actions[:, t], dtype=jnp.int32))
    np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
    np.testing.assert_allclose(env.reward(state, torch.from_numpy(actions)).numpy(),
                               np.asarray(jenv.reward_batch(jstate, jnp.asarray(actions))),
                               rtol=0, atol=1e-6)
    env.check_solution_validity(None, actions)


def test_tsplib_cvrplib_demo_costs_are_the_jax_examples():
    from rl4co_tpu.data import tsplib as jtsplib

    port = chip_smoke.load_example("06_tsplib_cvrplib")
    jax_ex = _load(os.path.join(ROOT, "examples", "06_tsplib_cvrplib.py"), "jax_example_06")
    assert port.DEMO_TSP == jax_ex.DEMO_TSP and port.DEMO_VRP == jax_ex.DEMO_VRP
    res = port.main(num_samples=4, device="cpu")

    problem = jtsplib.read_tsplib(port.DEMO_TSP)
    tour = np.asarray(res["demo16.tsp"]["solution"])
    assert sorted(tour) == list(range(16))
    assert res["demo16.tsp"]["cost"] == jtsplib.tour_cost(problem, tour)

    problem = jtsplib.read_tsplib(port.DEMO_VRP)
    jenv, batch = jtsplib.vrplib_to_cvrp_batch(problem)
    actions = jnp.asarray(res["demo-vrp.vrp"]["solution"], dtype=jnp.int32)[None]
    state = jenv.reset_batch(batch)
    for t in range(actions.shape[1]):
        state = jenv.step_batch(state, actions[:, t])
    want = -float(jenv.reward_batch(state, actions)[0])
    np.testing.assert_allclose(res["demo-vrp.vrp"]["cost"], want, rtol=0, atol=1e-5)
