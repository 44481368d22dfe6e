"""Rendering in the port (`rl4co_tpu_torch/envs/render.py`) on the smoke cases
of the JAX package's `tests/test_render.py` (a masked random rollout of one
instance per env, drawn on the Agg back end), and the route split against
the JAX package's `_routes_from_actions`."""

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from rl4co_tpu.envs.render import _routes_from_actions as jax_routes  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.envs.render import _routes_from_actions, render  # noqa: E402

torch.set_num_threads(1)


def random_episode(env, seed):
    """One instance and a feasible random action sequence for it (a batch of
    one on the CPU), with the state it ends in."""
    gen = torch.Generator().manual_seed(seed)
    batch = env.generate(1, gen, device="cpu")
    state = env.reset(batch)
    actions = []
    for _ in range(env.max_steps):
        if bool(state.done[0]):
            break
        mask = env.action_mask(state)[0]
        choices = torch.nonzero(mask)[:, 0]
        a = choices[torch.randint(len(choices), (1,), generator=gen)]
        actions.append(int(a))
        state = env.step(state, a)
    return {k: v[0] for k, v in batch.items()}, np.asarray(actions), state


@pytest.mark.parametrize("name,kwargs", [
    ("tsp", dict(num_loc=10)), ("cvrp", dict(num_loc=10)), ("op", dict(num_loc=10)),
    ("mtsp", dict(num_loc=10)), ("flp", dict(num_loc=10)), ("mcp", dict()),
    ("smtwtp", dict()), ("ffsp", dict(num_job=4)), ("dpp", dict())])
def test_render_smoke(name, kwargs):
    env = get_env(name, **kwargs)
    instance, actions, state = random_episode(env, 0)
    ax = render(env, instance, actions, state=state)
    assert ax is not None and ax.has_data()
    ax.figure.clf()
    if name in ("smtwtp", "dpp"):   # without the state: the actions replayed
        ax = render(env, instance, actions)
        assert ax.has_data()
        ax.figure.clf()


def test_render_atsp_circle():
    env = get_env("atsp", num_loc=8)
    instance, _, _ = random_episode(env, 0)
    ax = render(env, instance, np.random.default_rng(0).permutation(8))
    assert ax is not None
    ax.figure.clf()


@pytest.mark.parametrize("depots", [(0,), (0, 1, 2)])
def test_routes_from_actions_are_the_jax_ones(depots):
    rng = np.random.default_rng(3)
    for _ in range(20):
        actions = rng.integers(0, 9, size=rng.integers(1, 15))
        assert _routes_from_actions(actions, depots) == jax_routes(actions, depots)
