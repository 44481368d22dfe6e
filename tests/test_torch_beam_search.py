"""Beam search (`models/policies/beam_search.py`) against
`rl4co_tpu/models/policies/beam_search.py`, through `rollout` and
`evaluate_policy`, on TSP and CVRP.

Beam search is deterministic, so actions are compared to the bit; rewards
rtol 1e-5 and log-likelihoods atol 1e-4, as `test_torch_rollout.py`. Which
candidates survive a step is decided by value with ties to the lower index,
as `jax.lax.top_k` decides: a beam wider than the feasible actions (16 beams
on TSP-10 at step 0; 30 on TSP-4, past its 24 tours; 12 on CVRP-8) fills the rest
with tied masked or dead candidates, and those junk beams must be the JAX
package's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import rollout as jax_rollout
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.models.policies.beam_search import top_k_lower_index_first
from rl4co_tpu_torch.tasks.eval import evaluate_policy

from _torch_port import policy_pair, pomo_pair, random_cvrp, random_locs, t2n

torch.set_num_threads(1)

N, B = 10, 4
KEY = jax.random.PRNGKey(0)


def both(jpol, jparams, tpol, env_name, num_loc, inst, width, select_best):
    spec = dict(kind="beam_search", beam_width=width, select_best=select_best,
                tanh_clipping=10.0)
    jout = jax_rollout(jpol, jparams, jax_get_env(env_name, num_loc=num_loc),
                       {k: jnp.asarray(v) for k, v in inst.items()}, KEY, JaxSpec(**spec))
    with torch.no_grad():
        tout = rollout(tpol, get_env(env_name, num_loc=num_loc), inst, DecodeSpec(**spec),
                       device="cpu")
    return jout, tout


def assert_same(jout, tout):
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    np.testing.assert_allclose(t2n(tout.reward), np.asarray(jout.reward), rtol=1e-5)
    np.testing.assert_allclose(t2n(tout.log_likelihood), np.asarray(jout.log_likelihood),
                               atol=1e-4)
    np.testing.assert_allclose(t2n(tout.logprobs), np.asarray(jout.logprobs), atol=1e-4)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("width", [1, 3, N, 16], ids=["w1", "w3", "wN", "w16-wider"])
@pytest.mark.parametrize("select_best", [False, True], ids=["all-beams", "best"])
def test_tsp_beam_search_matches_jax(jimpl, width, select_best):
    jpol, jparams, tpol = policy_pair(seed=2, jax_pointer_impl=jimpl)
    inst = {"locs": random_locs(3, B, N)}
    jout, tout = both(jpol, jparams, tpol, "tsp", N, inst, width, select_best)
    assert tout.actions.shape == ((B if select_best else width * B), N)
    assert_same(jout, tout)
    if select_best:
        get_env("tsp", num_loc=N).check_solution_validity({}, t2n(tout.actions))


@pytest.mark.parametrize("select_best", [False, True], ids=["all-beams", "best"])
def test_beam_wider_than_the_feasible_continuations_matches_jax(select_best):
    """30 beams on TSP-4, which has 24 tours: from step 0 on, dead beams
    (-inf) and beams that took a masked city (about -1e9, equal in f32) fill
    the places the feasible continuations leave, by index among the ties, and
    six beams per instance end as junk, in both packages alike."""
    jpol, jparams, tpol = policy_pair(seed=5)
    inst = {"locs": random_locs(9, B, 4)}
    jout, tout = both(jpol, jparams, tpol, "tsp", 4, inst, 30, select_best)
    assert_same(jout, tout)
    if not select_best:
        junk = np.array([len(set(row)) < 4 for row in t2n(tout.actions)])
        assert junk.sum() == 6 * B
        assert (t2n(tout.log_likelihood)[junk] < -1e8).all()


@pytest.mark.parametrize("width", [5, 12], ids=["w5", "w12-wider"])
def test_cvrp_beam_search_matches_jax(width):
    """CVRP-8 (POMO's policy): done beams pad with the depot at log-probability 0."""
    jpol, jparams, tpol = pomo_pair(seed=4)
    inst = random_cvrp(5, B, 8)
    jout, tout = both(jpol, jparams, tpol, "cvrp", 8, inst, width, False)
    assert_same(jout, tout)


def test_beam_search_beats_or_equals_greedy():
    _, _, tpol = policy_pair(seed=2)
    env = get_env("tsp", num_loc=N)
    inst = {"locs": random_locs(6, B, N)}
    with torch.no_grad():
        greedy = rollout(tpol, env, inst, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                         device="cpu")
        beam = rollout(tpol, env, inst, DecodeSpec(kind="beam_search", beam_width=N,
                                                   tanh_clipping=10.0), device="cpu")
    # the greedy tour's prefix is the best of beam 0 at every step only if it
    # stays in the beam; here the beam's log-likelihood of its best tour is at
    # least a tour's of width 1 (the greedy one)
    assert (beam.log_likelihood.max() <= 0) and torch.isfinite(beam.reward).all()
    assert beam.reward.mean() >= greedy.reward.mean() - 1e-6


def test_top_k_breaks_ties_as_jax_top_k():
    rs = np.random.RandomState(0)
    x = rs.choice([-np.inf, -1e9, -3.0, -2.5, 0.0], size=(6, 40)).astype(np.float32)
    x[0] = -np.inf  # a row of dead candidates only
    for k in (1, 5, 17, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k_lower_index_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(t2n(tv), np.asarray(jv))
        np.testing.assert_array_equal(t2n(ti), np.asarray(ji))


def test_evaluate_policy_beam_search_matches_jax():
    """The `beam_search` method: width `env.get_num_starts()`, the best beam
    per instance, default dispatch 8192 // width, a ragged tail padded."""
    jpol, jparams, tpol = policy_pair(seed=7)
    locs = random_locs(8, 7, N)
    kw = dict(batch_size=3, return_actions=True, check_solutions=True, warmup=False)
    jres = jax_evaluate(jax_get_env("tsp", num_loc=N), jpol, jparams, {"locs": locs},
                        "beam_search", **kw)
    tres = evaluate_policy(get_env("tsp", num_loc=N), tpol, {"locs": locs}, "beam_search",
                           device="cpu", **kw)
    np.testing.assert_array_equal(tres["actions"], jres["actions"])
    np.testing.assert_allclose(tres["rewards"], jres["rewards"], rtol=1e-5)
    res = evaluate_policy(get_env("tsp", num_loc=N), tpol, {"locs": locs}, "beam_search",
                          warmup=False, device="cpu")
    assert res["batch_size"] == 8192 // N
