"""The port's OP, PCTSP and SPCTSP envs and their AM embeddings against the
JAX package's: instances generated by the JAX package, random feasible
actions replayed through both envs with every field of the state and every
mask compared exactly at each step (rewards, sums in another order, and
PCTSP's running penalty, which starts from one, within 1e-6 absolute and
relative), the rules of the
depot, the validity checks, the port's generators, and AM's greedy and
multistart greedy rollouts on each env (equal actions, rewards within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import AttentionModelPolicy, rollout
from rl4co_tpu_torch.rl.reinforce import seeded_generator

from _torch_port import SMALL, t2n, tree_to_jax

torch.set_num_threads(1)

# (registry name, env kwargs)
ENVS = [
    ("op", {"prize_type": "dist"}),
    ("op", {"prize_type": "unif"}),
    ("op", {"prize_type": "const"}),
    ("pctsp", {}),
    ("spctsp", {}),
]
IDS = ["op-dist", "op-unif", "op-const", "pctsp", "spctsp"]


def both(name, n, **kw):
    return get_env(name, num_loc=n, **kw), jax_get_env(name, num_loc=n, **kw)


def jax_instances(jenv, seed, b):
    """Instances generated by the JAX package, as numpy arrays."""
    inst = jenv.generate_batch(jax.random.PRNGKey(seed), b)
    return {k: np.asarray(v) for k, v in inst.items()}


def to_torch(inst):
    return {k: torch.tensor(v) for k, v in inst.items()}


def to_jax(inst):
    return {k: jnp.asarray(v) for k, v in inst.items()}


# PCTSP's running penalty starts from the sum of the N penalties, which XLA's
# CPU backend and torch reduce in other orders: f32 rounding apart
SUMMED_FIELDS = ("cur_total_penalty",)


def assert_states_equal(ts, js):
    for f in type(ts).__dataclass_fields__:
        got, want = t2n(getattr(ts, f)), np.asarray(getattr(js, f))
        if f in SUMMED_FIELDS:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


def random_episode(rs, tenv, jenv, inst, extra=2, depot_odds=0.1):
    """Random feasible actions through both envs, ``extra`` steps past the trip
    count (the depot taken with ``depot_odds`` where allowed); masks and
    states compared at every step. Returns the actions and both final states."""
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    assert_states_equal(ts, js)
    actions = []
    for _ in range(tenv.max_steps + extra):
        mask = t2n(tenv.action_mask(ts))
        np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
        assert mask.any(axis=-1).all()
        act = np.empty(mask.shape[0], dtype=np.int64)
        for row, m in enumerate(mask):
            choices = np.flatnonzero(m)
            if m[0] and len(choices) > 1 and rs.random_sample() >= depot_odds:
                choices = choices[1:]
            act[row] = rs.choice(choices)
        actions.append(act)
        ts = tenv.step(ts, torch.from_numpy(act))
        js = jenv.step_batch(js, jnp.asarray(act, dtype=jnp.int32))
        assert_states_equal(ts, js)
    return np.stack(actions, axis=1), ts, js


EPISODES = ([(name, kw, 6, 8, 0) for name, kw in ENVS]
            + [("op", {"prize_type": "dist"}, 20, 6, 1), ("spctsp", {}, 20, 6, 1)])


@pytest.mark.parametrize("name,kw,n,b,seed", EPISODES,
                         ids=[f"{i}-6" for i in IDS] + ["op-dist-20", "spctsp-20"])
def test_random_feasible_episodes_match_step_by_step(name, kw, n, b, seed):
    rs = np.random.RandomState(seed)
    tenv, jenv = both(name, n, **kw)
    inst = jax_instances(jenv, seed, b)
    actions, ts, js = random_episode(rs, tenv, jenv, inst)
    assert t2n(ts.done).all(), "an episode outlasted num_loc + 2 steps"
    # done rows: the depot is the only action, and the state stays frozen
    mask = t2n(tenv.action_mask(ts))
    assert mask[:, 0].all() and (mask.sum(-1) == 1).all()
    r_t = t2n(tenv.reward(ts, torch.from_numpy(actions)))
    r_j = np.asarray(jenv.reward_batch(js, jnp.asarray(actions)))
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6, atol=1e-6)
    trip = actions[:, : tenv.max_steps]
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        tenv.check_solution_validity(one, trip[row])
        jenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)  # the batched form agrees


def test_op_depot_first_ends_the_tour_at_step_one():
    tenv, jenv = both("op", 5)
    inst = jax_instances(jenv, 3, 2)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    assert t2n(tenv.action_mask(ts))[:, 0].all()  # the depot is feasible at step 0
    masks = []
    for a in ([0, 2], [0, 0], [0, 0]):
        ts = tenv.step(ts, torch.tensor(a))
        js = jenv.step_batch(js, jnp.asarray(a, dtype=jnp.int32))
        assert_states_equal(ts, js)
        masks.append(t2n(tenv.action_mask(ts)))
        np.testing.assert_array_equal(masks[-1], np.asarray(jenv.action_mask_batch(js)))
    # a depot at step 0 does not end the episode (done needs i > 0), but it
    # leaves the depot alone feasible: the tour ends at step 1, empty
    assert masks[0][0, 0] and masks[0][0].sum() == 1 and masks[0][1, 1:].any()
    np.testing.assert_array_equal(t2n(ts.i), [2, 2])
    np.testing.assert_array_equal(t2n(ts.done), [True, True])
    np.testing.assert_array_equal(t2n(tenv.reward(ts, torch.tensor([[0, 0, 0], [2, 0, 0]]))),
                                  [0.0, inst["prize"][1, 1]])


@pytest.mark.parametrize("name", ["pctsp", "spctsp"])
def test_pctsp_depot_waits_for_the_prize_unless_no_customer_is_left(name):
    n = 4
    tenv, jenv = both(name, n, prize_required=10.0)  # out of reach: visit all
    inst = jax_instances(jenv, 4, 2)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    for a in ([1, 4], [2, 3], [3, 2]):
        ts = tenv.step(ts, torch.tensor(a))
        js = jenv.step_batch(js, jnp.asarray(a, dtype=jnp.int32))
        mask = t2n(tenv.action_mask(ts))
        np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
        assert not mask[:, 0].any()
    ts = tenv.step(ts, torch.tensor([4, 1]))
    js = jenv.step_batch(js, jnp.asarray([4, 1], dtype=jnp.int32))
    mask = t2n(tenv.action_mask(ts))
    np.testing.assert_array_equal(mask, np.asarray(jenv.action_mask_batch(js)))
    assert mask[:, 0].all() and mask.sum() == 2  # nothing left: the depot alone


def test_spctsp_constrains_on_the_realised_prize():
    n = 6
    inst = jax_instances(jax_get_env("spctsp", num_loc=n), 5, 4)
    for name in ("pctsp", "spctsp"):
        tenv, jenv = both(name, n)
        ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
        key = "stochastic_prize" if name == "spctsp" else "deterministic_prize"
        np.testing.assert_array_equal(t2n(ts.real_prize)[:, 1:], inst[key])
        np.testing.assert_array_equal(t2n(ts.expected_prize), inst["deterministic_prize"])
        assert_states_equal(ts, js)


def jax_accepts(jenv, inst, actions):
    try:
        jenv.check_solution_validity(inst, actions)
        return True
    except AssertionError:
        return False


def port_accepts(tenv, inst, actions):
    try:
        tenv.check_solution_validity(inst, actions)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("name", ["op", "pctsp", "spctsp"])
def test_validity_checks_accept_and_reject_as_jax(name):
    n = 6
    kw = {"max_length": 1.2} if name == "op" else {"prize_required": 0.5}
    tenv, jenv = both(name, n, **kw)
    inst = jax_instances(jenv, 6, 1)
    one = {k: v[0] for k, v in inst.items()}
    tours = [
        [1, 2, 0, 0, 0, 0, 0, 0],
        [3, 0, 0, 0, 0, 0, 0, 0],
        [1, 2, 3, 4, 5, 6, 0, 0],
        [6, 5, 4, 3, 2, 1, 0, 0],
        [1, 1, 0, 0, 0, 0, 0, 0],          # a repeated customer
        [2, 4, 6, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0],
    ]
    verdicts = []
    for tour in tours:
        acts = np.asarray(tour, dtype=np.int64)
        want = jax_accepts(jenv, one, acts)
        assert port_accepts(tenv, one, acts) == want, (name, tour)
        verdicts.append(want)
    assert not verdicts[4]
    assert any(verdicts) and not all(verdicts), verdicts  # both sides of the rule


@pytest.mark.parametrize("name,kw", ENVS, ids=IDS)
def test_port_generator_shapes_ranges_and_prizes(name, kw):
    n, b = 20, 64
    env = get_env(name, num_loc=n, **kw)
    gen = seeded_generator(torch.device("cpu"), 7)
    inst = {k: t2n(v) for k, v in env.generate(b, gen, device="cpu").items()}
    assert inst["locs"].shape == (b, n, 2) and inst["depot"].shape == (b, 2)
    assert (inst["locs"] >= 0).all() and (inst["locs"] < 1).all()
    again = env.generate(b, seeded_generator(torch.device("cpu"), 7), device="cpu")
    np.testing.assert_array_equal(t2n(again["locs"]), inst["locs"])
    jinst = jax_instances(jax_get_env(name, num_loc=n, **kw), 0, 2)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].dtype == np.float32 and inst[k].shape[1:] == jinst[k].shape[1:], k
    if name == "op":
        np.testing.assert_array_equal(inst["max_length"], np.full(b, 2.0, np.float32))
        prize = inst["prize"]
        if kw["prize_type"] == "const":
            np.testing.assert_array_equal(prize, 1.0)
        elif kw["prize_type"] == "unif":
            hundredths = np.round(prize * 100)
            np.testing.assert_allclose(prize, hundredths / 100, atol=1e-7)
            assert hundredths.min() >= 1 and hundredths.max() <= 100
        else:  # the JAX package's formula on these locations, in f32
            d = jnp.linalg.norm(jnp.asarray(inst["locs"]) - jnp.asarray(inst["depot"])[:, None],
                                axis=-1)
            want = (1.0 + jnp.floor(d / d.max(axis=-1, keepdims=True) * 99.0)) / 100.0
            np.testing.assert_array_equal(prize, np.asarray(want))
            assert (prize.max(axis=-1) == 1.0).all()
    else:
        assert (inst["penalty"] >= 0).all() and (inst["penalty"] < 2.0 * 3.0 / n).all()
        det, sto = inst["deterministic_prize"], inst["stochastic_prize"]
        assert (det >= 0).all() and (det < 4.0 / n).all()
        assert (sto >= 0).all() and (sto <= 2.0 * det).all()


def am_pair(env_name, seed=0):
    tree = random_params_numpy(seed, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"], env_name=env_name)
    jpol = JaxPolicy(env_name=env_name, **SMALL)
    tpol = AttentionModelPolicy(env_name=env_name, device="cpu", **SMALL)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


@pytest.mark.parametrize("name,kw,multistart", [
    ("op", {}, False), ("pctsp", {}, False), ("spctsp", {}, False), ("op", {}, True)],
    ids=["op", "pctsp", "spctsp", "op-multistart"])
def test_am_greedy_matches_jax(name, kw, multistart):
    n, b = 12, 6
    tenv, jenv = both(name, n, **kw)
    inst = jax_instances(jenv, 8, b)
    jpol, params, tpol = am_pair(name, seed=3)
    extra = dict(multistart=True, num_starts=n) if multistart else {}
    want = jax_rollout(jpol, params, jenv, to_jax(inst), jax.random.PRNGKey(0),
                       JaxSpec(kind="greedy", tanh_clipping=10.0, **extra))
    with torch.no_grad():
        got = rollout(tpol, tenv, inst, DecodeSpec(kind="greedy", tanh_clipping=10.0, **extra),
                      device="cpu")
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2n(got.log_likelihood), np.asarray(want.log_likelihood),
                               atol=1e-4)
    tenv.check_solution_validity(
        {k: np.concatenate([v] * (n if multistart else 1)) for k, v in inst.items()},
        t2n(got.actions))
