"""The port's MTVRP env and its embeddings against the JAX package's
(`rl4co_tpu/envs/routing/mtvrp.py`, `models/nn/env_embeddings/{init,context}.py`),
POMO and AM on it, and the golden files of this slice's chip phases.

- Every preset (the 16 fixed variants and the three mixtures) as one
  parametrised test: random feasible episodes on JAX-generated instances,
  every state field and mask exactly equal at each step (times, lengths and
  loads are the same f32 operations in the same order), rewards rtol 1e-6;
  the validity checks accept each trip in both packages.
- The validity checks refuse tampered tours as JAX's do.
- The port's generator: ranges, the windows' invariants, and the frequency
  of each feature per preset within five standard errors.
- Embeddings atol 1e-5 (plus 1e-6 of the largest value), f32 and bf16.
- AM greedy, POMO multistart greedy and JAX's sampled actions replayed:
  equal actions, rewards rtol 1e-5, log-likelihoods atol 1e-4.
- The golden files: shapes, and POMO at full width on the CPU on their first
  two instances: the JAX costs within 1e-5 relative, the replayed loss within
  1e-4 of it.

`python tests/test_torch_env_mtvrp.py` rewrites the golden files
(`rl4co_tpu_torch/golden/{routing_envs,pomo_mtvrp50,am_sdvrp50}_*.npz`) with
the JAX package on the CPU in f32 (a few minutes); no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs.routing.mtvrp import MTVRP as JaxMTVRP  # noqa: E402
from rl4co_tpu_torch.convert import (  # noqa: E402
    load_params,
    load_params_npz,
    random_params_numpy,
    save_params_npz,
)
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs.routing.mtvrp import (  # noqa: E402
    INF,
    MTVRP,
    VARIANT_PRESETS,
    get_vehicle_capacity,
    variant_name,
)
from rl4co_tpu_torch.models.zoo.pomo import POMO, make_pomo_policy  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402

from _torch_port import (  # noqa: E402
    am_pair,
    assert_rollouts_match,
    check_embeddings,
    env_pair,
    jax_instances,
    jax_sampled,
    port_rollout,
    rollout_pair,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
)
from test_torch_env_op_pctsp import random_episode  # noqa: E402

torch.set_num_threads(1)

N = 10
PRESETS = sorted(VARIANT_PRESETS)
FIXED = [p for p in PRESETS if p not in ("all", "single_feat", "single_feat_otw")]
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden")


class JittedMTVRP:
    """The JAX env's batched reset, mask and step, jitted once: MTVRP's MDP
    does not depend on the preset, which only the generator reads."""

    def __init__(self, n):
        env = JaxMTVRP(num_loc=n)
        self.reset_batch = jax.jit(env.reset_batch)
        self.action_mask_batch = jax.jit(env.action_mask_batch)
        self.step_batch = jax.jit(env.step_batch)
        self.reward_batch = jax.jit(env.reward_batch)


_JITTED = {}


def jitted(n):
    if n not in _JITTED:
        _JITTED[n] = JittedMTVRP(n)
    return _JITTED[n]


def preset_instances(preset, seed, b, n=N):
    return jax_instances(JaxMTVRP(num_loc=n, variant_preset=preset), seed, b)


@pytest.mark.parametrize("preset", PRESETS)
def test_random_feasible_episodes_match_step_by_step(preset):
    b = 8
    tenv, jenv = MTVRP(num_loc=N), jitted(N)
    inst = preset_instances(preset, PRESETS.index(preset), b)
    actions, ts, js = random_episode(np.random.RandomState(0), tenv, jenv, inst, depot_odds=0.2)
    assert t2n(ts.done).all()
    np.testing.assert_allclose(t2n(tenv.reward(ts, torch.from_numpy(actions))),
                               np.asarray(jenv.reward_batch(js, actions)), rtol=1e-6)
    trip = actions[:, : tenv.max_steps]
    ref = JaxMTVRP(num_loc=N)
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        ref.check_solution_validity(one, trip[row])
        tenv.check_solution_validity(one, trip[row])
    tenv.check_solution_validity(inst, trip)
    if preset in FIXED:  # the instance fields carry the preset's variant (B
        # reads as off on an instance that drew no backhaul customer)
        has_back = (inst["demand_backhaul"] > 0).any(-1)
        rows = has_back if "b" in preset.replace("vrp", "") else np.ones(b, bool)
        assert set(variant_name({k: v[rows] for k, v in inst.items()})) == {preset}


def verdict(env, inst, tour):
    try:
        env.check_solution_validity(inst, np.asarray(tour))
        return True
    except AssertionError:
        return False


def test_validity_checks_refuse_tampered_tours_as_jax():
    n, b = 6, 8
    tenv, ref = MTVRP(num_loc=n), JaxMTVRP(num_loc=n)
    inst = preset_instances("ovrpbltw", 3, b, n)
    actions, _, _ = random_episode(np.random.RandomState(3), tenv, jitted(n), inst)
    trips = actions[:, : tenv.max_steps]
    verdicts = set()
    for row in range(b):
        one = {k: v[row] for k, v in inst.items()}
        trip = trips[row]
        customers = np.flatnonzero(trip)
        tampered = [
            trip,
            np.where(trip == trip[customers[0]], trip[customers[1]], trip),  # a repeat
            np.concatenate([trip[customers], np.zeros(len(trip) - len(customers), int)]),
            trip[::-1].copy(),
        ]
        for tour in tampered:
            want = verdict(ref, one, tour)
            assert verdict(tenv, one, tour) == want, (row, tour)
            verdicts.add(want)
        # the limits themselves: a window closed, and no length left
        for key, value in (("time_windows", 0.0), ("distance_limit", 1e-3)):
            cut = {k: v.copy() for k, v in one.items()}
            if key == "time_windows":
                cut[key][trip[customers[-1]], 1] = value
            else:
                cut[key] = np.float32(value)
            want = verdict(ref, cut, trip)
            assert verdict(tenv, cut, trip) == want and not want, (row, key)
    assert verdicts == {True, False}


@pytest.mark.parametrize("preset", ["all", "single_feat", "single_feat_otw", "vrpbltw"])
def test_port_generator_ranges_and_feature_frequencies(preset):
    n, b = 20, 4096
    env = MTVRP(num_loc=n, variant_preset=preset)
    inst = {k: t2n(v) for k, v in
            env.generate(b, seeded_generator(torch.device("cpu"), 9), device="cpu").items()}
    jinst = preset_instances(preset, 0, 2, n)
    assert set(inst) == set(jinst)
    for k in inst:
        assert inst[k].shape[1:] == jinst[k].shape[1:] and inst[k].dtype == jinst[k].dtype, k
    locs = inst["locs"]
    assert (locs >= 0).all() and (locs < 1).all()
    cap = get_vehicle_capacity(n)
    line, back = inst["demand_linehaul"] * cap, inst["demand_backhaul"] * cap
    np.testing.assert_allclose(line, np.round(line), atol=1e-4)
    assert (line[:, 0] == 0).all() and (back[:, 0] == 0).all()
    assert line.max() <= 18.0 + 1e-4 and back.max() <= 9.0 + 1e-4  # folded: up to 9 + 9
    # which features are on, per instance
    o = inst["open_route"]
    tw = inst["time_windows"][:, 0, 1] < 1e17
    lim = inst["distance_limit"] < 1e17
    bh = back.sum(-1) > 0
    on = np.stack([o, tw, lim, bh], axis=-1).astype(float)
    np.testing.assert_array_equal(inst["distance_limit"][lim], 3.0)
    np.testing.assert_array_equal(inst["distance_limit"][~lim], np.float32(INF))
    np.testing.assert_array_equal(inst["service_time"][~tw], 0.0)
    # windows on: the service can start and still return by max_time
    d0 = np.linalg.norm(locs[:, 1:] - locs[:, :1], axis=-1)
    start, end = inst["time_windows"][:, 1:, 0], inst["time_windows"][:, 1:, 1]
    svc = inst["service_time"][:, 1:]
    assert (start[tw] >= d0[tw] - 1e-5).all()
    assert (end[tw] + svc[tw] + d0[tw] <= 4.6 + 1e-4).all()
    assert ((svc[tw] >= 0.15) & (svc[tw] < 0.18)).all()
    assert ((end - start)[tw] >= 0.18 - 1e-5).all() and ((end - start)[tw] < 0.2 + 1e-5).all()
    if preset == "all":
        want = np.full(4, 0.5)
    elif preset == "vrpbltw":
        want = np.array([0.0, 1.0, 1.0, 1.0])
    else:  # at most one feature (OTW: two at once); plain CVRP at weight 0.5
        weights = np.array(list(VARIANT_PRESETS[preset].values()) + [0.5])
        p = weights / weights.sum()
        want = p[:4] + (p[4] if preset == "single_feat_otw" else 0.0) * np.array([1, 1, 0, 0])
        assert (on.sum(-1) <= (2 if preset == "single_feat_otw" else 1)).all()
    want[3] *= 1 - 0.8 ** n  # B reads as on only where a customer drew a backhaul
    got = on.mean(axis=0)
    se = np.sqrt(np.maximum(want * (1 - want), 1e-12) / b)
    assert (np.abs(got - want) <= 5 * se + 1e-12).all(), (got, want)
    if bh.any():  # a fifth of the customers are backhauls where B is on
        share = (back[bh][:, 1:] > 0).mean()
        assert abs(share - 0.2) < 0.01, share


def test_embeddings_match_jax():
    tenv, jenv = MTVRP(num_loc=8), jitted(8)
    inst = preset_instances("all", 5, 8, 8)
    rs = np.random.RandomState(5)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    tstates, jstates = [ts], [js]
    for _ in range(6):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        tstates.append(ts)
        jstates.append(js)
    check_embeddings("mtvrp", inst, tstates, jstates)


def test_am_and_pomo_rollouts_match_jax():
    """AM greedy and JAX's sampled actions replayed; POMO multistart greedy
    over the customers (the grouped step under the 16 variants' masks)."""
    b = 6
    inst = preset_instances("all", 11, b)
    jpol, params, tpol = am_pair("mtvrp", seed=1)
    want, got = rollout_pair(jpol, params, tpol, "mtvrp", inst, kind="greedy",
                             tanh_clipping=10.0)
    assert_rollouts_match(want, got)
    sampled = jax_sampled(jpol, params, "mtvrp", inst, tanh_clipping=10.0)
    assert_rollouts_match(sampled, port_rollout(tpol, "mtvrp", inst, sampled.actions,
                                                kind="evaluate", tanh_clipping=10.0))
    jpol, params, tpol = am_pair("mtvrp", seed=2, pomo=True)
    want, got = rollout_pair(jpol, params, tpol, "mtvrp", inst, kind="greedy", multistart=True,
                             num_starts=N, tanh_clipping=10.0)
    assert_rollouts_match(want, got)
    MTVRP(num_loc=N).check_solution_validity(
        {k: np.concatenate([v] * N) for k, v in inst.items()}, t2n(got.actions))


def test_solve_dispatches_to_the_baselines():
    """``MTVRP.solve`` runs the greedy baseline by default (its tours pass the
    env's check), names an unknown solver, and reaches an external one that
    is absent as ImportError."""
    env = MTVRP(num_loc=5)
    inst = env.generate(3, torch.Generator().manual_seed(0), device="cpu")
    actions, cost = env.solve(inst, num_samples=2)
    assert cost.shape == (3,) and bool((cost > 0).all())
    env.check_solution_validity(inst, actions)
    with pytest.raises(ValueError, match="Unknown solver"):
        env.solve(inst, solver="nope")
    with pytest.raises(ImportError):
        env.solve(inst, solver="pyvrp")


# ------------------------------------------------------------- golden files

# the chip phases' configurations: AM (Kool et al.'s widths) on five routing
# envs at N 50, POMO (Kwon et al.'s) on MTVRP-50's "all" preset; the weights
# are `random_params_numpy(GOLDEN_SEED, ...)` of each, rebuilt on the card
GOLDEN_SEED = 0
ROUTING_ENVS = ("cvrptw", "sdvrp", "pdp", "mtsp", "shpp")
MULTISTART_ENVS = ("cvrptw", "sdvrp")    # CVRP's starts, customers 1..N
GOLDEN_N, GOLDEN_COUNT, MULTISTART_COUNT, POMO_DISPATCH = 50, 1024, 256, 512
SDVRP_REPLAY, POMO_REPLAY = 8, 2
POMO_ARCH = dict(num_encoder_layers=6, normalization="instance", use_graph_context=False)


def golden_file(name):
    return os.path.join(GOLDEN, name)


def load_golden(name):
    with np.load(golden_file(name)) as f:
        return {k: f[k] for k in f.files}


def by_prefix(flat, prefix):
    """``{"<prefix>/<key>": array}`` -> ``{key: array}``."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def test_golden_files_shapes():
    inst = load_golden("routing_envs_instances.npz")
    costs = load_golden("routing_envs_costs.npz")
    assert int(costs["seed"]) == GOLDEN_SEED
    for name in ROUTING_ENVS:
        got = by_prefix(inst, name)
        _, jenv = env_pair(name, GOLDEN_N)
        want = jax_instances(jenv, 0, 1)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].shape == (GOLDEN_COUNT,) + want[k].shape[1:], (name, k)
        assert costs[f"{name}/greedy"].shape == (GOLDEN_COUNT,)
        assert int(costs[f"{name}/greedy/dispatch"]) == GOLDEN_COUNT
        if name in MULTISTART_ENVS:
            assert costs[f"{name}/multistart_greedy"].shape == (MULTISTART_COUNT,)
            assert int(costs[f"{name}/multistart_greedy/dispatch"]) == MULTISTART_COUNT
    assert costs["sdvrp/replay/actions"].shape == (SDVRP_REPLAY, 3 * GOLDEN_N)
    grads = load_params_npz(golden_file("am_sdvrp50_grads.npz"))
    assert grads["dynamic_embedding"]["projection"]["kernel"].shape == (1, 384)
    pomo = load_golden("pomo_mtvrp50_instances.npz")
    pcosts = load_golden("pomo_mtvrp50_costs.npz")
    assert pomo["locs"].shape == (GOLDEN_COUNT, GOLDEN_N + 1, 2)
    assert pcosts["multistart_greedy"].shape == (GOLDEN_COUNT,)
    assert len(set(variant_name(pomo))) == 16
    assert pcosts["replay/actions"].shape == (GOLDEN_N * POMO_REPLAY, 2 * GOLDEN_N)


def test_golden_pomo_replays_two_instances_on_the_cpu():
    """Full width, the first two instances (instance norm: a cost does not
    depend on its dispatch): multistart greedy gives the JAX costs, and the
    loss on the replayed actions the JAX loss."""
    inst = {k: v[:POMO_REPLAY] for k, v in load_golden("pomo_mtvrp50_instances.npz").items()}
    costs = load_golden("pomo_mtvrp50_costs.npz")
    policy = load_params(make_pomo_policy("mtvrp", device="cpu"),
                         random_params_numpy(GOLDEN_SEED, env_name="mtvrp", **POMO_ARCH))
    env = MTVRP(num_loc=GOLDEN_N)
    out = port_rollout(policy, "mtvrp", inst, kind="greedy", multistart=True,
                       num_starts=GOLDEN_N, tanh_clipping=10.0)
    best = -t2n(out.reward).reshape(GOLDEN_N, POMO_REPLAY).max(axis=0)
    np.testing.assert_allclose(best, costs["multistart_greedy"][:POMO_REPLAY], rtol=1e-5)
    algo = POMO(env, policy=policy, train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    loss, _ = algo.loss(to_torch(inst), replay_actions=torch.from_numpy(costs["replay/actions"]))
    np.testing.assert_allclose(loss.item(), float(costs["replay/loss"]), rtol=1e-4)


def write_golden():
    """The golden files from the JAX package on the CPU in f32 (a few
    minutes): the routing envs' instances (`generate_batch` at keys 100 +
    i), AM's greedy costs on 1 024 in one dispatch and multistart greedy
    best-of-50 costs on the first 256 of CVRPTW and SDVRP (the encoder on
    the 256 in one pass, the decoding in chunks of 64, which decode
    independently), SDVRP's sampled actions on 8 instances with the
    REINFORCE loss against their mean reward and every gradient; MTVRP-50
    (preset ``all``, key 200) with POMO's multistart greedy best-of-50 costs
    on 1 024 in dispatches of 512, the greedy actions of the first two
    instances and POMO's loss and every gradient on them."""
    import time

    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
    from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
    from rl4co_tpu.models.policies.constructive import rollout_from_cache
    from rl4co_tpu.models.zoo.pomo import make_pomo_policy as jax_make_pomo_policy

    key = jax.random.PRNGKey(0)
    greedy = JaxSpec(kind="greedy", tanh_clipping=10.0)
    multistart = JaxSpec(kind="greedy", multistart=True, num_starts=GOLDEN_N, tanh_clipping=10.0)
    t0 = time.time()

    inst_out, cost_out = {}, {"seed": np.int64(GOLDEN_SEED)}
    for i, name in enumerate(ROUTING_ENVS):
        jenv = jax_get_env(name, num_loc=GOLDEN_N)
        inst = jax_instances(jenv, 100 + i, GOLDEN_COUNT)
        inst_out.update({f"{name}/{k}": v for k, v in inst.items()})
        jpol = JaxPolicy(env_name=name)
        params = tree_to_jax(random_params_numpy(GOLDEN_SEED, env_name=name))
        out = jax_rollout(jpol, params, jenv, to_jax(inst), key, greedy)
        cost_out[f"{name}/greedy"] = -np.asarray(out.reward)
        cost_out[f"{name}/greedy/dispatch"] = np.int64(GOLDEN_COUNT)
        print(name, "greedy", cost_out[f"{name}/greedy"].mean(), time.time() - t0, flush=True)
        if name in MULTISTART_ENVS:
            sub = to_jax({k: v[:MULTISTART_COUNT] for k, v in inst.items()})
            cache = jpol.apply(params, jpol.apply(params, sub, method="encode"),
                               method="precompute")
            best = []
            for lo in range(0, MULTISTART_COUNT, 64):
                part = jax.tree_util.tree_map(lambda x: x[lo:lo + 64], (sub, cache))
                r = rollout_from_cache(jpol, params, jenv, part[0], part[1], key,
                                       multistart).reward
                best.append(np.asarray(r).reshape(GOLDEN_N, -1).max(axis=0))
            cost_out[f"{name}/multistart_greedy"] = -np.concatenate(best)
            cost_out[f"{name}/multistart_greedy/dispatch"] = np.int64(MULTISTART_COUNT)
            print(name, "multistart", cost_out[f"{name}/multistart_greedy"].mean(),
                  time.time() - t0, flush=True)
        if name == "sdvrp":  # sampled tours, replayed with the loss and gradients
            few = to_jax({k: v[:SDVRP_REPLAY] for k, v in inst.items()})
            drawn = jax_rollout(jpol, params, jenv, few, jax.random.PRNGKey(7),
                                JaxSpec(kind="sampling", tanh_clipping=10.0))
            baseline = jnp.mean(drawn.reward)

            def loss_fn(p):
                out = jax_rollout(jpol, p, jenv, few, key,
                                  JaxSpec(kind="evaluate", tanh_clipping=10.0), drawn.actions)
                return -((out.reward - baseline) * out.log_likelihood).mean(), out

            (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            cost_out.update({"sdvrp/replay/actions": np.asarray(drawn.actions),
                             "sdvrp/replay/baseline": np.float32(baseline),
                             "sdvrp/replay/reward": np.asarray(out.reward),
                             "sdvrp/replay/log_likelihood": np.asarray(out.log_likelihood),
                             "sdvrp/replay/loss": np.float32(loss)})
            save_params_npz(tree_to_numpy(grads)["params"], golden_file("am_sdvrp50_grads.npz"))
            print("sdvrp replay loss", float(loss), time.time() - t0, flush=True)
    np.savez_compressed(golden_file("routing_envs_instances.npz"), **inst_out)
    np.savez_compressed(golden_file("routing_envs_costs.npz"), **cost_out)

    jenv = jax_get_env("mtvrp", num_loc=GOLDEN_N)
    inst = jax_instances(jenv, 200, GOLDEN_COUNT)
    jpol = jax_make_pomo_policy("mtvrp")
    params = tree_to_jax(random_params_numpy(GOLDEN_SEED, env_name="mtvrp", **POMO_ARCH))
    best, first = [], None
    for lo in range(0, GOLDEN_COUNT, POMO_DISPATCH):
        part = to_jax({k: v[lo:lo + POMO_DISPATCH] for k, v in inst.items()})
        out = jax_rollout(jpol, params, jenv, part, key, multistart)
        best.append(np.asarray(out.reward).reshape(GOLDEN_N, -1).max(axis=0))
        if first is None:  # repeat-major [S*B]: start s of instance b is row s*B + b
            acts = np.asarray(out.actions).reshape(GOLDEN_N, POMO_DISPATCH, -1)
            first = acts[:, :POMO_REPLAY].reshape(GOLDEN_N * POMO_REPLAY, -1)
        print("mtvrp pomo", lo, time.time() - t0, flush=True)
    few = to_jax({k: v[:POMO_REPLAY] for k, v in inst.items()})

    def pomo_loss(p):
        out = jax_rollout(jpol, p, jenv, few, key,
                          JaxSpec(kind="evaluate", multistart=True, num_starts=GOLDEN_N,
                                  tanh_clipping=10.0), jnp.asarray(first))
        r = out.reward.reshape(GOLDEN_N, POMO_REPLAY).T
        ll = out.log_likelihood.reshape(GOLDEN_N, POMO_REPLAY).T
        return -((r - r.mean(axis=-1, keepdims=True)) * ll).mean()

    loss, grads = jax.value_and_grad(pomo_loss)(params)
    np.savez_compressed(golden_file("pomo_mtvrp50_instances.npz"), **inst)
    np.savez_compressed(golden_file("pomo_mtvrp50_costs.npz"), seed=np.int64(GOLDEN_SEED),
                        multistart_greedy=-np.concatenate(best),
                        **{"multistart_greedy/dispatch": np.int64(POMO_DISPATCH),
                           "replay/actions": first, "replay/loss": np.float32(loss)})
    save_params_npz(tree_to_numpy(grads)["params"], golden_file("pomo_mtvrp50_grads.npz"))
    print("mtvrp pomo loss", float(loss), "done in", time.time() - t0, flush=True)


if __name__ == "__main__":
    write_golden()
