"""The port's GLOP (`rl4co_tpu_torch/models/zoo/glop.py`) against the JAX
package's (`rl4co_tpu/models/zoo/glop.py`), with the JAX package's own draws
replayed: its construction orders, offsets and insertion orders, taken from
its keys as `GLOP.solve` / `improve` split them. Cheapest insertion into a
cycle and into an open path gives JAX's tours to the node; `GLOP.improve`
(N 100, segments of 10, 3 rounds) gives JAX's tours to the node, with the
insertion sub-solver alone and with a random-weight AM reviser on SHPP-10,
and lengths within 1e-5; the VRP adapter keeps every customer, never
worsens a cost, and keeps a solution its grid cannot hold, as the JAX
package's test (`tests/test_zoo_variants.py::test_glop_vrp_adapter`) asks.

`python tests/test_torch_glop.py` writes the golden file of the chip phase
`glop_tsp1000` (`rl4co_tpu_torch/golden/glop_tsp1000.npz`): the JAX package
on the CPU in f32, at `runs/glop_tsp1000.py`'s recipe (128 TSP-1000
instances in dispatches of 32, segments of 25, 24 rounds), the reviser AM on
SHPP-25 with `random_params_numpy(GOLDEN_SEED, env_name="shpp")` weights;
the per-instance costs of construction, insertion-only revision and reviser
revision, the reviser's orders of one round's segments, and the JAX draws
(about a minute).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.models.zoo import glop as jglop
from rl4co_tpu_torch.models.zoo import glop as tglop
from rl4co_tpu_torch.utils.ops import gather_by_index, get_tour_length

from _torch_port import SMALL, JaxPolicy, load_params, random_params_numpy, t2n, tree_to_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_FILE = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "glop_tsp1000.npz")


def jax_draws(key, b, n, seg_len, n_rounds, construction=True):
    """The draws of JAX `GLOP.solve(locs, key)` (``construction``) or of
    `GLOP.improve(locs, tours, key)`, by its own key schedule: construction
    orders ``[B, N]``, offsets ``[R, B]``, insertion orders ``[R, M, L-2]``."""
    out = {}
    if construction:
        k1, key = jax.random.split(key)
        keys = jax.random.split(k1, b)
        out["construction_orders"] = np.asarray(
            jax.vmap(lambda k: jax.random.permutation(k, n))(keys))
    m = b * n // seg_len
    koff = jax.random.fold_in(key, 7)
    offsets, orders = [], []
    for k in jax.random.split(key, n_rounds):
        offsets.append(np.asarray(jax.random.randint(koff, (b,), 0, n)))
        koff = jax.random.fold_in(koff, 1)
        k_ins, _ = jax.random.split(k)
        orders.append(np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, seg_len - 2) + 1)(
            jax.random.split(k_ins, m))))
    out["offsets"] = np.asarray(offsets, dtype=np.int64).reshape(n_rounds, b)
    out["insertion_orders"] = np.asarray(orders, dtype=np.int64).reshape(n_rounds, m,
                                                                        seg_len - 2)
    return out


def torch_draws(draws):
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64)) for k, v in draws.items()}


def random_locs(seed, b, n):
    return np.random.RandomState(seed).random_sample((b, n, 2)).astype(np.float32)


@pytest.mark.parametrize("n", [5, 20, 64])
def test_random_insertion_replays_jax(n):
    locs = random_locs(n, 6, n)
    keys = jax.random.split(jax.random.PRNGKey(n), 6)
    want = np.asarray(jax.vmap(jglop.random_insertion)(jnp.asarray(locs), keys))
    orders = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys))
    got = t2n(tglop.batched_random_insertion(torch.from_numpy(locs),
                                             torch.from_numpy(orders)))
    np.testing.assert_array_equal(got, want)
    one = t2n(tglop.random_insertion(torch.from_numpy(locs[0]), torch.from_numpy(orders[0])))
    np.testing.assert_array_equal(one, want[0])


@pytest.mark.parametrize("n", [3, 10, 25])
def test_random_insertion_path_replays_jax(n):
    locs = random_locs(100 + n, 6, n)
    keys = jax.random.split(jax.random.PRNGKey(n), 6)
    want = np.asarray(jax.vmap(jglop.random_insertion_path)(jnp.asarray(locs), keys))
    orders = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n - 2) + 1)(keys))
    got = t2n(tglop.batched_random_insertion_path(torch.from_numpy(locs),
                                                  torch.from_numpy(orders)))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all() and (got[:, -1] == n - 1).all()


def test_insertion_draws_its_own_permutations():
    locs = torch.from_numpy(random_locs(1, 4, 30))
    gen = torch.Generator().manual_seed(0)
    for tours in (tglop.batched_random_insertion(locs, generator=gen),
                  tglop.batched_random_insertion_path(locs, generator=gen)):
        np.testing.assert_array_equal(np.sort(t2n(tours), -1), np.tile(np.arange(30), (4, 1)))


def reviser_pair(seg_len, seed=3):
    """AM on SHPP at the tests' small width in both packages, the same weights."""
    from rl4co_tpu_torch.models import AttentionModelPolicy

    tree = random_params_numpy(seed, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"], env_name="shpp")
    jpol = JaxPolicy(env_name="shpp", **SMALL)
    tpol = load_params(AttentionModelPolicy(env_name="shpp", device="cpu", **SMALL),
                       tree).eval()
    return jpol, tree_to_jax(tree), tpol


@pytest.mark.parametrize("reviser", [False, True], ids=["insertion", "reviser"])
def test_improve_replays_jax(reviser):
    b, n, seg_len, rounds = 4, 100, 10, 3
    locs = random_locs(7, b, n)
    start = np.stack([np.random.RandomState(i).permutation(n) for i in range(b)])
    key = jax.random.PRNGKey(11)
    jpol = jparams = tpol = None
    if reviser:
        jpol, jparams, tpol = reviser_pair(seg_len)
    jg = jglop.GLOP(seg_len=seg_len, n_rounds=rounds, subsolver_policy=jpol,
                    subsolver_params=jparams)
    want_tours, want_len = jax.jit(jg.improve)(jnp.asarray(locs), jnp.asarray(start), key)
    tg = tglop.GLOP(seg_len=seg_len, n_rounds=rounds, subsolver_policy=tpol)
    draws = torch_draws(jax_draws(key, b, n, seg_len, rounds, construction=False))
    tours, lengths = tg.improve(torch.from_numpy(locs), torch.from_numpy(start), draws=draws)
    np.testing.assert_array_equal(t2n(tours), np.asarray(want_tours))
    np.testing.assert_allclose(t2n(lengths), np.asarray(want_len), rtol=1e-5)
    start_len = get_tour_length(gather_by_index(torch.from_numpy(locs),
                                                torch.from_numpy(start)))
    assert (t2n(lengths) < t2n(start_len)).all()


def test_solve_replays_jax_and_draws_its_own():
    b, n, seg_len, rounds = 3, 40, 10, 2
    locs = random_locs(9, b, n)
    key = jax.random.PRNGKey(5)
    jg = jglop.GLOP(seg_len=seg_len, n_rounds=rounds)
    want_tours, _ = jax.jit(jg.solve)(jnp.asarray(locs), key)
    tg = tglop.GLOP(seg_len=seg_len, n_rounds=rounds)
    tours, _ = tg.solve(torch.from_numpy(locs),
                        draws=torch_draws(jax_draws(key, b, n, seg_len, rounds)))
    np.testing.assert_array_equal(t2n(tours), np.asarray(want_tours))
    gen = torch.Generator().manual_seed(1)
    tours, lengths = tg.solve(torch.from_numpy(locs), generator=gen)
    np.testing.assert_array_equal(np.sort(t2n(tours), -1), np.tile(np.arange(n), (b, 1)))
    with pytest.raises(ValueError, match="must divide"):
        tglop.GLOP(seg_len=7).improve(torch.from_numpy(locs), tours)


def hand_made_cvrp():
    """Two instances of 6 customers: routes written by hand, in a bad order,
    and (instance 1) a route of one customer and trailing depot padding."""
    rs = np.random.RandomState(4)
    locs = rs.random_sample((2, 7, 2)).astype(np.float32)
    actions = np.array([[3, 1, 5, 0, 2, 6, 4, 0, 0],
                        [6, 2, 4, 1, 0, 5, 0, 3, 0]], dtype=np.int64)
    return locs, actions


def test_vrp_adapter_matches_jax_and_keeps_every_customer():
    locs, actions = hand_made_cvrp()
    jl, ja = jnp.asarray(locs), jnp.asarray(actions)
    base = np.asarray(jglop.vrp_route_cost(jl, ja))
    np.testing.assert_allclose(t2n(tglop.vrp_route_cost(torch.from_numpy(locs),
                                                        torch.from_numpy(actions))), base,
                               rtol=1e-6)
    for r, l in ((4, 5), (9, 6)):
        np.testing.assert_array_equal(
            t2n(tglop.partition_vrp_actions(torch.from_numpy(actions), r, l)),
            np.asarray(jglop.partition_vrp_actions(ja, r, l)))
    r, l = 4, 5
    adapter = tglop.GLOPVRPAdapter(max_routes=r, max_route_len=l, min_node_count=2)
    jadapter = jglop.GLOPVRPAdapter(max_routes=r, max_route_len=l, min_node_count=2)
    key = jax.random.PRNGKey(3)
    want, want_cost = jadapter.improve(jl, ja, key)
    # the adapter's insertion orders: `batched_random_insertion`'s, one per route
    keys = jax.random.split(key, 2 * r)
    order = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, l + 1))(keys))
    got, cost = adapter.improve(torch.from_numpy(locs), torch.from_numpy(actions),
                                order=torch.from_numpy(order))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    np.testing.assert_allclose(t2n(cost), np.asarray(want_cost), rtol=1e-6)
    assert (t2n(cost) <= base + 1e-6).all() and (t2n(cost) < base - 1e-3).any()
    for row in range(2):
        assert sorted(x for x in t2n(got)[row] if x > 0) == list(range(1, 7))
    # drawn orders keep every customer too
    got, cost = adapter.improve(torch.from_numpy(locs), torch.from_numpy(actions),
                                generator=torch.Generator().manual_seed(0))
    assert (t2n(cost) <= base + 1e-6).all()
    for row in range(2):
        assert sorted(x for x in t2n(got)[row] if x > 0) == list(range(1, 7))


def test_vrp_adapter_keeps_a_solution_its_grid_cannot_hold():
    locs, actions = hand_made_cvrp()
    small = tglop.GLOPVRPAdapter(max_routes=1, max_route_len=2, min_node_count=2)
    jsmall = jglop.GLOPVRPAdapter(max_routes=1, max_route_len=2, min_node_count=2)
    got, cost = small.improve(torch.from_numpy(locs), torch.from_numpy(actions),
                              generator=torch.Generator().manual_seed(0))
    want, want_cost = jsmall.improve(jnp.asarray(locs), jnp.asarray(actions),
                                     jax.random.PRNGKey(5))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    np.testing.assert_array_equal(t2n(got)[:, :actions.shape[1]], actions)
    np.testing.assert_allclose(t2n(cost), np.asarray(want_cost), rtol=1e-6)
    grid = t2n(tglop.partition_vrp_actions(torch.from_numpy(actions), 1, 2))
    assert grid.shape == (2, 1, 2) and (grid > 0).sum() == 4  # the rest in the dump slot


# ------------------------------------------------------------- golden file
GOLDEN_SEED, GOLDEN_N, GOLDEN_COUNT, GOLDEN_DISPATCH = 0, 1000, 128, 32
GOLDEN_SEG, GOLDEN_ROUNDS = 25, 24
GOLDEN_INSTANCE_SEED = 1234


def golden_instances():
    """The instances of the chip phase, from a numpy seed."""
    return random_locs(GOLDEN_INSTANCE_SEED, GOLDEN_COUNT, GOLDEN_N)


def golden_key(dispatch):
    """The JAX key of dispatch ``dispatch``: `runs/glop_tsp1000.py`'s."""
    return jax.random.fold_in(jax.random.PRNGKey(2), dispatch * GOLDEN_DISPATCH)


def test_golden_file_shapes_and_draws():
    with np.load(GOLDEN_FILE) as f:
        g = {k: f[k] for k in f.files}
    assert int(g["seed"]) == GOLDEN_SEED
    np.testing.assert_array_equal(g["locs_seed"], GOLDEN_INSTANCE_SEED)
    for name in ("construct", "insertion", "reviser"):
        assert g[f"{name}/cost"].shape == (GOLDEN_COUNT,) and np.isfinite(g[f"{name}/cost"]).all()
    assert g["reviser/cost"].mean() < g["construct/cost"].mean()
    d = GOLDEN_COUNT // GOLDEN_DISPATCH
    m = GOLDEN_DISPATCH * GOLDEN_N // GOLDEN_SEG
    assert g["construction_orders"].shape == (GOLDEN_COUNT, GOLDEN_N)
    assert g["construction_orders"].dtype == np.int16
    assert g["offsets"].shape == (d, GOLDEN_ROUNDS, GOLDEN_DISPATCH)
    assert g["insertion_orders"].shape == (d, GOLDEN_ROUNDS, m, GOLDEN_SEG - 2)
    assert g["insertion_orders"].dtype == np.int8
    assert g["reviser/orders_d0_r0"].shape == (m, GOLDEN_SEG)
    np.testing.assert_array_equal(np.sort(g["reviser/orders_d0_r0"], -1),
                                  np.tile(np.arange(GOLDEN_SEG), (m, 1)))
    np.testing.assert_array_equal(np.sort(g["construction_orders"][:2], -1),
                                  np.tile(np.arange(GOLDEN_N), (2, 1)))
    # the draws of the first dispatch are JAX's, from its keys
    want = jax_draws(golden_key(0), GOLDEN_DISPATCH, GOLDEN_N, GOLDEN_SEG, GOLDEN_ROUNDS)
    np.testing.assert_array_equal(g["construction_orders"][:GOLDEN_DISPATCH],
                                  want["construction_orders"])
    np.testing.assert_array_equal(g["offsets"][0], want["offsets"])
    np.testing.assert_array_equal(g["insertion_orders"][0], want["insertion_orders"])


def segments_of(locs, tours, offsets, seg_len=GOLDEN_SEG):
    """``[B·N/L, L, 2]`` segments of ``tours [B, N]`` rotated by ``offsets``,
    as a revision round cuts them (numpy)."""
    b, n, _ = locs.shape
    rolled = np.stack([np.roll(t, o) for t, o in zip(tours, offsets)])
    return np.take_along_axis(locs, rolled[..., None].repeat(2, -1), 1).reshape(-1, seg_len, 2)


def write_golden():
    import time

    locs = golden_instances()
    tree = random_params_numpy(GOLDEN_SEED, env_name="shpp")
    jpol = JaxPolicy(env_name="shpp")
    variants = {
        "construct": jglop.GLOP(seg_len=GOLDEN_SEG, n_rounds=0),
        "insertion": jglop.GLOP(seg_len=GOLDEN_SEG, n_rounds=GOLDEN_ROUNDS),
        "reviser": jglop.GLOP(seg_len=GOLDEN_SEG, n_rounds=GOLDEN_ROUNDS, subsolver_policy=jpol,
                              subsolver_params=tree_to_jax(tree)),
    }
    out = {"seed": np.int64(GOLDEN_SEED), "locs_seed": np.int64(GOLDEN_INSTANCE_SEED)}
    t0 = time.time()
    for name, g in variants.items():
        solve = jax.jit(g.solve)
        costs = []
        for s in range(0, GOLDEN_COUNT, GOLDEN_DISPATCH):
            tours, lengths = solve(jnp.asarray(locs[s:s + GOLDEN_DISPATCH]),
                                   golden_key(s // GOLDEN_DISPATCH))
            tours = np.asarray(tours)
            assert (np.sort(tours, -1) == np.arange(GOLDEN_N)).all()
            costs.append(np.asarray(lengths))
        out[f"{name}/cost"] = np.concatenate(costs)
        print(name, out[f"{name}/cost"].mean(), time.time() - t0, flush=True)
    draws = [jax_draws(golden_key(d), GOLDEN_DISPATCH, GOLDEN_N, GOLDEN_SEG, GOLDEN_ROUNDS)
             for d in range(GOLDEN_COUNT // GOLDEN_DISPATCH)]
    # the reviser's own orders on the first round's segments of dispatch 0,
    # whatever the acceptance makes of them
    k1, _ = jax.random.split(golden_key(0))
    locs0 = jnp.asarray(locs[:GOLDEN_DISPATCH])
    tours = jglop.batched_random_insertion(locs0, k1)
    seg_locs = segments_of(np.asarray(locs0), np.asarray(tours), draws[0]["offsets"][0])
    out["reviser/orders_d0_r0"] = np.asarray(variants["reviser"]._solve_segments(
        jnp.asarray(seg_locs), jax.random.PRNGKey(0))).astype(np.int8)
    out["construction_orders"] = np.concatenate(
        [d["construction_orders"] for d in draws]).astype(np.int16)
    out["offsets"] = np.stack([d["offsets"] for d in draws]).astype(np.int16)
    out["insertion_orders"] = np.stack([d["insertion_orders"] for d in draws]).astype(np.int8)
    np.savez_compressed(GOLDEN_FILE, **out)
    print("wrote", GOLDEN_FILE, os.path.getsize(GOLDEN_FILE), time.time() - t0)


if __name__ == "__main__":
    write_golden()
