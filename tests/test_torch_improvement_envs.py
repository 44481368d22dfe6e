"""The port's improvement envs and their building blocks against the JAX
package's (`rl4co_tpu/envs/routing/{tsp_kopt,pdp_ruin_repair}.py`,
`rl4co_tpu/models/nn/{pos_embeddings,ops,attention}.py`, `utils/ops.py`).

The linked-list walks (`compute_visited_time`, `two_opt_move`, `k_opt_move`,
`ruin_repair_move`) and the masks are integer functions: they must equal the
JAX package's exactly, on random tours and random (also infeasible) actions.
Tour lengths: XLA's fused f32 square root is not correctly rounded in every
case (XLA fuses it differently at different N: at N 20 the costs share
their bits with the port's in 44 % of 2 000 tours, 4 ulps apart at most; at
N 10, 50 and 100 in 91-93 %, 2 ulps apart at most), so a cost is held at 4
ulps (rtol 4.8e-7); the sums follow XLA's CPU order (`utils.ops.xla_cpu_sum`). Where ``rec_best`` departs, the costs that
decided it must be a tie of at most a few ulps. The positional patterns
equal the JAX package's to the bit; `MLP`, `MultiHeadCompat` and a GRU cell
match Flax at atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from hypothesis import given, settings
from hypothesis import strategies as st

from rl4co_tpu.envs.routing import pdp_ruin_repair as jrr
from rl4co_tpu.envs.routing import tsp_kopt as jk
from rl4co_tpu.models.nn import pos_embeddings as jpos
from rl4co_tpu.models.nn.attention import MultiHeadCompat as JaxCompat
from rl4co_tpu.models.nn.ops import MLP as JaxMLP
from rl4co_tpu_torch.convert import load_params
from rl4co_tpu_torch.envs.routing import pdp_ruin_repair as trr
from rl4co_tpu_torch.envs.routing import tsp_kopt as tk
from rl4co_tpu_torch.models.nn import pos_embeddings as tpos
from rl4co_tpu_torch.models.nn.attention import MultiHeadCompat
from rl4co_tpu_torch.models.nn.ops import MLP
from rl4co_tpu_torch.utils.ops import inverse_permutation, mark_vector_set, scatter_permutation

from _torch_port import t2n, tree_to_numpy

torch.set_num_threads(1)

N = 12
COST_RTOL = 4.8e-7   # 4 ulps of f32
TIE_RTOL = 1e-6      # a departure of rec_best must be a tie this close

two_opt_jax = jax.jit(jax.vmap(jk.two_opt_move))
k_opt_jax = jax.jit(jax.vmap(jk.k_opt_move, in_axes=(0, 0, None)), static_argnums=2)
visited_jax = jax.jit(jax.vmap(jk.compute_visited_time))
ruin_jax = jax.jit(jax.vmap(jrr.ruin_repair_move))
cost_jax = jax.jit(jax.vmap(jk.linked_list_cost))


def random_recs(rs, b, n):
    """Random linked-list tours ``[B, N]`` (int32) from numpy."""
    recs = np.empty((b, n), np.int32)
    for i in range(b):
        perm = rs.permutation(n)
        recs[i, perm] = np.roll(perm, -1)
    return recs


def L(x):
    return torch.from_numpy(np.array(x)).long()


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_two_opt_visited_time_and_permutation_helpers_equal_jax(seed):
    rs = np.random.RandomState(seed % 2**31)
    rec = random_recs(rs, 6, N)
    first, second = rs.randint(0, N, 6), rs.randint(0, N, 6)
    want = np.asarray(two_opt_jax(jnp.asarray(rec), jnp.asarray(first), jnp.asarray(second)))
    got = tk.two_opt_move(L(rec), L(first), L(second))
    np.testing.assert_array_equal(t2n(got), want)
    np.testing.assert_array_equal(t2n(tk.compute_visited_time(L(rec))),
                                  np.asarray(visited_jax(jnp.asarray(rec))))
    np.testing.assert_array_equal(t2n(inverse_permutation(L(rec))), np.argsort(rec, axis=-1))
    vals = rs.randint(0, 100, (6, N))
    want_scatter = np.zeros_like(vals)
    for i in range(6):
        want_scatter[i, rec[i]] = vals[i]
    np.testing.assert_array_equal(t2n(scatter_permutation(L(rec), L(vals))), want_scatter)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), k_max=st.sampled_from([3, 4]))
def test_k_opt_move_and_mark_vector_set_equal_jax(seed, k_max):
    rs = np.random.RandomState(seed % 2**31)
    rec = random_recs(rs, 6, N)
    action = rs.randint(0, N, (6, 3 * k_max))   # any ids: the walk is defined for all
    want = np.asarray(k_opt_jax(jnp.asarray(rec), jnp.asarray(action), k_max))
    np.testing.assert_array_equal(t2n(tk.k_opt_move(L(rec), L(action), k_max)), want)
    idx, vals = rs.randint(0, N, (6, 4)), rs.randint(0, 50, (6, 4))
    from rl4co_tpu.utils.ops import mark_vector_set as jax_mark
    want = np.stack([np.asarray(jax_mark(jnp.asarray(rec[i]), jnp.asarray(idx[i]),
                                         jnp.asarray(vals[i]))) for i in range(6)])
    np.testing.assert_array_equal(t2n(mark_vector_set(L(rec), L(idx), L(vals))), want)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_ruin_repair_move_and_reinsertion_mask_equal_jax(seed):
    rs = np.random.RandomState(seed % 2**31)
    gs = N + 1
    rec = random_recs(rs, 6, gs)
    pair, first, second = rs.randint(1, gs // 2 + 1, 6), rs.randint(0, gs, 6), \
        rs.randint(0, gs, 6)
    want = np.asarray(ruin_jax(jnp.asarray(rec), jnp.asarray(pair), jnp.asarray(first),
                               jnp.asarray(second)))
    got = trr.ruin_repair_move(L(rec), L(pair), L(first), L(second))
    np.testing.assert_array_equal(t2n(got), want)
    vt = np.asarray(visited_jax(jnp.asarray(rec)))
    sel = rs.randint(1, gs // 2 + 1, 6)
    want = np.asarray(jax.vmap(jrr.reinsertion_mask)(jnp.asarray(vt), jnp.asarray(sel)))
    np.testing.assert_array_equal(t2n(trr.reinsertion_mask(L(vt), L(sel))), want)


@pytest.mark.parametrize("n", [10, 50, 100])
def test_linked_list_cost_is_the_jax_cost_within_four_ulps(n):
    rs = np.random.RandomState(n)
    locs = rs.random_sample((64, n, 2)).astype(np.float32)
    rec = random_recs(rs, 64, n)
    want = np.asarray(cost_jax(jnp.asarray(locs), jnp.asarray(rec)))
    got = t2n(tk.linked_list_cost(torch.from_numpy(locs), L(rec)))
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=0)
    # most are the same bits: the order of the sum is XLA's
    assert (got == want).mean() >= 0.75, (got == want).mean()


def jax_tsp_state(locs, rec):
    cost = cost_jax(locs, rec)
    return jk.TSPkoptState(locs=locs, rec_current=rec, rec_best=rec, cost_current=cost,
                           cost_bsf=cost, visited_time=visited_jax(rec),
                           i=jnp.zeros(rec.shape[0], jnp.int32))


def assert_states_agree(got, want, prev_cost_bsf):
    """Integer fields equal; costs within 4 ulps; a departure of rec_best only
    where the new cost ties the old best-so-far."""
    np.testing.assert_array_equal(t2n(got.rec_current), np.asarray(want.rec_current))
    np.testing.assert_array_equal(t2n(got.visited_time), np.asarray(want.visited_time))
    np.testing.assert_allclose(t2n(got.cost_current), np.asarray(want.cost_current),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(t2n(got.cost_bsf), np.asarray(want.cost_bsf), rtol=COST_RTOL)
    departed = (t2n(got.rec_best) != np.asarray(want.rec_best)).any(-1)
    for b in np.flatnonzero(departed):
        c, bsf = float(want.cost_current[b]), float(prev_cost_bsf[b])
        assert abs(c - bsf) <= TIE_RTOL * bsf, (b, c, bsf)


@pytest.mark.parametrize("k_max", [2, 4])
def test_tsp_kopt_episode_equals_jax(k_max):
    rs = np.random.RandomState(k_max)
    jenv, tenv = jk.TSPkopt(num_loc=N, k_max=k_max), tk.TSPkopt(num_loc=N, k_max=k_max)
    locs = rs.random_sample((8, N, 2)).astype(np.float32)
    rec = random_recs(rs, 8, N)
    jst = jax_tsp_state(jnp.asarray(locs), jnp.asarray(rec))
    tst = tenv.reset_from({"locs": torch.from_numpy(locs)}, L(rec))
    step = jax.jit(jenv.step_batch)
    for t in range(12):
        width = 2 if k_max == 2 else 3 * k_max
        action = rs.randint(0, N, (8, width))
        prev = np.asarray(jst.cost_bsf)
        jst, jr = step(jst, jnp.asarray(action))
        tst, tr = tenv.step(tst, L(action))
        assert_states_agree(tst, jst, prev)
        np.testing.assert_allclose(t2n(tr), np.asarray(jr), atol=2e-6)
        if k_max == 2:
            for b in range(8):
                tenv.check_solution_validity(None, t2n(tst.rec_current[b]))
    np.testing.assert_array_equal(t2n(tst.i), np.asarray(jst.i))
    np.testing.assert_array_equal(t2n(tenv.get_best_tour(tst)),
                                  np.asarray(jenv.get_best_tour(jst)))


def test_tsp_kopt_reset_draws_valid_tours_and_generate_refuses_without_a_card():
    env = tk.TSPkopt(num_loc=N)
    g = torch.Generator().manual_seed(0)
    inst = env.generate(4, g, "cpu")
    st_ = env.reset(inst, g)
    for b in range(4):
        env.check_solution_validity(None, t2n(st_.rec_current[b]))
    np.testing.assert_array_equal(t2n(st_.visited_time),
                                  np.asarray(visited_jax(jnp.asarray(t2n(st_.rec_current)))))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            env.generate(2)


def test_pdp_ruin_repair_episode_equals_jax():
    rs = np.random.RandomState(7)
    jenv, tenv = jrr.PDPRuinRepair(num_loc=N), trr.PDPRuinRepair(num_loc=N)
    inst = {"locs": rs.random_sample((6, N, 2)).astype(np.float32),
            "depot": rs.random_sample((6, 2)).astype(np.float32)}
    jst = jax.vmap(jenv.reset)(jax.tree_util.tree_map(jnp.asarray, inst),
                               jax.random.split(jax.random.PRNGKey(3), 6))
    tst = tenv.reset_from({k: torch.from_numpy(v) for k, v in inst.items()},
                          L(np.asarray(jst.rec_current)))
    np.testing.assert_allclose(t2n(tst.cost_bsf), np.asarray(jst.cost_bsf), rtol=COST_RTOL)
    step = jax.jit(jenv.step_batch)
    half = N // 2
    for t in range(10):
        # feasible moves: a pair, then positions that keep pickup before delivery
        vt = np.asarray(jst.visited_time)
        pair = rs.randint(0, half, 6)
        mask = np.asarray(jax.vmap(jrr.reinsertion_mask)(jnp.asarray(vt), jnp.asarray(pair + 1)))
        firsts, seconds = [], []
        for b in range(6):
            f, s = np.nonzero(mask[b])
            j = rs.randint(len(f))
            firsts.append(f[j]), seconds.append(s[j])
        action = np.stack([pair, firsts, seconds], axis=-1)
        prev = np.asarray(jst.cost_bsf)
        jst, jr = step(jst, jnp.asarray(action))
        tst, tr = tenv.step(tst, L(action))
        assert_states_agree(tst, jst, prev)
        np.testing.assert_array_equal(t2n(tst.action_record), np.asarray(jst.action_record))
        for b in range(6):
            tenv.check_solution_validity(None, t2n(tst.rec_current[b]))
    g = torch.Generator().manual_seed(1)
    st_ = tenv.reset(tenv.generate(3, g, "cpu"), g)
    for b in range(3):
        tenv.check_solution_validity(None, t2n(st_.rec_current[b]))


@pytest.mark.parametrize("pos_type", ["APE", "CPE"])
@pytest.mark.parametrize("n,d", [(13, 16), (50, 64), (51, 128)])
def test_positional_patterns_and_embeddings_are_the_jax_bits(pos_type, n, d):
    fn_t = {"APE": tpos.absolute_pattern, "CPE": tpos.cyclic_pattern}[pos_type]
    fn_j = {"APE": jpos.absolute_pattern, "CPE": jpos.cyclic_pattern}[pos_type]
    np.testing.assert_array_equal(fn_t(n, d), fn_j(n, d))
    rs = np.random.RandomState(n)
    vt = np.asarray(visited_jax(jnp.asarray(random_recs(rs, 3, n))))

    class S:
        visited_time = jnp.asarray(vt)

    want = jpos.pos_init_embedding(pos_type, d).apply({}, S)

    class T:
        visited_time = L(vt)

    got = tpos.pos_init_embedding(pos_type, d)(T)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_mlp_compat_and_gru_cell_match_flax():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((3, 7, 12)).astype(np.float32)
    jm = JaxMLP(5, (16, 8))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = load_params(MLP(12, 5, (16, 8)), tree_to_numpy(p))
    np.testing.assert_allclose(t2n(tm(torch.from_numpy(x))), np.asarray(jm.apply(p, x)),
                               atol=1e-6)

    kv = rs.standard_normal((3, 5, 12)).astype(np.float32)
    jc = JaxCompat(12, 3)
    p = jc.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(kv))
    tc = load_params(MultiHeadCompat(12, 3), tree_to_numpy(p))
    want = np.asarray(jc.apply(p, x, kv))
    assert want.shape == (3, 3, 7, 5)
    np.testing.assert_allclose(t2n(tc(torch.from_numpy(x), torch.from_numpy(kv))), want,
                               atol=1e-6)
    np.testing.assert_allclose(t2n(tc(torch.from_numpy(x))), np.asarray(jc.apply(p, x)),
                               atol=1e-6)

    class Cell(fnn.Module):
        @fnn.compact
        def __call__(self, h, x):
            return fnn.GRUCell(12, name="rnn1")(h, x)[0]

    h, inp = rs.standard_normal((4, 12)).astype(np.float32), \
        rs.standard_normal((4, 12)).astype(np.float32)
    p = Cell().init(jax.random.PRNGKey(2), jnp.asarray(h), jnp.asarray(inp))
    cell = torch.nn.Module()
    cell.rnn1 = torch.nn.GRUCell(12, 12)
    load_params(cell, tree_to_numpy(p))
    np.testing.assert_allclose(t2n(cell.rnn1(torch.from_numpy(inp), torch.from_numpy(h))),
                               np.asarray(Cell().apply(p, h, inp)), atol=1e-6)
