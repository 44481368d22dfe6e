"""The port's public helpers against the JAX package's on the same inputs.

Inputs are made with numpy from a seed (N <= 20, batch <= 8):

- `utils/ops.py`: `get_distance`, `get_open_tour_length` and
  `calculate_entropy` (rows with ``-inf`` log-probabilities included) within
  rtol 1e-6 / atol 1e-6; `topk_mask` exactly, on inputs with ties.
- `MultiHeadCrossAttention` on weights carried across by `convert.py`, with
  and without a mask, within atol 1e-5; `RandomEncoding`'s shape, dtype,
  range and its draws' dependence on the generator alone.
- `Env.solve` raises `NotImplementedError` on TSP; `rollout_random` on TSP,
  CVRP and OP gives feasible actions whose replay through the JAX env gives
  the port's reward within atol 1e-5.
- The named positional embeddings and `POS_EMBEDDING_REGISTRY` give the JAX
  package's tables; SVRP's context module is `SVRPContext`.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_port import t2n, tree_to_jax  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models.nn import pos_embeddings as jpos  # noqa: E402
from rl4co_tpu.models.nn.attention import MultiHeadCrossAttention as JaxCross  # noqa: E402
from rl4co_tpu.utils import ops as jops  # noqa: E402
from rl4co_tpu_torch.convert import load_params  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models.nn import pos_embeddings as tpos  # noqa: E402
from rl4co_tpu_torch.models.nn.attention import MultiHeadCrossAttention  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.context import (  # noqa: E402
    CONTEXT_EMBEDDING_REGISTRY,
    SVRPContext,
)
from rl4co_tpu_torch.models.nn.ops import RandomEncoding  # noqa: E402
from rl4co_tpu_torch.utils import ops as tops  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy


def test_get_distance_and_open_tour_length():
    rs = np.random.RandomState(0)
    a, b = rs.random_sample((2, 8, 20, 2)).astype(np.float32)
    np.testing.assert_allclose(t2n(tops.get_distance(T(a), T(b))),
                               np.asarray(jops.get_distance(a, b)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(tops.get_open_tour_length(T(a))),
                               np.asarray(jops.get_open_tour_length(a)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(tops.get_open_tour_length(T(a[0]))),
                               np.asarray(jops.get_open_tour_length(a[0])), rtol=1e-6, atol=1e-6)


def test_calculate_entropy_counts_zero_probabilities_as_zero():
    rs = np.random.RandomState(1)
    logits = rs.standard_normal((8, 20)).astype(np.float32)
    logits[:4, ::3] = -np.inf        # masked actions
    logits[5, 1:] = -np.inf          # one feasible action: entropy 0
    logprobs = np.array(jax.nn.log_softmax(logits, axis=-1))
    got = t2n(tops.calculate_entropy(T(logprobs)))
    want = np.asarray(jops.calculate_entropy(logprobs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[5] == 0.0


@pytest.mark.parametrize("k", [1, 3, 7])
def test_topk_mask_keeps_ties(k):
    rs = np.random.RandomState(k)
    scores = rs.randint(0, 5, size=(8, 20)).astype(np.float32)   # many ties
    got = t2n(tops.topk_mask(T(scores), k))
    np.testing.assert_array_equal(got, np.asarray(jops.topk_mask(scores, k)))
    assert (got.sum(-1) >= k).all()


def test_utils_package_reexports():
    import rl4co_tpu_torch.utils as u

    assert u.get_distance is tops.get_distance and u.calculate_entropy is tops.calculate_entropy


def _cross_tree(rs, d, use_bias):
    def dense(fan_out):
        out = {"kernel": (rs.standard_normal((d, fan_out)) / np.sqrt(d)).astype(np.float32)}
        if use_bias:
            out["bias"] = (0.1 * rs.standard_normal(fan_out)).astype(np.float32)
        return out

    return {"Wq": dense(d), "Wkv": dense(2 * d), "out_proj": dense(d)}


@pytest.mark.parametrize("mask_kind", [None, "keys", "full"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_cross_attention_matches_jax(mask_kind, use_bias):
    rs = np.random.RandomState(2)
    b, lq, s, d, h = 4, 6, 10, 32, 4
    tree = _cross_tree(rs, d, use_bias)
    q_in = rs.standard_normal((b, lq, d)).astype(np.float32)
    kv_in = rs.standard_normal((b, s, d)).astype(np.float32)
    mask = None
    if mask_kind == "keys":
        mask = rs.random_sample((b, s)) < 0.7
        mask[:, 0] = True
    elif mask_kind == "full":
        mask = rs.random_sample((b, 1, lq, s)) < 0.7
        mask[..., 0] = True
    want = JaxCross(embed_dim=d, num_heads=h, use_bias=use_bias).apply(
        tree_to_jax(tree), q_in, kv_in, None if mask is None else jnp.asarray(mask))
    module = load_params(MultiHeadCrossAttention(d, h, use_bias=use_bias), tree)
    got = module(T(q_in), T(kv_in), None if mask is None else T(mask))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=1e-5)


def test_random_encoding_draws_from_its_generator():
    x = torch.zeros(3, 7, 2)
    enc = RandomEncoding(16)

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return enc(x, g)

    out = draw(0)
    assert out.shape == (3, 7, 16) and out.dtype == torch.float32
    assert (out >= 0).all() and (out < 1).all()
    assert torch.equal(out, draw(0)) and not torch.equal(out, draw(1))
    assert enc(x.double(), None).dtype == torch.float64


def test_solve_raises_without_a_classical_solver():
    with pytest.raises(NotImplementedError, match="tsp"):
        get_env("tsp", num_loc=10).solve({}, max_runtime=1.0)


@pytest.mark.parametrize("name", ["tsp", "cvrp", "op"])
def test_rollout_random_is_feasible_and_rewarded_as_in_jax(name):
    env = get_env(name, num_loc=10)
    g = torch.Generator()
    g.manual_seed(3)
    instances, state, actions, reward = env.rollout_random(4, g, device="cpu")
    assert actions.shape == (4, env.max_steps)
    assert bool(state.done.all())
    env.check_solution_validity({k: t2n(v) for k, v in instances.items()}, t2n(actions))

    jenv = jax_get_env(name, num_loc=10)
    jstate = jenv.reset_batch({k: jnp.asarray(t2n(v)) for k, v in instances.items()})
    jactions = jnp.asarray(t2n(actions).astype(np.int32))
    for t in range(env.max_steps):
        assert np.asarray(jenv.action_mask_batch(jstate))[np.arange(4), t2n(actions[:, t])].all()
        jstate = jenv.step_batch(jstate, jactions[:, t])
    want = np.asarray(jenv.reward_batch(jstate, jactions))
    np.testing.assert_allclose(t2n(reward), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos_type", ["APE", "CPE"])
def test_named_positional_embeddings_give_the_jax_tables(pos_type):
    n, d = 13, 16
    vt = np.stack([np.random.RandomState(s).permutation(n) for s in range(3)])

    class JState:
        visited_time = jnp.asarray(vt)

    class TState:
        visited_time = T(vt)

    jcls, tcls = jpos.POS_EMBEDDING_REGISTRY[pos_type], tpos.POS_EMBEDDING_REGISTRY[pos_type]
    assert tcls.__name__ == jcls.__name__
    want = np.asarray(jcls(embed_dim=d).apply({}, JState))
    np.testing.assert_array_equal(t2n(tcls(d)(TState)), want)
    np.testing.assert_array_equal(t2n(tpos.pos_init_embedding(pos_type, d)(TState)), want)
    np.testing.assert_array_equal(t2n(tpos.PositionalEmbedding(pos_type, d)(TState)), want)


def test_svrp_context_is_registered_under_its_jax_name():
    assert CONTEXT_EMBEDDING_REGISTRY["svrp"] is SVRPContext
