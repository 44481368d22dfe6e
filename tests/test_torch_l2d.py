"""L2D in the port against the JAX package (`rl4co_tpu/models/zoo/l2d.py`,
`PositionalEncoding`, `JSSPDynamicEmbedding`).

- `HetGNNLayer`, `PositionalEncoding` and `JSSPDynamicEmbedding` on
  numpy-seeded weights and real FJSP/JSSP states: atol and rtol 1e-5.
- `L2DPolicy` (logits and the critic's value) on the states of an episode;
  its trees, with and without the critic, and `L2DAttnPolicy`'s have the
  JAX modules' structure.
- Greedy rollouts of both policies: actions equal, makespans equal.
- `L2DModel`'s loss on JAX's sampled actions replayed: within 1e-5 of its
  terms' scale, every gradient within 1e-4 of the largest; `L2DAttnModel`'s
  within 2e-4 and 2e-3, its f32 floor (its encoder's batch norms meet equal
  machine rows at reset: the port in f64 lies 7e-4 from either f32 encoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.nn.env_embeddings.dynamic import JSSPDynamicEmbedding as JaxDyn
from rl4co_tpu.models.nn.ops import PositionalEncoding as JaxPE
from rl4co_tpu.models.zoo.l2d import HetGNNLayer as JaxHet
from rl4co_tpu.models.zoo.l2d import L2DAttnPolicy as JaxAttn
from rl4co_tpu.models.zoo.l2d import L2DPolicy as JaxL2D
from rl4co_tpu.models.zoo.l2d import l2d_attn_rollout as jax_attn_rollout
from rl4co_tpu.models.zoo.l2d import l2d_rollout as jax_l2d_rollout
from rl4co_tpu_torch.convert import convert_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import JSSPDynamicEmbedding
from rl4co_tpu_torch.models.nn.ops import PositionalEncoding
from rl4co_tpu_torch.models.zoo.l2d import (
    HetGNNLayer,
    L2DAttnModel,
    L2DAttnPolicy,
    L2DModel,
    L2DPolicy,
    l2d_attn_rollout,
    l2d_rollout,
)

from _torch_port import (
    KEY,
    assert_gradients_close,
    assert_loss_close,
    jax_instances,
    reinforce_terms_scale,
    t2n,
    to_jax,
    to_torch,
    zoo_tree_pair,
)

torch.set_num_threads(1)

FJSP = dict(num_jobs=4, num_mas=3)
JSSP = dict(num_jobs=4, num_mas=3)
L2D_SMALL = dict(embed_dim=16, num_encoder_layers=2, actor_hidden_dim=16)
ATTN_SMALL = dict(embed_dim=16, num_heads=2, num_encoder_layers=2)
B = 4


def states(name, seed, steps=3):
    """(port states, JAX states) of a random episode's first ``steps`` steps."""
    kw = FJSP if name == "fjsp" else JSSP
    tenv, jenv = get_env(name, **kw), jax_get_env(name, **kw)
    inst = jax_instances(jenv, seed, B)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    rs = np.random.RandomState(seed)
    out = [(ts, js)]
    for _ in range(steps):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, jnp.asarray(act))
        out.append((ts, js))
    return tenv, jenv, out


def test_het_gnn_positional_encoding_and_dynamic_embedding_match_jax():
    rs = np.random.RandomState(0)
    ops, ma = rs.standard_normal((B, 12, 16)), rs.standard_normal((B, 3, 16))
    ops, ma = ops.astype(np.float32), ma.astype(np.float32)
    adj = (rs.random_sample((B, 3, 12)) < 0.5).astype(np.float32)
    sub = random_params_numpy(0, policy="l2d", policy_kwargs=L2D_SMALL)["layer_0"]
    layer = HetGNNLayer(16)
    layer.load_state_dict(convert_params(sub))
    want = JaxHet(16).apply({"params": sub}, ops, ma, adj)
    got = layer(*map(torch.from_numpy, (ops, ma, adj)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5, rtol=1e-5)
    pos = rs.randint(0, 12, size=(B, 12))
    for positions in (None, pos):
        want = JaxPE(16).apply({}, ops, positions)
        got = PositionalEncoding(16)(torch.from_numpy(ops),
                                     None if positions is None else torch.from_numpy(pos))
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    sub = random_params_numpy(1, policy="l2d_attn", policy_kwargs=ATTN_SMALL)["dynamic_embedding"]
    dyn = JSSPDynamicEmbedding(16, 1000.0)
    dyn.load_state_dict(convert_params(sub))
    tenv, jenv, pairs = states("jssp", 1)
    for ts, js in pairs:
        lbs, ready = tenv.calc_lower_bound(ts), tenv.op_is_ready(ts)
        want = JaxDyn(16, 1000.0).apply({"params": sub}, js, jnp.asarray(ma),
                                        jnp.asarray(t2n(lbs)), jnp.asarray(t2n(ready)))
        got = dyn(ts, torch.from_numpy(ma), lbs, ready)
        for g, w in zip(got, want):
            np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("critic", [False, True])
def test_l2d_policy_trees_and_outputs_match_jax(critic):
    kw = {**L2D_SMALL, "with_critic": critic}
    jpol, jparams, tpol = zoo_tree_pair("l2d", JaxL2D, L2DPolicy, 2, **kw)
    tenv, jenv, pairs = states("fjsp", 2)
    shapes = jax.eval_shape(jpol.init, KEY, pairs[0][1])
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jparams)
    for ts, js in pairs:
        want_l, want_v = jpol.apply(jparams, js)
        with torch.no_grad():
            got_l, got_v = tpol(ts)
        np.testing.assert_allclose(t2n(got_l), np.asarray(want_l), atol=1e-5, rtol=1e-5)
        if critic:
            np.testing.assert_allclose(t2n(got_v), np.asarray(want_v), atol=1e-5, rtol=1e-5)
        else:
            assert got_v is None and want_v is None


def test_attention_policy_tree_has_the_jax_structure():
    jpol, jparams, _ = zoo_tree_pair("l2d_attn", JaxAttn, L2DAttnPolicy, 3, **ATTN_SMALL)
    tenv, jenv, pairs = states("jssp", 3, steps=0)
    js = pairs[0][1]
    shapes = jax.eval_shape(jpol.init, KEY, js, jax.vmap(jenv.calc_lower_bound)(js),
                            jax.vmap(jenv.op_is_ready)(js))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jparams)


@pytest.mark.parametrize("name", ["fjsp", "jssp"])
def test_greedy_rollouts_of_both_policies_match_jax(name):
    kw = FJSP if name == "fjsp" else JSSP
    tenv, jenv = get_env(name, **kw), jax_get_env(name, **kw)
    inst = jax_instances(jenv, 4, B)
    if name == "fjsp":
        jpol, jparams, tpol = zoo_tree_pair("l2d", JaxL2D, L2DPolicy, 4, **L2D_SMALL)
        jfn, tfn = jax_l2d_rollout, l2d_rollout
    else:
        jpol, jparams, tpol = zoo_tree_pair("l2d_attn", JaxAttn, L2DAttnPolicy, 4,
                                            **ATTN_SMALL)
        jfn, tfn = jax_attn_rollout, l2d_attn_rollout
    want = jax.jit(lambda p, i: jfn(jpol, p, jenv, i, KEY, JaxSpec(kind="greedy")))(
        jparams, to_jax(inst))
    with torch.no_grad():
        got = tfn(tpol, tenv, to_torch(inst), DecodeSpec(kind="greedy"))
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    np.testing.assert_array_equal(t2n(got.reward), np.asarray(want.reward))


@pytest.mark.parametrize("name", ["l2d", "l2d_attn"])
def test_model_loss_and_every_gradient_on_replayed_actions_match_jax(name):
    env_name, kw = ("fjsp", FJSP) if name == "l2d" else ("jssp", JSSP)
    tenv, jenv = get_env(env_name, **kw), jax_get_env(env_name, **kw)
    jcls, tcls, model, dims, jfn = (
        (JaxL2D, L2DPolicy, L2DModel, L2D_SMALL, jax_l2d_rollout) if name == "l2d" else
        (JaxAttn, L2DAttnPolicy, L2DAttnModel, ATTN_SMALL, jax_attn_rollout))
    jpol, jparams, tpol = zoo_tree_pair(name, jcls, tcls, 5, **dims)
    inst = jax_instances(jenv, 5, B)
    spec = JaxSpec(kind="sampling")

    def loss_fn(params):  # `L2DModel.make_train_step`'s loss
        out = jfn(jpol, params, jenv, to_jax(inst), KEY, spec)
        adv = out.reward - out.reward.mean()
        return -(adv * out.log_likelihood).mean(), out

    (jloss, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    algo = model(tenv, tpol.train().requires_grad_(True))
    tloss, metrics = algo.loss(to_torch(inst), replay_actions=np.asarray(jout.actions))
    # the attention variant's f32 floor: its machines start as equal rows
    # (nothing is busy at reset), and the batch norms over them divide f32
    # noise by a vanishing spread; the port in f64 lies 7e-4 from either f32
    # encoder, JAX's and its own, which lie 4e-4 apart
    loss_rtol, gauge = (1e-5, 1e-4) if name == "l2d" else (2e-4, 2e-3)
    assert_loss_close(tloss.item(), jloss, reinforce_terms_scale(jout.reward,
                                                                 jout.log_likelihood),
                      rtol=loss_rtol)
    np.testing.assert_array_equal(metrics["reward"].item(), np.asarray(jout.reward).mean())
    tloss.backward()
    assert_gradients_close(tpol, jgrads, gauge=gauge)
