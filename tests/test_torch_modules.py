"""Each module of the port against its Flax module, with the Flax module's
parameters (re-drawn from numpy so that biases and scales are not trivial)
carried across by `convert_params`. Tolerance atol 1e-5, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.nn import attention as jatt
from rl4co_tpu.models.nn import ops as jops
from rl4co_tpu.models.nn.env_embeddings.context import TSPContext as JaxTSPContext
from rl4co_tpu.models.nn.env_embeddings.init import TSPInitEmbedding as JaxTSPInit
from rl4co_tpu.models.nn.graph.attnnet import GraphAttentionNetwork as JaxGAT
from rl4co_tpu_torch.convert import convert_params
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.nn import attention as tatt
from rl4co_tpu_torch.models.nn import ops as tops
from rl4co_tpu_torch.models.nn.env_embeddings import (
    CONTEXT_EMBEDDING_REGISTRY,
    INIT_EMBEDDING_REGISTRY,
    env_context_embedding,
)
from rl4co_tpu_torch.models.nn.env_embeddings.context import TSPContext
from rl4co_tpu_torch.models.nn.env_embeddings.init import TSPInitEmbedding
from rl4co_tpu_torch.models.nn.graph.attnnet import GraphAttentionNetwork

from _torch_port import random_locs, t2n, tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-5
D, H = 32, 4


def flax_params(module, seed, *args, **kwargs):
    """Initialise the Flax module, then re-draw every leaf from numpy."""
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    params = tree_to_numpy(variables).get("params", {})  # "layer" has none
    rs = np.random.RandomState(seed)

    def draw(a):
        # matrices at the scale of a trained layer (1/sqrt(fan_in)), so that
        # outputs are O(1) and the absolute tolerance means what it says
        scale = a.shape[0] ** -0.5 if a.ndim == 2 else 0.5
        return (scale * rs.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


def carry(tmodule, params):
    tmodule.load_state_dict(convert_params(params), strict=True)
    return tmodule.eval()


def x_input(seed=0, b=5, n=9, d=D):
    return np.random.RandomState(seed).standard_normal((b, n, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["batch", "instance", "layer", "rms"])
def test_normalization(kind):
    x = x_input()
    jmod = jops.Normalization(kind)
    params = flax_params(jmod, 1, jnp.asarray(x))
    tmod = carry(tops.Normalization(D, kind), params)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


def test_batch_normalization_uses_the_statistics_of_the_batch_at_hand():
    x = x_input(b=6)
    tmod = tops.Normalization(D, "batch").eval()  # eval mode changes nothing
    with torch.no_grad():
        whole = tmod(torch.from_numpy(x))[:3]
        part = tmod(torch.from_numpy(x[:3]))
    assert not torch.allclose(whole, part, atol=1e-3)
    jmod = jops.Normalization("batch")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_allclose(
        t2n(part), np.asarray(jmod.apply(params, jnp.asarray(x[:3]))), atol=ATOL)


def test_normalization_refuses_unknown_kind():
    with pytest.raises(ValueError):
        tops.Normalization(D, "group")


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    x = x_input(2)
    mask = None
    if masked:
        mask = np.random.RandomState(3).random_sample(x.shape[:2]) < 0.7
        mask[:, 0] = True
    jmod = jatt.MultiHeadAttention(D, H)
    params = flax_params(jmod, 4, jnp.asarray(x))
    tmod = carry(tatt.MultiHeadAttention(D, H), params)
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


def test_scaled_dot_product_attention_and_head_layout():
    rs = np.random.RandomState(5)
    q, k, v = (rs.standard_normal((2, H, 6, 8)).astype(np.float32) for _ in range(3))
    mask = rs.random_sample((2, 1, 6, 6)) < 0.6
    mask[..., 0] = True
    ref = jatt.scaled_dot_product_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask))
    out = tatt.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                            torch.from_numpy(mask))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)
    x = x_input(6)
    split = tatt._split_heads(torch.from_numpy(x), H)
    np.testing.assert_array_equal(t2n(split), np.asarray(jatt._split_heads(jnp.asarray(x), H)))
    np.testing.assert_array_equal(t2n(tatt._merge_heads(split)), x)


@pytest.mark.parametrize("hidden", [64, 48])
def test_transformer_ffn(hidden):
    x = x_input(7)
    jmod = jops.TransformerFFN(D, hidden)
    params = flax_params(jmod, 8, jnp.asarray(x))
    tmod = tops.TransformerFFN(D, hidden)
    state = convert_params(params)
    tmod.load_state_dict(state, strict=True)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_graph_attention_network(norm):
    x = x_input(9)
    jmod = JaxGAT(D, H, num_layers=2, normalization=norm, feedforward_hidden=64)
    params = flax_params(jmod, 10, jnp.asarray(x))
    tmod = carry(GraphAttentionNetwork(D, H, num_layers=2, normalization=norm,
                                       feedforward_hidden=64), params)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=5e-5)


def test_tsp_init_embedding():
    locs = random_locs(0, 4, 7)
    jmod = JaxTSPInit(D)
    params = flax_params(jmod, 11, {"locs": jnp.asarray(locs)})
    tmod = carry(TSPInitEmbedding(D), params)
    ref = jmod.apply({"params": params}, {"locs": jnp.asarray(locs)})
    with torch.no_grad():
        out = tmod({"locs": torch.from_numpy(locs)})
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_tsp_context_at_first_and_later_steps(steps):
    b, n = 4, 7
    locs = random_locs(1, b, n)
    emb = x_input(12, b, n)
    rs = np.random.RandomState(13)
    perms = np.stack([rs.permutation(n) for _ in range(b)])
    tenv, jenv = get_env("tsp", num_loc=n), jax_get_env("tsp", num_loc=n)
    ts = tenv.reset({"locs": torch.from_numpy(locs)})
    js = jenv.reset_batch({"locs": jnp.asarray(locs)})
    for t in range(steps):
        ts = tenv.step(ts, torch.from_numpy(perms[:, t]))
        js = jenv.step_batch(js, jnp.asarray(perms[:, t], dtype=jnp.int32))
    jmod = JaxTSPContext(D)
    params = flax_params(jmod, 14, jnp.asarray(emb), js)
    tmod = carry(TSPContext(D), params)
    ref = jmod.apply({"params": params}, jnp.asarray(emb), js)
    with torch.no_grad():
        out = tmod(torch.from_numpy(emb), ts)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), atol=ATOL)
    if steps == 0:  # the placeholder is the stored parameter minus one
        want = (params["W_placeholder"] - 1.0) @ params["project_context"]["kernel"]
        np.testing.assert_allclose(t2n(out)[0], want, atol=ATOL)


def test_embedding_registries_hold_tsp_only():
    # the ported envs' embeddings (TSP; CVRP since the POMO slice; OP, PCTSP
    # and SPCTSP since the mixed-env slice; CVRPTW, SDVRP, PDP, mTSP, SHPP
    # and MTVRP since the multi-task VRP slice; CVRPMVC, SVRP, mPDP and MDCPDP
    # since the GLOP slice; SMTWTP, DPP, MDPP, FLP and MCP since the PPO
    # slice; ATSP's MatNet init embedding since the zoo's slice, as in the JAX
    # registry, whose ATSP has no context embedding; the name dates from when
    # TSP was the only one); the rest raise
    ported = ["cvrp", "cvrpmvc", "cvrptw", "dpp", "flp", "mcp", "mdcpdp", "mdpp", "mpdp",
              "mtsp", "mtvrp", "op", "pctsp", "pdp", "sdvrp", "shpp", "smtwtp", "spctsp",
              "svrp", "tsp"]
    assert sorted(INIT_EMBEDDING_REGISTRY) == sorted(ported + ["atsp"])
    assert sorted(CONTEXT_EMBEDDING_REGISTRY) == ported
    with pytest.raises(NotImplementedError):
        env_context_embedding("atsp", D)


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
@pytest.mark.parametrize("timpl,jimpl", [("kernel", "pallas"), ("plain", "xla"),
                                         ("kernel", "xla")])
def test_pointer_attention(grouped, timpl, jimpl):
    b, n, l = 3, 10, 5
    rs = np.random.RandomState(15)
    q = rs.standard_normal((b, l, D) if grouped else (b, D)).astype(np.float32)
    gk, gv, lk = (rs.standard_normal((b, n, D)).astype(np.float32) for _ in range(3))
    mask = rs.random_sample((b, l, n) if grouped else (b, n)) < 0.6
    mask[..., 0] = True
    jmod = jatt.PointerAttention(D, H, impl=jimpl)
    jargs = tuple(map(jnp.asarray, (q, gk, gv, lk, mask)))
    params = flax_params(jmod, 16, *jargs)
    tmod = carry(tatt.PointerAttention(D, H, impl=timpl), params)
    ref = jmod.apply({"params": params}, *jargs)
    with torch.no_grad():
        out = tmod(*map(torch.from_numpy, (q, gk, gv, lk, mask)))
    assert out.shape == mask.shape
    np.testing.assert_allclose(t2n(out), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kwargs", [dict(mask_inner=False), dict(out_bias=True),
                                    dict(impl="xla")])
def test_pointer_attention_kernel_impl_refuses_what_it_would_change(kwargs):
    # the kernel always masks the glimpse and has no output bias: with it,
    # the options that would say otherwise raise, as the JAX package's Pallas
    # path refuses them (they compute with impl="plain")
    with pytest.raises((TypeError, ValueError)):
        tatt.PointerAttention(D, H, **kwargs)


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
@pytest.mark.parametrize("out_bias,mask_inner", [(True, True), (False, False), (True, False)],
                         ids=["bias", "unmasked", "bias-unmasked"])
def test_pointer_attention_options_match_jax(grouped, out_bias, mask_inner):
    """An output bias and an unmasked glimpse, through `pointer_logits`,
    against the JAX package's XLA path."""
    b, n, l = 3, 10, 5
    rs = np.random.RandomState(18)
    q = rs.standard_normal((b, l, D) if grouped else (b, D)).astype(np.float32)
    gk, gv, lk = (rs.standard_normal((b, n, D)).astype(np.float32) for _ in range(3))
    mask = rs.random_sample((b, l, n) if grouped else (b, n)) < 0.6
    mask[..., 0] = True
    jmod = jatt.PointerAttention(D, H, impl="xla", out_bias=out_bias, mask_inner=mask_inner)
    jargs = tuple(map(jnp.asarray, (q, gk, gv, lk, mask)))
    params = flax_params(jmod, 19, *jargs)
    tmod = carry(tatt.PointerAttention(D, H, impl="plain", out_bias=out_bias,
                                       mask_inner=mask_inner), params)
    with torch.no_grad():
        out = tmod(*map(torch.from_numpy, (q, gk, gv, lk, mask)))
    np.testing.assert_allclose(t2n(out), np.asarray(jmod.apply({"params": params}, *jargs)),
                               rtol=2e-4, atol=2e-5)


def test_pointer_logits_takes_the_callers_projection():
    b, n, l = 2, 7, 4
    rs = np.random.RandomState(20)
    q = rs.standard_normal((b, l, D)).astype(np.float32)
    gk, gv, lk = (rs.standard_normal((b, n, D)).astype(np.float32) for _ in range(3))
    mask = rs.random_sample((b, l, n)) < 0.6
    mask[..., 0] = True
    w = (rs.standard_normal((D, D)) / D ** 0.5).astype(np.float32)
    want = jatt.pointer_logits(*map(jnp.asarray, (q, gk, gv, lk, mask)), num_heads=H,
                               project_out=lambda x: jnp.tanh(x @ jnp.asarray(w)))
    got = tatt.pointer_logits(*map(torch.from_numpy, (q, gk, gv, lk, mask)), num_heads=H,
                              project_out=lambda x: torch.tanh(x @ torch.from_numpy(w)))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
def test_pointer_attention_plain_is_the_kernels_plain_version(grouped):
    from rl4co_tpu_torch.ops.pointer_kernel import mask_to_neg_bias, pointer_logits_plain

    b, n, l = 2, 6, 3
    rs = np.random.RandomState(17)
    q = torch.from_numpy(
        rs.standard_normal((b, l, D) if grouped else (b, D)).astype(np.float32))
    gk, gv, lk = (torch.from_numpy(rs.standard_normal((b, n, D)).astype(np.float32))
                  for _ in range(3))
    mask = rs.random_sample((b, l, n) if grouped else (b, n)) < 0.6
    mask[..., 0] = True
    mask = torch.from_numpy(mask)
    tmod = tatt.PointerAttention(D, H, impl="plain")
    with torch.no_grad():
        out = tmod(q, gk, gv, lk, mask)
        want = pointer_logits_plain(q, gk, gv, lk, mask_to_neg_bias(mask),
                                    tmod.project_out_kernel, H)
    assert torch.equal(out, want)
