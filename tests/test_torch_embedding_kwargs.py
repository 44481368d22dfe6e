"""The env embeddings' own arguments, as the JAX package's modules take them
(`rl4co_tpu/models/nn/env_embeddings/{init,context}.py`): ``use_bias`` on
every init embedding but TSP's, SHPP's, FLP's and MCP's, ``vehicle_capacity`` on CVRP's
and CVRPTW's context. With ``use_bias=False`` the port's tree
(`convert.random_params_numpy(init_embedding_kwargs=...)`) has the paths and
shapes of the JAX package's freshly initialised one, the policy loads it, and
the init embedding's forward equals JAX's within 1e-6; with
``vehicle_capacity=2.0`` the context's forward equals JAX's within 1e-6, and
AM's greedy rollouts with both arguments equal JAX's (actions equal, rewards
within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.models.nn.env_embeddings import context as jctx, init as jinit
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu_torch.convert import convert_params, load_params, random_params_numpy
from rl4co_tpu_torch.models.nn.env_embeddings.context import CONTEXT_EMBEDDING_REGISTRY
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.models.nn.env_embeddings import env_context_embedding, env_init_embedding

from _torch_port import (
    SMALL,
    JaxPolicy,
    assert_rollouts_match,
    env_pair,
    jax_instances,
    rollout_pair,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
)

torch.set_num_threads(1)

# the envs AM drives (those with a context embedding; ATSP, FFSP, FJSP and
# JSSP have their own policies)
BIASED = sorted(set(CONTEXT_EMBEDDING_REGISTRY) - {"tsp", "shpp", "flp", "mcp"})
NO_BIAS = {"use_bias": False}


def shapes(tree):
    return jax.tree_util.tree_map(lambda a: a.shape, tree)


@pytest.mark.parametrize("env_name", BIASED)
def test_init_embedding_without_bias_matches_jax(env_name):
    tenv, jenv = env_pair(env_name, 8)
    d = SMALL["embed_dim"]
    want = tree_to_numpy(init_policy_params(
        JaxPolicy(env_name=env_name, init_embedding_kwargs=NO_BIAS, **SMALL), jenv,
        jax.random.PRNGKey(0)))["params"]
    tree = random_params_numpy(0, d, SMALL["num_encoder_layers"], SMALL["feedforward_hidden"],
                               env_name=env_name, init_embedding_kwargs=NO_BIAS)
    assert shapes(tree) == shapes(want)
    assert not any("bias" in leaf for leaf in tree["init_embedding"].values())
    load_params(AttentionModelPolicy(env_name=env_name, device="cpu",
                                     init_embedding_kwargs=NO_BIAS, **SMALL), tree)
    # the module alone: same forward on the same weights
    jmod = jinit.env_init_embedding(env_name, d, **NO_BIAS)
    tmod = env_init_embedding(env_name, d, **NO_BIAS)
    tmod.load_state_dict(convert_params(tree["init_embedding"]), strict=True)
    inst = jax_instances(jenv, 1, 4)
    out = np.asarray(jmod.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, tree["init_embedding"])}, to_jax(inst)))
    with torch.no_grad():
        np.testing.assert_allclose(t2n(tmod(to_torch(inst))), out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env_name", ["cvrp", "cvrptw"])
def test_vehicle_capacity_reaches_the_context(env_name):
    tenv, jenv = env_pair(env_name, 8)
    d = SMALL["embed_dim"]
    kw = {"vehicle_capacity": 2.0}
    tree = random_params_numpy(0, d, 1, 16, env_name=env_name,
                               context_embedding_kwargs=kw)["context_embedding"]
    jmod = jctx.env_context_embedding(env_name, d, **kw)
    tmod = env_context_embedding(env_name, d, **kw)
    tmod.load_state_dict(convert_params(tree), strict=True)
    default = env_context_embedding(env_name, d)
    default.load_state_dict(convert_params(tree), strict=True)
    inst = jax_instances(jenv, 2, 4)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    rs = np.random.RandomState(0)
    emb = rs.standard_normal((4, 9, d)).astype(np.float32)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    for _ in range(4):
        want = np.asarray(jmod.apply(params, jnp.asarray(emb), js))
        with torch.no_grad():
            got = t2n(tmod(torch.from_numpy(emb), ts))
            other = t2n(default(torch.from_numpy(emb), ts))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.abs(other - got).max() > 1e-3  # the capacity enters the query
        act = np.array([rs.choice(np.flatnonzero(m)) for m in t2n(tenv.action_mask(ts))])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)


def test_am_with_both_arguments_matches_jax():
    """`AttentionModelPolicy(env_name="cvrp", init_embedding_kwargs={"use_bias":
    False}, context_embedding_kwargs={"vehicle_capacity": 2.0})`, its weight
    loading, and its greedy rollout against JAX's."""
    kw = dict(init_embedding_kwargs=NO_BIAS, context_embedding_kwargs={"vehicle_capacity": 2.0})
    tree = random_params_numpy(5, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"], env_name="cvrp", **kw)
    tpol = load_params(AttentionModelPolicy(env_name="cvrp", device="cpu", **kw, **SMALL),
                       tree).eval()
    jpol = JaxPolicy(env_name="cvrp", **kw, **SMALL)
    _, jenv = env_pair("cvrp", 10)
    inst = jax_instances(jenv, 4, 6)
    want, got = rollout_pair(jpol, tree_to_jax(tree), tpol, "cvrp", inst, kind="greedy",
                             tanh_clipping=10.0)
    assert_rollouts_match(want, got)
