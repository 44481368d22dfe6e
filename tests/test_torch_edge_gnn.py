"""The port's edge embeddings and graph encoders (`models/nn/env_embeddings/
edge.py`, `models/nn/graph/gnn.py`) against the JAX package's, on the same
numpy inputs and weights.

Tolerances: ``nbr_idx`` exactly equal (every later value is gathered through
it), edge distances atol 1e-6, encoder outputs atol 1e-5 (f32 on both sides;
the batch norms' statistics are reduced in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import random_cvrp, random_locs, t2n, tree_to_jax, tree_to_numpy
from rl4co_tpu.models.nn.env_embeddings import edge as jedge
from rl4co_tpu.models.nn.graph import gnn as jgnn
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.models.nn.env_embeddings import edge
from rl4co_tpu_torch.models.nn.graph import gnn

torch.set_num_threads(1)

DIST_ATOL, OUT_ATOL = 1e-6, 1e-5


def tensors(inst):
    return {k: torch.from_numpy(v) for k, v in inst.items()}


def jarrays(inst):
    return {k: jnp.asarray(v) for k, v in inst.items()}


@pytest.mark.parametrize("n", [2, 5, 11, 12, 50, 55, 100, 500, 1000])
def test_default_k_sparse_matches_jax(n):
    assert edge.default_k_sparse(n) == jedge.default_k_sparse(n)


def grid_locs(b, side):
    """Points of a grid: many equal distances, so the neighbour order rests
    on how ties break."""
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2)
    locs = (g / side).astype(np.float32)
    perm = np.random.RandomState(1).permutation(len(locs))
    return np.broadcast_to(locs[perm], (b,) + locs.shape).copy()


@pytest.mark.parametrize("kind", ["uniform", "grid", "duplicates"])
def test_knn_edges_match_jax_exactly(kind):
    if kind == "uniform":
        locs = random_locs(0, 4, 20)
    elif kind == "grid":
        locs = grid_locs(2, 4)
    else:  # repeated points: zero distances, ties at every k
        locs = np.repeat(random_locs(2, 3, 5), 4, axis=1)
    k = edge.default_k_sparse(locs.shape[1])
    want_idx, want_d = jedge.knn_edges(jnp.asarray(locs), k)
    got_idx, got_d = edge.knn_edges(torch.from_numpy(locs), k)
    np.testing.assert_array_equal(t2n(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(t2n(got_d), np.asarray(want_d), rtol=0, atol=DIST_ATOL)


def test_knn_edges_from_matrix_match_jax():
    rs = np.random.RandomState(3)
    dm = rs.randint(0, 5, size=(3, 12, 12)).astype(np.float32)  # integer costs: ties
    want_idx, want_d = jedge.knn_edges_from_matrix(jnp.asarray(dm), 4)
    got_idx, got_d = edge.knn_edges_from_matrix(torch.from_numpy(dm), 4)
    np.testing.assert_array_equal(t2n(got_idx), np.asarray(want_idx))
    np.testing.assert_array_equal(t2n(got_d), np.asarray(want_d))


def instances_of(env_name, seed=0, b=3, n=12):
    if env_name == "tsp":
        return {"locs": random_locs(seed, b, n)}
    inst = random_cvrp(seed, b, n)
    rs = np.random.RandomState(seed + 7)
    inst.update(prize=rs.random_sample((b, n)).astype(np.float32),
                deterministic_prize=rs.random_sample((b, n)).astype(np.float32),
                penalty=rs.random_sample((b, n)).astype(np.float32))
    return inst


@pytest.mark.parametrize("env_name", ["tsp", "cvrp", "op", "pctsp", "spctsp"])
def test_edge_embedding_matches_jax(env_name):
    inst = instances_of(env_name)
    tree = random_params_numpy(0, embed_dim=16, policy="nargnn", env_name=env_name,
                               gnn_layers=1, heatmap_layers=2)
    name = [k for k in tree if k.endswith("EdgeEmbedding_0")][0]
    jmod = jedge.env_edge_embedding(env_name, 16)
    want_w, want_idx = jmod.apply(tree_to_jax(tree[name]), jarrays(inst))
    mod = load_params(edge.env_edge_embedding(env_name, 16), tree[name])
    assert type(mod).__name__ == type(jmod).__name__
    with torch.no_grad():
        got_w, got_idx = mod(tensors(inst))
    np.testing.assert_array_equal(t2n(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(t2n(got_w), np.asarray(want_w), rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("env_name", ["atsp", "shpp"])
def test_atsp_and_shpp_edge_embeddings_are_the_jax_registry_s(env_name):
    # ATSP's came with MatNet, SHPP's with its env, and is TSP's, as in the
    # JAX registry
    assert env_name in jedge.EDGE_EMBEDDING_REGISTRY
    mod = edge.env_edge_embedding(env_name, 16)
    assert type(mod).__name__ == jedge.EDGE_EMBEDDING_REGISTRY[env_name].__name__
    if env_name == "shpp":
        assert type(mod) is edge.TSPEdgeEmbedding


def test_registry_covers_the_ported_envs():
    assert set(edge.EDGE_EMBEDDING_REGISTRY) == set(jedge.EDGE_EMBEDDING_REGISTRY)
    for name, cls in edge.EDGE_EMBEDDING_REGISTRY.items():
        assert cls.__name__ == jedge.EDGE_EMBEDDING_REGISTRY[name].__name__


def test_gather_neighbors_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 7, 5)).astype(np.float32)
    idx = rs.randint(0, 7, size=(2, 7, 3)).astype(np.int32)
    want = jgnn.gather_neighbors(jnp.asarray(x), jnp.asarray(idx))
    got = gnn.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx).long())
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


@pytest.mark.parametrize("agg_fn,act_fn", [("mean", "silu"), ("sum", "relu"), ("max", "gelu")])
def test_sparse_gnn_encoder_matches_jax(agg_fn, act_fn):
    locs = random_locs(5, 3, 16)
    k = edge.default_k_sparse(16)
    nbr_idx, dist = jedge.knn_edges(jnp.asarray(locs), k)
    rs = np.random.RandomState(6)
    x = rs.standard_normal((3, 16, 16)).astype(np.float32)
    w = (rs.standard_normal((3, 16, k, 16)) + np.asarray(dist)[..., None]).astype(np.float32)
    tree = random_params_numpy(1, embed_dim=16, policy="nargnn", gnn_layers=3,
                               heatmap_layers=2)["graph_network"]
    jmod = jgnn.SparseGNNEncoder(16, num_layers=3, act_fn=act_fn, agg_fn=agg_fn)
    want_x, want_w = jmod.apply(tree_to_jax(tree), jnp.asarray(x), jnp.asarray(w), nbr_idx)
    mod = load_params(gnn.SparseGNNEncoder(16, num_layers=3, act_fn=act_fn, agg_fn=agg_fn),
                      tree)
    with torch.no_grad():
        got_x, got_w = mod(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(np.array(nbr_idx)).long())
    np.testing.assert_allclose(t2n(got_x), np.asarray(want_x), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(t2n(got_w), np.asarray(want_w), rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("env_name", ["tsp", "cvrp"])
@pytest.mark.parametrize("encoder", ["gcn", "mpnn"])
def test_dense_graph_encoders_match_jax(encoder, env_name):
    inst = instances_of(env_name, seed=8, b=2, n=9)
    if encoder == "gcn":
        jmod = jgnn.GCNEncoder(env_name=env_name, embed_dim=16, num_layers=2, self_loop=False)
        mod = gnn.GCNEncoder(env_name, 16, num_layers=2, self_loop=False)
    else:
        jmod = jgnn.MessagePassingEncoder(env_name=env_name, embed_dim=16, num_layers=2,
                                          aggregation="mean")
        mod = gnn.MessagePassingEncoder(env_name, 16, num_layers=2, aggregation="mean")
    params = jmod.init(jax.random.PRNGKey(0), jarrays(inst))
    want_x, want_x0 = jmod.apply(params, jarrays(inst))
    load_params(mod, tree_to_numpy(params))
    with torch.no_grad():
        got_x, got_x0 = mod(tensors(inst))
    np.testing.assert_allclose(t2n(got_x0), np.asarray(want_x0), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(t2n(got_x), np.asarray(want_x), rtol=0, atol=OUT_ATOL)
