"""`rl4co_tpu_torch.convert`: a fresh Flax parameter tree carried into the
port's policy, and what it refuses."""

import copy

import jax
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu_torch.convert import convert_params, load_params, random_params_numpy
from rl4co_tpu_torch.models import AttentionModelPolicy

from _torch_port import SMALL, env_pair, tree_to_numpy

torch.set_num_threads(1)


def fresh_tree():
    jpol = JaxPolicy(env_name="tsp", **SMALL)
    params = init_policy_params(jpol, jax_get_env("tsp", num_loc=8), jax.random.PRNGKey(0))
    return tree_to_numpy(params)


def small_policy(**kw):
    return AttentionModelPolicy(env_name="tsp", device="cpu", **{**SMALL, **kw})


@pytest.mark.parametrize("wrapped", [True, False], ids=["with-params-key", "bare"])
def test_round_trip_of_a_fresh_flax_tree(wrapped):
    tree = fresh_tree()
    assert set(tree) == {"params"}
    policy = load_params(small_policy(), tree if wrapped else tree["params"])
    state = policy.state_dict()
    p = tree["params"]
    d = SMALL["embed_dim"]
    # a Dense kernel [in, out] is transposed into Linear.weight [out, in]
    wqkv = p["encoder_net"]["layer_0"]["mha"]["Wqkv"]["kernel"]
    assert wqkv.shape == (d, 3 * d)
    np.testing.assert_array_equal(state["encoder_net.layer_0.mha.Wqkv.weight"].numpy(), wqkv.T)
    np.testing.assert_array_equal(
        state["encoder_net.layer_1.ffn.Dense_1.bias"].numpy(),
        p["encoder_net"]["layer_1"]["ffn"]["Dense_1"]["bias"])
    # the pointer's output projection is used as x @ W: not transposed
    np.testing.assert_array_equal(state["pointer.project_out_kernel"].numpy(),
                                  p["pointer"]["project_out_kernel"])
    # the placeholder is stored raw; the -1.0 is applied at use
    np.testing.assert_array_equal(state["context_embedding.W_placeholder"].numpy(),
                                  p["context_embedding"]["W_placeholder"])
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert n_leaves == len(state) == len(convert_params(tree))


def test_random_params_have_the_structure_of_a_flax_tree():
    tree = fresh_tree()["params"]
    rand = random_params_numpy(0, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"])
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(rand) == shapes(tree)
    again = random_params_numpy(0, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                                SMALL["feedforward_hidden"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, rand, again)
    w = rand["context_embedding"]["W_placeholder"]
    assert (w >= 0).all() and (w < 2).all()


def test_a_left_over_leaf_raises_with_its_path():
    tree = copy.deepcopy(fresh_tree())
    tree["params"]["encoder_net"]["layer_7"] = {"mha": {"Wqkv": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="encoder_net.layer_7.mha.Wqkv.weight"):
        load_params(small_policy(), tree)


def test_an_unknown_leaf_raises_with_its_path():
    tree = copy.deepcopy(fresh_tree())
    tree["params"]["pointer"]["mystery"] = np.zeros(3)
    with pytest.raises(ValueError, match="pointer/mystery"):
        convert_params(tree)


def test_an_unset_parameter_raises_with_its_path():
    tree = copy.deepcopy(fresh_tree())
    del tree["params"]["project_fixed_context"]
    with pytest.raises(ValueError, match="project_fixed_context.weight"):
        load_params(small_policy(), tree)


def test_a_wrong_shape_raises_with_its_path():
    with pytest.raises(ValueError, match=r"[\w.]+: tree has shape \(\d+,.*the policy"):
        load_params(small_policy(embed_dim=64), fresh_tree())


@pytest.mark.parametrize("policy,env_name", [("am", "cvrp"), ("symnco", "tsp"),
                                             ("mvmoe", "cvrp"), ("polynet", "tsp")])
def test_random_trees_of_the_zoo_have_the_structure_of_their_flax_trees(policy, env_name):
    from rl4co_tpu.models.zoo.mvmoe import MVMoEPolicy
    from rl4co_tpu.models.zoo.polynet import PolyNetPolicy
    from rl4co_tpu.models.zoo.symnco import SymNCOPolicy

    extra = dict(k=5, poly_layer_dim=24) if policy == "polynet" else {}
    cls = {"am": JaxPolicy, "symnco": SymNCOPolicy, "mvmoe": MVMoEPolicy,
           "polynet": PolyNetPolicy}[policy]
    graph = env_name == "tsp"
    jpol = cls(env_name=env_name, use_graph_context=graph, **SMALL, **extra)
    want = tree_to_numpy(init_policy_params(jpol, jax_get_env(env_name, num_loc=8),
                                            jax.random.PRNGKey(0)))["params"]
    got = random_params_numpy(0, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                              SMALL["feedforward_hidden"], policy=policy, env_name=env_name,
                              use_graph_context=graph, **extra)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(got) == shapes(want)


def test_stacked_expert_kernels_and_gates_keep_their_layout():
    kernel = np.arange(24, dtype=np.float32).reshape(2, 3, 4)  # [E, in, out]
    gate = np.arange(6, dtype=np.float32).reshape(3, 2)          # [in, E]
    state = convert_params({"moe": {"w_gate": gate, "experts": {"Dense_0": {
        "kernel": kernel, "bias": np.zeros((2, 4), np.float32)}}}})
    np.testing.assert_array_equal(state["moe.experts.Dense_0.kernel"].numpy(), kernel)
    np.testing.assert_array_equal(state["moe.w_gate"].numpy(), gate)
    with pytest.raises(ValueError, match="moe/experts/Dense_0/kernel"):
        convert_params({"moe": {"experts": {"Dense_0": {"kernel": np.zeros((1, 2, 3, 4))}}}})


@pytest.mark.parametrize("env_name", sorted(__import__(
    "rl4co_tpu_torch.models.nn.env_embeddings.context",
    fromlist=["CONTEXT_EMBEDDING_REGISTRY"]).CONTEXT_EMBEDDING_REGISTRY))
def test_every_ported_env_gets_the_tree_of_its_flax_policy(env_name):
    """The init, context and dynamic embeddings of each env AM drives (those
    with a context embedding: ATSP, FFSP, FJSP and JSSP have their own
    policies, `test_the_envs_of_the_rest_of_the_zoo_have_trees`), read from
    the port's modules, give the paths and shapes of the JAX package's
    freshly initialised AM tree, and the port's policy takes the tree with
    no leaf left over and no parameter unset."""
    jenv = env_pair(env_name, 8)[1]
    want = tree_to_numpy(init_policy_params(JaxPolicy(env_name=env_name, **SMALL), jenv,
                                            jax.random.PRNGKey(0)))["params"]
    got = random_params_numpy(0, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                              SMALL["feedforward_hidden"], env_name=env_name)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(got) == shapes(want)
    load_params(AttentionModelPolicy(env_name=env_name, device="cpu", **SMALL), got)


@pytest.mark.parametrize("env_name,tree,cls", [
    ("atsp", "matnet", "rl4co_tpu_torch.models.zoo.matnet:MatNetPolicy"),
    ("ffsp", "matnet_ffsp", "rl4co_tpu_torch.models.zoo.matnet_ffsp:MatNetFFSPPolicy"),
    ("fjsp", "l2d", "rl4co_tpu_torch.models.zoo.l2d:L2DPolicy")])
def test_the_envs_of_the_rest_of_the_zoo_have_trees(env_name, tree, cls):
    """ATSP, FFSP and FJSP take no AM tree: their policies' trees are drawn
    from the port's modules, the same for the same seed; an unknown env
    still raises."""
    import importlib

    module, name = cls.split(":")
    kw = dict(embed_dim=16, num_encoder_layers=1)
    first = random_params_numpy(0, policy=tree, policy_kwargs=kw)
    again = random_params_numpy(0, policy=tree, policy_kwargs=kw)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, first, again))
    load_params(getattr(importlib.import_module(module), name)(device="cpu", **kw), first)
    with pytest.raises(ValueError, match="no env"):
        random_params_numpy(0, env_name="not-an-env")
