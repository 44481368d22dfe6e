"""PolyNet (`models/zoo/polynet.py`) against `rl4co_tpu/models/zoo/polynet.py`:
the bit table over the query axis, the decode step with one query and with
L queries (L below, at and past k, where the table repeats), the Poppy loss
with every gradient on replayed actions, and the evaluation step.

The JAX train spec samples; here it runs greedily over the k samples (each
sample's bit vector still makes its tours differ) and the port replays the
JAX package's actions. Tolerances: logits rtol 2e-4, atol 2e-5; actions
equal; loss and metrics atol 2e-5; gradients rtol 1e-3, atol 1e-5, as
`test_torch_reinforce.py`.
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu.models.zoo.polynet import PolyNet as JaxPolyNet
from rl4co_tpu.models.zoo.polynet import PolyNetPolicy as JaxPolyNetPolicy
from rl4co_tpu_torch.convert import convert_params, load_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.zoo.polynet import PolyNet, PolyNetPolicy, bit_table
from rl4co_tpu_torch.rl.baselines import SharedBaseline

from _torch_port import SMALL, decode_logits_pair, random_locs, t2n, tree_to_numpy, zoo_pair

torch.set_num_threads(1)

N, B, K = 10, 4, 6
KEY = jax.random.PRNGKey(0)
POLY = dict(k=K, poly_layer_dim=24)


@pytest.mark.parametrize("k", [1, 2, 5, 8, 64])
def test_bit_table_is_the_jax_table(k):
    bits = max(1, math.ceil(math.log2(k)))
    want = np.asarray(list(itertools.product([0, 1], repeat=bits))[:k], np.float32)
    np.testing.assert_array_equal(t2n(bit_table(k)), want)


def test_a_flax_tree_fills_the_policy_leaf_for_leaf():
    jpol = JaxPolyNetPolicy(env_name="tsp", **SMALL, **POLY)
    tree = tree_to_numpy(init_policy_params(jpol, jax_get_env("tsp", num_loc=N),
                                            jax.random.PRNGKey(1)))["params"]
    assert set(tree["pointer"]) == {"poly_layer_1", "poly_layer_2", "project_out"}
    load_params(PolyNetPolicy(env_name="tsp", device="cpu", **SMALL, **POLY), tree)


@pytest.mark.parametrize("repeats", [1, 4, K, 2 * K + 1], ids=["single", "L4", "Lk", "L2k+1"])
def test_decode_step_logits_match_jax(repeats):
    jpol, jparams, tpol = zoo_pair("polynet", seed=2, **POLY)
    locs = random_locs(3, B, N)
    for first in (None, np.random.RandomState(4).randint(0, N, size=repeats * B)):
        want, got = decode_logits_pair(jpol, jparams, tpol, "tsp", {"locs": locs}, repeats,
                                       first)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if repeats > 1:  # the bit vectors make the queries of one state differ
        g = got.reshape(repeats, B, N)
        assert np.abs(g[1] - g[0]).max() > 1e-4


def algos(seed=5):
    jpol, jparams, tpol = zoo_pair("polynet", seed=seed, **POLY)
    tpol.train().requires_grad_(True)
    jalgo = JaxPolyNet(env=jax_get_env("tsp", num_loc=N), policy=jpol, k=K,
                       train_spec=JaxSpec(kind="sampling", tanh_clipping=10.0))
    object.__setattr__(jalgo, "train_spec", dataclasses.replace(jalgo.train_spec, kind="greedy"))
    talgo = PolyNet(get_env("tsp", num_loc=N), tpol, k=K,
                    train_spec=DecodeSpec(kind="greedy", tanh_clipping=10.0))
    return jalgo, jparams, talgo


def test_configuration_is_the_jax_one():
    jalgo, _, talgo = algos()
    assert talgo.train_spec.kind == "sampling" and talgo.train_spec.num_samples == K
    assert not talgo.train_spec.multistart
    assert talgo.baseline == SharedBaseline(num_repeats=K)
    assert talgo.val_num_solutions == jalgo.val_num_solutions == 64


def test_poppy_loss_and_every_gradient_match_jax_on_replayed_actions():
    jalgo, jparams, talgo = algos()
    locs = random_locs(6, B, N)
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, {"locs": jnp.asarray(locs)}, KEY)
    tloss, (tmetrics, tout) = talgo.loss({"locs": torch.from_numpy(locs)},
                                         replay_actions=np.array(jout.actions))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert tout.actions.shape == (K * B, N)
    assert set(tmetrics) == set(jmetrics)
    for name in jmetrics:
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    got = dict(talgo.policy.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(t2n(p.grad), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2


def test_eval_step_matches_jax():
    """With a greedy spec over k samples (deterministic on both sides)."""
    jalgo, jparams, talgo = algos(seed=7)
    locs = random_locs(8, B, N)
    jspec = JaxSpec(kind="greedy", num_samples=K, tanh_clipping=10.0)
    object.__setattr__(jalgo, "val_num_solutions", K)
    talgo.val_num_solutions = K
    jm = jalgo.make_eval_step(jspec)(jparams, {"locs": jnp.asarray(locs)}, KEY)
    tm = talgo.make_eval_step(DecodeSpec(kind="greedy", num_samples=K, tanh_clipping=10.0))(
        {"locs": torch.from_numpy(locs)})
    assert set(tm) == set(jm) == {"reward", "max_reward"}
    for name in tm:
        assert not tm[name].requires_grad
        np.testing.assert_allclose(tm[name].item(), float(jm[name]), rtol=1e-5, err_msg=name)
    assert tm["max_reward"] > tm["reward"]
