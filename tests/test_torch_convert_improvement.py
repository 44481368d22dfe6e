"""The weight bridge (`rl4co_tpu_torch/convert.py`) on the trees of the
improvement models: DACT's, N2S's and NeuOpt's Flax policies (NeuOpt's GRU
cells packed into `torch.nn.GRUCell`'s rows), `ImprovementCritic` and
EAS-Lay's layer. Each tree has the structure of the Flax module's own
``init`` (`jax.eval_shape`: Flax's automatic names), numpy-seeded values;
every leaf must find its parameter and every parameter its leaf, and the
port's outputs equal the JAX package's at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.models.zoo.dact import ImprovementCritic as JaxCritic
from rl4co_tpu_torch.convert import convert_eas_params, convert_params, load_params
from rl4co_tpu_torch.models.zoo.dact import ImprovementCritic

from _torch_port import (TRIO_SMALL, seeded_tree_like, t2n, trio_jax_state, trio_params,
                         trio_setup)

torch.set_num_threads(1)


def setup(name, seed=0):
    jenv, tenv, jpol, tcls, *_ = trio_setup(name, 8, **TRIO_SMALL)
    inst = {k: v.numpy() for k, v in
            tenv.generate(3, torch.Generator().manual_seed(seed), "cpu").items()}
    jst, tst = trio_jax_state(jenv, tenv, inst, seed + 1)
    return jpol, tcls, jst, tst


@pytest.mark.parametrize("name", ["dact", "n2s", "neuopt"])
def test_policy_trees_load_whole_and_give_the_jax_embeds(name):
    jpol, tcls, jst, tst = setup(name)
    tree = trio_params(jpol, jst, 3)
    shapes = jax.eval_shape(jpol.init, jax.random.PRNGKey(0), jst)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    tpol = load_params(tcls(**TRIO_SMALL, device="cpu"), tree)
    want = jpol.apply(tree, jst, method="encode")
    got = tpol.encode(tst)
    if name == "dact":   # both aspects
        want, got = jnp.concatenate(want, -1), torch.cat(got, -1)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)
    if name == "neuopt":
        d = TRIO_SMALL["embed_dim"]
        for cell in ("rnn1", "rnn2"):
            rows = getattr(tpol.decoder, cell).bias_hh
            assert not rows[:2 * d].any(), "Flax's hr and hz carry no bias"
            np.testing.assert_array_equal(t2n(rows[2 * d:]),
                                          tree["params"]["decoder"][cell]["hn"]["bias"])
        h = jpol.apply(tree, jst, method="encode")
        q0 = jnp.asarray(np.random.RandomState(1).standard_normal((3, d)).astype(np.float32))
        want = jpol.apply(tree, h, q0, q0 * 2, q0 * 3, q0 * 4, method="decode")
        ht = torch.from_numpy(np.array(h))
        qt = torch.from_numpy(np.array(q0))
        got = tpol.decoder(ht, qt, qt * 2, qt * 3, qt * 4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("name", ["dact", "neuopt"])
def test_a_leaf_left_over_or_missing_is_reported(name):
    jpol, tcls, jst, _ = setup(name)
    tree = trio_params(jpol, jst, 4)
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        load_params(tcls(**TRIO_SMALL, device="cpu"), extra)
    missing = jax.tree_util.tree_map(lambda x: x, tree)
    del missing["params"]["decoder" if name == "neuopt" else "value_head"]
    with pytest.raises(ValueError, match="not set by the tree"):
        load_params(tcls(**TRIO_SMALL, device="cpu"), missing)


def test_critic_and_eas_layer_trees():
    embeds = np.random.RandomState(0).standard_normal((3, 9, 32)).astype(np.float32)
    jc = JaxCritic(embed_dim=32)
    tree = seeded_tree_like(jax.eval_shape(jc.init, jax.random.PRNGKey(0), embeds), 5)
    critic = load_params(ImprovementCritic(32, device="cpu"), tree)
    np.testing.assert_allclose(t2n(critic(torch.from_numpy(embeds))),
                               np.asarray(jc.apply(tree, embeds)), atol=1e-5)
    rs = np.random.RandomState(1)
    eas = {"w1": rs.standard_normal((16, 8)).astype(np.float32), "b1": np.zeros(8, np.float32),
           "w2": rs.standard_normal((8, 16)).astype(np.float32), "b2": np.ones(16, np.float32)}
    got = convert_eas_params(eas)
    for k, v in eas.items():   # used as x @ w: nothing transposed
        np.testing.assert_array_equal(t2n(got[k]), v)
    with pytest.raises(ValueError, match="w1, b1, w2, b2"):
        convert_eas_params({"w1": eas["w1"]})
    # the GRU packing leaves other trees alone
    assert set(convert_params(tree)) == {n for n, _ in critic.named_parameters()}
