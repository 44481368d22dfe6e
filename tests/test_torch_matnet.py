"""MatNet on ATSP in the port against the JAX package
(`rl4co_tpu/models/zoo/matnet.py`, `MatNetInitEmbedding`,
`ATSPEdgeEmbedding`), and the golden file of the chip phase.

- `MixedScoresAttention` and `MatNetLayer` on numpy-seeded weights: atol
  and rtol 1e-5; the mixer's stored leaves go across as they are.
- `MatNetInitEmbedding` with JAX's random slots (and noise) passed in:
  equal; `ATSPEdgeEmbedding`: neighbours equal, features atol 1e-5.
- The policy's tree has the JAX module's structure; greedy and multistart
  greedy rollouts: actions equal, rewards rtol 1e-5.
- MatNet's POMO loss on JAX's sampled actions replayed: loss within 1e-5
  of its terms' scale (mean |advantage · log-likelihood|; the terms cancel),
  every gradient within 1e-4 of the largest; under bf16 compute the loss
  likewise, with the mixer's shift held to JAX's bf16 bits.

`python tests/test_torch_matnet.py` rewrites
`rl4co_tpu_torch/golden/matnet_atsp50.npz` (MatNet at its published widths,
256 ATSP-50 instances from `jax.random`, the JAX CPU costs of multistart
greedy and their tours, 8 instances' POMO loss on JAX's sampled actions with
checksums of the gradients) in about two minutes; no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models import rollout as jax_rollout  # noqa: E402
from rl4co_tpu.models.nn.env_embeddings import edge as jedge  # noqa: E402
from rl4co_tpu.models.nn.env_embeddings.init import (  # noqa: E402
    MatNetInitEmbedding as JaxInit,
)
from rl4co_tpu.models.zoo.matnet import MatNet as JaxMatNet  # noqa: E402
from rl4co_tpu.models.zoo.matnet import MatNetLayer as JaxLayer  # noqa: E402
from rl4co_tpu.models.zoo.matnet import MatNetPolicy as JaxPolicy  # noqa: E402
from rl4co_tpu.models.zoo.matnet import MixedScoresAttention as JaxMSA  # noqa: E402
from rl4co_tpu_torch.convert import convert_params, random_params_numpy  # noqa: E402
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.edge import ATSPEdgeEmbedding  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.init import MatNetInitEmbedding  # noqa: E402
from rl4co_tpu_torch.models.zoo.matnet import (  # noqa: E402
    MatNet,
    MatNetLayer,
    MatNetPolicy,
    MixedScoresAttention,
)

from _torch_port import (  # noqa: E402
    KEY,
    assert_gradients_close,
    assert_loss_close,
    jax_instances,
    port_rollout,
    reinforce_terms_scale,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
    zoo_tree_pair,
)

torch.set_num_threads(1)

SMALL = dict(embed_dim=32, num_heads=4, num_encoder_layers=2, feedforward_hidden=64)
N, B = 8, 3
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden", "matnet_atsp50.npz")


def layer_tree(seed=0):
    return random_params_numpy(seed, policy="matnet", policy_kwargs=SMALL)["matnet_layer_0"]


def test_mixed_scores_attention_and_layer_match_jax():
    rs = np.random.RandomState(1)
    row, col = (rs.standard_normal((B, n, 32)).astype(np.float32) for n in (N, N + 2))
    dmat = rs.random_sample((B, N, N + 2)).astype(np.float32)
    sub = layer_tree()
    msa = MixedScoresAttention(32, 4)
    msa.load_state_dict(convert_params(sub["row_block"]))
    want = JaxMSA(32, 4).apply({"params": sub["row_block"]}, row, col, dmat)
    got = msa(*map(torch.from_numpy, (row, col, dmat)))
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    layer = MatNetLayer(32, 4, feedforward_hidden=64)
    layer.load_state_dict(convert_params(sub))
    want = JaxLayer(32, 4, feedforward_hidden=64).apply({"params": sub}, row, col, dmat)
    got = layer(*map(torch.from_numpy, (row, col, dmat)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["RandomOneHot", "Random"])
def test_init_embedding_with_jax_draws_and_edge_embedding(mode):
    inst = jax_instances(jax_get_env("atsp", num_loc=N), 2, B)
    row, col, dm = JaxInit(16, mode=mode).apply({}, to_jax(inst), rngs={"embed": KEY})
    col = np.array(col)
    draws = dict(slots=torch.from_numpy(col.argmax(-1))) if mode == "RandomOneHot" else dict(
        noise=torch.from_numpy(col))
    got = MatNetInitEmbedding(16, mode=mode)(to_torch(inst), **draws)
    for g, w in zip(got, (row, col, dm)):
        np.testing.assert_array_equal(t2n(g), np.asarray(w))
    # the k-NN rows of the cost matrix
    kernel = np.random.RandomState(3).standard_normal((1, 16)).astype(np.float32)
    bias = np.zeros(16, np.float32)
    params = {"params": {"edge_embed": {"kernel": kernel, "bias": bias}}}
    want_w, want_idx = jedge.ATSPEdgeEmbedding(16).apply(params, to_jax(inst))
    mod = ATSPEdgeEmbedding(16)
    mod.load_state_dict(convert_params(params["params"]))
    with torch.no_grad():
        got_w, got_idx = mod(to_torch(inst))
    np.testing.assert_array_equal(t2n(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(t2n(got_w), np.asarray(want_w), atol=1e-5)


def policy_pair(seed=0):
    return zoo_tree_pair("matnet", JaxPolicy, MatNetPolicy, seed, **SMALL)


def test_tree_has_the_jax_structure():
    from rl4co_tpu.models.policies.constructive import init_policy_params

    jpol, jparams, _ = policy_pair()
    shapes = jax.eval_shape(lambda k: init_policy_params(jpol, jax_get_env("atsp", num_loc=N),
                                                         k), KEY)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(jparams))
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(shapes),
                                                   jax.tree_util.tree_leaves(jparams)))


@pytest.mark.parametrize("multistart", [False, True])
def test_greedy_rollouts_match_jax(multistart):
    jpol, jparams, tpol = policy_pair(seed=1)
    inst = jax_instances(jax_get_env("atsp", num_loc=N), 4, B)
    spec = dict(kind="greedy", multistart=multistart, num_starts=N if multistart else 0)
    want = jax_rollout(jpol, jparams, jax_get_env("atsp", num_loc=N), to_jax(inst), KEY,
                       JaxSpec(**spec))
    got = port_rollout(tpol, "atsp", inst, **spec)
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), rtol=1e-5)


def matnet_algos(seed, n=N, **dims):
    """(JAX MatNet, its params, the port's MatNet) on the same weights."""
    dims = {**SMALL, **dims}
    jpol, jparams, tpol = zoo_tree_pair("matnet", JaxPolicy, MatNetPolicy, seed, **dims)
    tpol.train().requires_grad_(True)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxMatNet(jax_get_env("atsp", num_loc=n), policy=jpol, train_spec=JaxSpec(**spec))
    talgo = MatNet(get_env("atsp", num_loc=n), policy=tpol, train_spec=DecodeSpec(**spec))
    return jalgo, jparams, talgo


def test_pomo_loss_and_every_gradient_on_replayed_actions_match_jax():
    jalgo, jparams, talgo = matnet_algos(seed=2)
    inst = jax_instances(jax_get_env("atsp", num_loc=N), 5, B)
    (jloss, (jm, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, to_jax(inst), KEY)
    tloss, (tm, tout) = talgo.loss(to_torch(inst), replay_actions=np.asarray(jout.actions))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert_loss_close(tloss.item(), jloss, reinforce_terms_scale(
        jout.reward, jout.log_likelihood, group_axis_size=N))
    np.testing.assert_allclose(tm["reward"].item(), float(jm["reward"]), rtol=1e-5)
    tloss.backward()
    assert_gradients_close(talgo.policy, jgrads)


def test_mixer_shift_under_bf16_has_the_jax_bits():
    """C3: under a bf16 compute dtype the JAX package subtracts ``init`` from
    the bf16-cast parameter in bf16 (``init``, a weakly typed float, is
    rounded too, and so is the result); the port's four shifted mixer tensors
    carry those bits, and the f32 shift is unchanged."""
    import jax.numpy as jnp

    from rl4co_tpu_torch.models.zoo.matnet import MIX1_INIT, MIX2_INIT, shifted
    from rl4co_tpu_torch.utils.dtype import computing_in, round_through

    tree = layer_tree(seed=3)["row_block"]
    for name, init in (("mix_W1", MIX1_INIT), ("mix_b1", MIX1_INIT),
                       ("mix_W2", MIX2_INIT), ("mix_b2", MIX2_INIT)):
        leaf = np.asarray(tree[name], np.float32)
        want = np.asarray((jnp.asarray(leaf).astype(jnp.bfloat16) - init).astype(jnp.float32))
        p = round_through(torch.tensor(leaf), torch.bfloat16)
        with computing_in(torch.bfloat16):
            got = shifted(p, init)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(shifted(torch.tensor(leaf), init).numpy(), leaf - np.float32(init))


def test_bf16_pomo_loss_on_replayed_actions_matches_jax():
    """C3: MatNet's POMO loss under bf16 compute on JAX's sampled actions,
    within 1e-5 of its terms' scale, and its reward rtol 1e-5; the
    log-likelihoods within 1e-3 nats (1.8e-4 here; with the mixer shifted in
    f32 they lay 2.9e-2 apart and the loss 7.2e-4 of its terms' scale)."""
    jalgo, jparams, talgo = matnet_algos(seed=4)
    spec = dict(kind="sampling", tanh_clipping=10.0, compute_dtype="bfloat16")
    jalgo = JaxMatNet(jalgo.env, policy=jalgo.policy, train_spec=JaxSpec(**spec))
    talgo = MatNet(talgo.env, policy=talgo.policy, train_spec=DecodeSpec(**spec))
    inst = jax_instances(jax_get_env("atsp", num_loc=N), 6, B)
    jloss, (jm, jout) = jalgo.loss(jparams, None, to_jax(inst), KEY)
    with torch.no_grad():
        tloss, (tm, tout) = talgo.loss(to_torch(inst), replay_actions=np.asarray(jout.actions))
    np.testing.assert_allclose(t2n(tout.log_likelihood), np.asarray(jout.log_likelihood),
                               rtol=0, atol=1e-3)
    assert_loss_close(tloss.item(), jloss, reinforce_terms_scale(
        jout.reward, jout.log_likelihood, group_axis_size=N))
    np.testing.assert_allclose(tm["reward"].item(), float(jm["reward"]), rtol=1e-5)


def test_golden_file_holds_its_shapes():
    with np.load(GOLDEN) as g:
        assert g["cost_matrix"].shape == (256, 50, 50)
        assert g["cost"].shape == (256,) and g["actions"].shape == (256, 50, 50)
        assert g["replay_actions"].shape == (8 * 50, 50)
        assert g["grad_norm"].shape == g["grad_sum"].shape == g["grad_dot"].shape
        assert len(g["grad_names"]) == g["grad_norm"].shape[0]


# ---- the golden file of the chip phase ----

FULL = dict(embed_dim=256, num_heads=16, num_encoder_layers=5, feedforward_hidden=512)
GOLDEN_SEED, GOLDEN_COUNT, GOLDEN_REPLAY = 19, 256, 8


def gradient_checksums(named_grads: dict, seed: int = 0):
    """Per leaf (sorted names): norm, sum and dot with a seeded normal vector."""
    names = sorted(named_grads)
    rs = np.random.RandomState(seed)
    norm, total, dot = [], [], []
    for name in names:
        g = np.asarray(named_grads[name], dtype=np.float64)
        norm.append(np.linalg.norm(g))
        total.append(g.sum())
        dot.append((g * rs.standard_normal(g.shape)).sum())
    return names, np.array(norm), np.array(total), np.array(dot)


def write_golden():
    n = 50
    jenv = jax_get_env("atsp", num_loc=n)
    inst = jax_instances(jenv, GOLDEN_SEED, GOLDEN_COUNT)
    tree = random_params_numpy(GOLDEN_SEED, policy="matnet", policy_kwargs=FULL)
    jpol, jparams = JaxPolicy(**FULL), tree_to_jax(tree)
    spec = JaxSpec(kind="greedy", multistart=True, num_starts=n)
    out = jax.jit(lambda p, i: jax_rollout(jpol, p, jenv, i, KEY, spec))(jparams, to_jax(inst))
    reward = np.asarray(out.reward).reshape(n, GOLDEN_COUNT)              # [S, B]
    best = reward.argmax(0)
    actions = np.asarray(out.actions).reshape(n, GOLDEN_COUNT, n).transpose(1, 0, 2)
    jalgo = JaxMatNet(jenv, policy=jpol, train_spec=JaxSpec(kind="sampling",
                                                            tanh_clipping=10.0))
    replay = {k: v[:GOLDEN_REPLAY] for k, v in inst.items()}
    (loss, (metrics, rout)), grads = jax.jit(jax.value_and_grad(jalgo.loss, has_aux=True))(
        jparams, None, to_jax(replay), jax.random.PRNGKey(GOLDEN_SEED))
    named = convert_params(tree_to_numpy(grads))
    names, norm, total, dot = gradient_checksums(named)
    np.savez_compressed(
        GOLDEN, seed=GOLDEN_SEED, cost_matrix=inst["cost_matrix"],
        cost=-reward.max(0), best_start=best, actions=actions.astype(np.int8),
        replay_actions=np.asarray(rout.actions).astype(np.int8), loss=float(loss),
        reward=float(metrics["reward"]), grad_names=np.array(names), grad_norm=norm,
        grad_sum=total, grad_dot=dot, grad_max=max(np.abs(v.numpy()).max()
                                                     for v in named.values()))
    print(f"wrote {GOLDEN}: mean cost {-reward.max(0).mean():.6f}, loss {float(loss):.6e}")


if __name__ == "__main__":
    write_golden()
