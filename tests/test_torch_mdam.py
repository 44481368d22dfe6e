"""MDAM in the port against the JAX package (`rl4co_tpu/models/zoo/mdam.py`,
`GraphAttentionNetwork`'s ``h_old`` / ``return_hidden`` path), and the
golden file of the chip phase.

- The encoder's hidden state and the last layer rerun on it under a key
  mask: atol and rtol 1e-5.
- Each path's greedy rollout (actions equal, rewards rtol 1e-5), with and
  without Embedding-Glimpse (``eg_step_gap=2``, as the JAX package's own
  test); the evaluation step's metrics.
- The loss with its KL term on JAX's sampled actions replayed per path:
  within 1e-5 of its terms' scale, the KL rtol 1e-5, every gradient within
  1e-4 of the largest. MDAM keeps no baseline whatever it is given.

`python tests/test_torch_mdam.py` rewrites
`rl4co_tpu_torch/golden/mdam_tsp50.npz` (MDAM at its published widths with
seeded weights on the first 1 024 canonical TSP-50 instances: every path's
greedy cost and tour; 256 of them with Embedding-Glimpse every 10 steps; 8 instances'
loss with its KL on JAX's sampled actions and checksums of the gradients) in
a few minutes; no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models.nn.graph.attnnet import GraphAttentionNetwork as JaxGAT  # noqa: E402
from rl4co_tpu.models.policies.constructive import (  # noqa: E402
    rollout_from_cache as jax_rollout_from_cache,
)
from rl4co_tpu.models.zoo.mdam import MDAM as JaxMDAM  # noqa: E402
from rl4co_tpu.models.zoo.mdam import MDAMPolicy as JaxPolicy  # noqa: E402
from rl4co_tpu.models.zoo.mdam import rollout_eg as jax_rollout_eg  # noqa: E402
from rl4co_tpu_torch.convert import convert_params, random_params_numpy  # noqa: E402
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models.nn.graph.attnnet import GraphAttentionNetwork  # noqa: E402
from rl4co_tpu_torch.models.policies.constructive import rollout_from_cache  # noqa: E402
from rl4co_tpu_torch.models.zoo.mdam import MDAM, MDAMPolicy, rollout_eg  # noqa: E402
from rl4co_tpu_torch.rl.baselines import NoBaseline  # noqa: E402

from _torch_port import (  # noqa: E402
    KEY,
    TSP50_FILE,
    assert_gradients_close,
    assert_loss_close,
    random_locs,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
    zoo_tree_pair,
)
from test_torch_matnet import gradient_checksums  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(embed_dim=32, num_heads=4, num_encoder_layers=2, feedforward_hidden=64,
             num_paths=3)
N, B = 8, 4
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden", "mdam_tsp50.npz")


def test_gat_hidden_and_last_layer_rerun_match_jax():
    tree = random_params_numpy(0, 32, 2, 64)["encoder_net"]
    x = np.random.RandomState(0).standard_normal((B, N, 32)).astype(np.float32)
    mask = np.random.RandomState(1).random_sample((B, N)) < 0.7
    mask[:, 0] = True
    jgat = JaxGAT(32, 4, 2, feedforward_hidden=64)
    gat = GraphAttentionNetwork(32, 4, 2, feedforward_hidden=64)
    gat.load_state_dict(convert_params(tree))
    want_x, want_h = jgat.apply({"params": tree}, x, return_hidden=True)
    with torch.no_grad():
        got_x, got_h = gat(torch.from_numpy(x), return_hidden=True)
        got_re = gat(got_h, mask=torch.from_numpy(mask), h_old=got_h)
    want_re = jgat.apply({"params": tree}, want_h, mask=mask, h_old=want_h)
    for g, w in ((got_x, want_x), (got_h, want_h), (got_re, want_re)):
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=1e-5, rtol=1e-5)


def pair(seed=0, **kw):
    return zoo_tree_pair("mdam", JaxPolicy, MDAMPolicy, seed, **{**SMALL, **kw})


def jax_path_rollouts(jpol, jparams, jenv, inst, spec, key=KEY, eg=False):
    """Every path's JAX rollout of ``inst`` (numpy)."""
    inst = to_jax(inst)
    if eg:
        emb, h_old = jpol.apply(jparams, inst, method="encode_with_hidden")
    else:
        emb = jpol.apply(jparams, inst, method="encode")
    outs = []
    for p in range(jpol.num_paths):
        cache = jpol.apply(jparams, emb, p, method="precompute_path")
        if eg:
            outs.append(jax_rollout_eg(jpol, jparams, jenv, inst, cache, h_old, key, spec, p))
        else:
            outs.append(jax_rollout_from_cache(jpol, jparams, jenv, inst, cache, key, spec,
                                               decode_extra_args=(p,)))
    return outs


@pytest.mark.parametrize("eg", [False, True])
def test_every_path_greedy_matches_jax(eg):
    jpol, jparams, tpol = pair(seed=1, eg_step_gap=2 if eg else 200)
    inst = {"locs": random_locs(3, B, N)}
    jenv, tenv = jax_get_env("tsp", num_loc=N), get_env("tsp", num_loc=N)
    want = jax_path_rollouts(jpol, jparams, jenv, inst, JaxSpec(kind="greedy"), eg=eg)
    spec = DecodeSpec(kind="greedy")
    with torch.no_grad():
        tinst = to_torch(inst)
        if eg:
            emb, h_old = tpol.encode_with_hidden(tinst)
        else:
            emb = tpol.encode(tinst)
        for p, w in enumerate(want):
            cache = tpol.precompute_path(emb, p)
            got = (rollout_eg(tpol, tenv, tinst, cache, h_old, spec, p) if eg
                   else rollout_from_cache(tpol.path(p), tenv, tinst, cache, spec))
            np.testing.assert_array_equal(t2n(got.actions), np.asarray(w.actions))
            np.testing.assert_allclose(t2n(got.reward), np.asarray(w.reward), rtol=1e-5)
    # the evaluation step: the paths' mean and the best path
    jalgo = JaxMDAM(env=jenv, policy=jpol)
    talgo = MDAM(tenv, tpol, baseline="rollout")
    assert isinstance(talgo.baseline, NoBaseline)
    jm = jalgo.make_eval_step()(jparams, to_jax(inst), KEY)
    tm = talgo.make_eval_step()(tinst)
    for k in ("reward", "max_reward"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)


def mdam_algos(seed, n, **kw):
    jpol, jparams, tpol = pair(seed, **kw)
    tpol.train().requires_grad_(True)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxMDAM(env=jax_get_env("tsp", num_loc=n), policy=jpol, train_spec=JaxSpec(**spec))
    talgo = MDAM(get_env("tsp", num_loc=n), tpol, train_spec=DecodeSpec(**spec))
    return jalgo, jparams, talgo


def jax_loss_and_actions(jalgo, jparams, inst, key):
    """JAX's loss, metrics and gradients, and each path's sampled actions
    (the loss's own draws: the same keys through the same rollouts)."""
    (loss, (metrics, _)), grads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, to_jax(inst), key)
    jpol = jalgo.policy
    emb = jpol.apply(jparams, to_jax(inst), method="encode")
    keys = jax.random.split(key, jpol.num_paths)
    actions, rewards, lls = [], [], []
    for p in range(jpol.num_paths):
        cache = jpol.apply(jparams, emb, p, method="precompute_path")
        out = jax_rollout_from_cache(jpol, jparams, jalgo.env, to_jax(inst), cache, keys[p],
                                     jalgo.train_spec, decode_extra_args=(p,))
        actions.append(np.asarray(out.actions))
        rewards.append(np.asarray(out.reward))
        lls.append(np.asarray(out.log_likelihood))
    return loss, metrics, grads, np.stack(actions), np.stack(rewards, 1), np.stack(lls, 1)


def test_loss_with_kl_and_every_gradient_on_replayed_actions_match_jax():
    jalgo, jparams, talgo = mdam_algos(2, N)
    inst = {"locs": random_locs(5, B, N)}
    jloss, jm, jgrads, actions, rewards, lls = jax_loss_and_actions(jalgo, jparams, inst, KEY)
    np.testing.assert_allclose(jm["reward"], rewards.mean(), rtol=1e-6)  # the same draws
    tloss, (tm, _) = talgo.loss(to_torch(inst), replay_actions=actions)
    scale = float(np.abs((rewards - rewards.mean(0)) * lls).mean()) + float(
        talgo.kl_coef * abs(float(jm["kl_divergence"])))
    assert_loss_close(tloss.item(), jloss, scale)
    for k in ("kl_divergence", "reward", "max_reward"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    tloss.backward()
    assert_gradients_close(talgo.policy, jgrads)


def test_golden_file_holds_its_shapes():
    with np.load(GOLDEN) as g:
        assert g["greedy_cost"].shape == (1024, 5) and g["eg_cost"].shape == (256, 5)
        assert g["replay_actions"].shape == (5, 8, 50)
        assert g["greedy_actions"].shape == (5, 1024, 50)
        assert g["eg_actions"].shape == (5, 256, 50)
        assert len(g["grad_names"]) == g["grad_norm"].shape[0]


# ---- the golden file of the chip phase ----

FULL = dict(num_paths=5)     # the published widths are MDAMPolicy's defaults
GOLDEN_SEED, GOLDEN_COUNT, EG_COUNT, EG_GAP, GOLDEN_REPLAY = 19, 1024, 256, 10, 8


def write_golden():
    n = 50
    with np.load(TSP50_FILE) as f:
        locs = f["locs"][:GOLDEN_COUNT].astype(np.float32)
    jenv = jax_get_env("tsp", num_loc=n)
    tree = random_params_numpy(GOLDEN_SEED, policy="mdam", policy_kwargs=FULL)
    jparams = tree_to_jax(tree)
    greedy = JaxSpec(kind="greedy")

    def costs(jpol, inst, eg):
        outs = jax_path_rollouts(jpol, jparams, jenv, inst, greedy, eg=eg)
        return jnp.stack([-o.reward for o in outs], 1), jnp.stack([o.actions for o in outs])

    jpol = JaxPolicy(**FULL)
    greedy_cost, greedy_actions = map(np.asarray, jax.jit(lambda i: costs(jpol, i, False))(
        {"locs": locs}))
    jpol_eg = JaxPolicy(**FULL, eg_step_gap=EG_GAP)
    eg_cost, eg_actions = map(np.asarray, jax.jit(lambda i: costs(jpol_eg, i, True))(
        {"locs": locs[:EG_COUNT]}))
    jalgo = JaxMDAM(env=jenv, policy=jpol, train_spec=JaxSpec(kind="sampling",
                                                               tanh_clipping=10.0))
    key = jax.random.PRNGKey(GOLDEN_SEED)
    replay = {"locs": locs[:GOLDEN_REPLAY]}
    loss, metrics, grads, actions, rewards, lls = jax_loss_and_actions(jalgo, jparams, replay,
                                                                     key)
    named = convert_params(tree_to_numpy(grads))
    names, norm, total, dot = gradient_checksums(named)
    np.savez_compressed(
        GOLDEN, seed=GOLDEN_SEED, eg_gap=EG_GAP, greedy_cost=greedy_cost, eg_cost=eg_cost,
        greedy_actions=greedy_actions.astype(np.int8), eg_actions=eg_actions.astype(np.int8),
        replay_actions=actions.astype(np.int8), loss=float(loss),
        kl_divergence=float(metrics["kl_divergence"]), reward=float(metrics["reward"]),
        terms_scale=float(np.abs((rewards - rewards.mean(0)) * lls).mean()),
        grad_names=np.array(names), grad_norm=norm, grad_sum=total, grad_dot=dot,
        grad_max=max(np.abs(v.numpy()).max() for v in named.values()))
    print(f"wrote {GOLDEN}: best-path mean {greedy_cost.min(1).mean():.6f}, "
          f"EG {eg_cost.min(1).mean():.6f}, loss {float(loss):.6e}")


if __name__ == "__main__":
    write_golden()
