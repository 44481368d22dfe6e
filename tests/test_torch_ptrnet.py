"""The port's Pointer Network against the JAX package's
(`rl4co_tpu/models/zoo/ptrnet.py`), on the same seeded tree
(`random_params_numpy(policy="ptrnet")`) and TSP instances.

Tolerances (f32 on both sides, other summation orders): `encode` and
`decode_step` atol 1e-5; rollouts: equal actions, rewards atol 1e-5,
log-likelihoods atol 1e-4; loss atol 2e-5 and gradients rtol 1e-3, atol 1e-5
(`test_torch_reinforce.py`'s); the baseline's value rtol 1e-6; Adam's first
update in units of lr, atol 0.02, where the JAX gradient exceeds 1e-5, and
bounded by lr everywhere (`test_torch_reinforce.py` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.zoo.ptrnet import PointerNetwork as JaxPtrNet
from rl4co_tpu.models.zoo.ptrnet import PointerNetworkModel as JaxModel
from rl4co_tpu.models.zoo.ptrnet import ptrnet_rollout as jax_ptrnet_rollout
from rl4co_tpu.rl.reinforce import TrainState
from rl4co_tpu_torch.convert import convert_params, load_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.zoo.ptrnet import (
    LSTMCell,
    PointerNetwork,
    PointerNetworkModel,
    PointerNetworkPolicy,
    ptrnet_rollout,
)

from _torch_port import random_locs, t2n, tree_to_jax, tree_to_numpy

torch.set_num_threads(1)

N, B, E, H = 8, 6, 16, 12
KEY = jax.random.PRNGKey(0)


def pair(seed=0):
    tree = random_params_numpy(seed, E, policy="ptrnet", hidden_dim=H)
    jpol = JaxPtrNet(embed_dim=E, hidden_dim=H)
    tpol = PointerNetwork(embed_dim=E, hidden_dim=H, device="cpu")
    return jpol, tree_to_jax(tree), load_params(tpol, tree)


def test_the_tree_and_the_cell():
    jpol, params, tpol = pair()
    init = jax.eval_shape(lambda k: jpol.init(k, jnp.zeros((2, N, 2))), KEY)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(init["params"])}
    ours = {"/".join(path): arr.shape for path, arr in flatten_tree(
        random_params_numpy(0, E, policy="ptrnet", hidden_dim=H))}
    assert flat == ours
    assert set(convert_params(tree_to_numpy(params["params"]))) == set(tpol.state_dict())
    # one bias per gate, as Flax's cell: no second bias to drift under Adam
    cell = LSTMCell(E, H)
    assert sorted(n for n, _ in cell.named_parameters() if n.endswith("bias")) == [
        f"h{g}.bias" for g in "fgio"]
    assert PointerNetworkPolicy is PointerNetwork


def test_encode_and_decode_step_match_jax():
    jpol, params, tpol = pair(seed=1)
    locs = random_locs(3, B, N)
    j_emb, j_out, (j_c, j_h) = jpol.apply(params, jnp.asarray(locs), method="encode")
    with torch.no_grad():
        t_emb, t_out, (t_c, t_h) = tpol.encode(torch.from_numpy(locs))
    for got, want in ((t_emb, j_emb), (t_out, j_out), (t_c, j_c), (t_h, j_h)):
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)
    rs = np.random.RandomState(4)
    inp = rs.standard_normal((B, E)).astype(np.float32)
    carry = [rs.standard_normal((B, H)).astype(np.float32) for _ in range(2)]
    j_scores, (j_c2, j_h2) = jpol.apply(params, tuple(map(jnp.asarray, carry)), jnp.asarray(inp),
                                        j_out, None, method="decode_step")
    with torch.no_grad():
        t_scores, (t_c2, t_h2) = tpol.decode_step(tuple(map(torch.from_numpy, carry)),
                                                  torch.from_numpy(inp), t_out)
    for got, want in ((t_scores, j_scores), (t_c2, j_c2), (t_h2, j_h2)):
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16-ignored"])
def test_greedy_rollout_matches_jax(compute_dtype):
    jpol, params, tpol = pair(seed=2)
    locs = random_locs(5, B, N)
    spec = dict(kind="greedy", tanh_clipping=10.0, compute_dtype=compute_dtype)
    want = jax_ptrnet_rollout(jpol, params, jax_get_env("tsp", num_loc=N),
                              {"locs": jnp.asarray(locs)}, KEY, JaxSpec(**spec))
    env = get_env("tsp", num_loc=N)
    with torch.no_grad():
        got = ptrnet_rollout(tpol, env, {"locs": locs}, DecodeSpec(**spec), device="cpu")
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), atol=1e-5)
    np.testing.assert_allclose(t2n(got.log_likelihood), np.asarray(want.log_likelihood),
                               atol=1e-4)
    np.testing.assert_allclose(t2n(got.entropy), np.asarray(want.entropy), atol=1e-4)
    env.check_solution_validity({}, t2n(got.actions))


def test_loss_and_every_gradient_on_replayed_actions_match_jax():
    """The JAX model's loss (its formula, `ptrnet.py:151-157`) on actions a
    sampling rollout drew, replayed on both sides, with the baseline's first
    value (the batch mean)."""
    jpol, params, tpol = pair(seed=3)
    locs = {"locs": random_locs(6, B, N)}
    env = get_env("tsp", num_loc=N)
    with torch.no_grad():
        sampled = ptrnet_rollout(tpol, env, locs, DecodeSpec(kind="sampling", tanh_clipping=10.0),
                                 generator=torch.Generator().manual_seed(7), device="cpu")
    actions = t2n(sampled.actions)
    spec = JaxSpec(kind="evaluate", tanh_clipping=10.0)

    def jax_loss(p):
        out = jax_ptrnet_rollout(jpol, p, jax_get_env("tsp", num_loc=N),
                                 {"locs": jnp.asarray(locs["locs"])}, KEY, spec,
                                 replay_actions=jnp.asarray(actions))
        return -((out.reward - out.reward.mean()) * out.log_likelihood).mean()

    jloss, jgrads = jax.value_and_grad(jax_loss)(params)
    model = PointerNetworkModel(env, tpol)
    tloss, (metrics, out) = model.loss(locs, replay_actions=torch.from_numpy(actions))
    np.testing.assert_array_equal(t2n(out.actions), actions)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-5)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads["params"])).items()}
    for name, p in tpol.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_three_train_steps_match_the_jax_step():
    """The JAX model's jitted train step (greedy train spec, so both sides take
    the same actions) three times against `PointerNetworkModel.update` on the
    instances it generated: loss, reward and the moving baseline after every
    step (the batch mean, then 0.8 · old + 0.2 · mean), and the parameters
    after Adam's first step."""
    jpol, params, tpol = pair(seed=4)
    spec = dict(kind="greedy", tanh_clipping=10.0)
    jenv, env = jax_get_env("tsp", num_loc=N), get_env("tsp", num_loc=N)
    jmodel = JaxModel(env=jenv, policy=jpol, train_spec=JaxSpec(**spec))
    state = TrainState(params=params, opt_state=jmodel_tx(jmodel).init(params),
                       baseline_state=jnp.float32(jnp.nan), step=jnp.int32(0))
    step = jmodel.make_train_step(B, donate=False)
    model = PointerNetworkModel(env, tpol, train_spec=DecodeSpec(**spec))
    start = {k: p.detach().clone() for k, p in tpol.named_parameters()}
    key = jax.random.PRNGKey(11)
    rewards = []
    for i in range(3):
        kd, _ = jax.random.split(jax.random.fold_in(key, state.step))
        inst = {"locs": np.asarray(jenv.generate_batch(kd, B)["locs"])}
        if i == 0:
            jgrads = jax.grad(lambda p: first_loss(jpol, p, jenv, inst, spec))(state.params)
        state, jm = step(state, key)
        tm = model.update(inst)
        rewards.append(float(jm["reward"]))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), atol=2e-5)
        np.testing.assert_allclose(tm["reward"].item(), rewards[-1], atol=1e-5)
        np.testing.assert_allclose(model.baseline_value.item(), float(state.baseline_state),
                                   rtol=1e-6)
        if i == 0:
            check_adam_step(tpol, start, state.params, jgrads)
    assert model.step == int(state.step) == 3
    want = rewards[0]
    for r in rewards[1:]:
        want = 0.8 * want + 0.2 * r
    np.testing.assert_allclose(model.baseline_value.item(), want, rtol=1e-6)


def flatten_tree(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jmodel_tx(jmodel):
    import optax

    return optax.chain(optax.clip_by_global_norm(jmodel.grad_clip), optax.adam(jmodel.lr))


def first_loss(jpol, params, jenv, inst, spec):
    out = jax_ptrnet_rollout(jpol, params, jenv, {"locs": jnp.asarray(inst["locs"])}, KEY,
                             JaxSpec(**spec))
    return -((out.reward - out.reward.mean()) * out.log_likelihood).mean()


def check_adam_step(tpol, start, jnew, jgrads, lr=1e-4):
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jnew["params"])).items()}
    jg = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads["params"])).items()}
    moved = 0.0
    for name, p in tpol.named_parameters():
        got = p.detach().numpy()
        moved = max(moved, np.abs(got - start[name].numpy()).max())
        t_upd = (got - start[name].numpy()) / lr
        j_upd = (want[name] - start[name].numpy()) / lr
        assert np.abs(t_upd).max() <= 1.0 + 5e-3, name
        clear = np.abs(jg[name]) > 1e-5
        np.testing.assert_allclose(t_upd[clear], j_upd[clear], rtol=0, atol=0.02, err_msg=name)
    assert moved > 5e-5
