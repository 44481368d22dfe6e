"""The port's REINFORCE against `rl4co_tpu/rl/reinforce.py`: loss, the six
metrics and every parameter's gradient against `jax.grad(algo.loss)` on the
same instances, then one full train step.

The two frameworks' random streams cannot be matched, so the train spec is
greedy on both sides (actions are asserted equal first), and the rollout
baseline's snapshot differs from the live weights (else the advantage, and
with it every gradient, is zero). JAX gradients come back through
`convert.convert_params`: the map is linear, so it carries gradients as it
carries weights.

Tolerances: loss and metrics atol 2e-5 (means of sums of 10 f32 log-probs);
gradients rtol 1e-3, atol 1e-5 (f32 on both sides, other summation orders
through the encoder's batch-norm statistics and 10 decode steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.rl import baselines as jbl
from rl4co_tpu.rl.reinforce import REINFORCE as JaxREINFORCE
from rl4co_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from rl4co_tpu_torch.convert import convert_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.zoo.am import AttentionModel
from rl4co_tpu_torch.rl import baselines as tbl
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig

from _torch_port import SMALL, policy_pair, random_locs, t2n, tree_to_numpy

torch.set_num_threads(1)

N, B = 10, 8
METRICS = ("loss", "reinforce_loss", "bl_loss", "reward", "bl_val", "entropy")
KEY = jax.random.PRNGKey(0)
EMA = -3.5  # the warm-up's moving value, as if some steps had been taken


def snapshot_pair(seed=1):
    """Other weights than the live ones, for the baseline's snapshot."""
    _, jparams, tpol = policy_pair(seed=seed)
    return jparams, tpol


def make_pair(kind, jimpl="xla", optimizer="adam", lr=1e-4):
    """(JAX algo, its params, its baseline state, the port's algo) on the
    same weights; ``kind`` is "rollout" (behind a two-epoch warm-up at epoch
    1, so alpha = 0.5) or "shared" (multistart)."""
    jpol, jparams, tpol = policy_pair(seed=0, jax_pointer_impl=jimpl)
    tpol.train().requires_grad_(True)
    if kind == "rollout":
        spec = dict(kind="greedy", tanh_clipping=10.0)
        jbase = jbl.WarmupBaseline(inner=jbl.RolloutBaseline(), n_epochs=2)
        tbase = tbl.WarmupBaseline(inner=tbl.RolloutBaseline(), n_epochs=2)
    else:
        spec = dict(kind="greedy", tanh_clipping=10.0, multistart=True, num_starts=N)
        jbase, tbase = jbl.SharedBaseline(num_repeats=N), tbl.SharedBaseline(num_repeats=N)
    jalgo = JaxREINFORCE(env=jax_get_env("tsp", num_loc=N), policy=jpol, baseline=jbase,
                         train_spec=JaxSpec(**spec), optimizer=optimizer, lr=lr)
    talgo = REINFORCE(get_env("tsp", num_loc=N), tpol, baseline=tbase,
                      train_spec=DecodeSpec(**spec), optimizer=optimizer, lr=lr)
    jstate = jbl.BaselineState()
    if kind == "rollout":
        jsnap, tsnap = snapshot_pair()
        jstate = jbl.BaselineState(value=jnp.float32(EMA), bl_params=jsnap, epoch=jnp.int32(1))
        talgo.baseline_state = tbl.BaselineState(
            value=torch.tensor(EMA), bl_policy=tsnap.requires_grad_(False), epoch=1)
    return jalgo, jparams, jstate, talgo


def named_grads(jgrads):
    """A JAX gradient tree as {torch parameter name: numpy array}."""
    return {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["rollout", "shared"])
def test_loss_metrics_and_every_gradient_match_jax(kind, jimpl):
    jalgo, jparams, jstate, talgo = make_pair(kind, jimpl)
    locs = random_locs(7, B, N)
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, jstate, {"locs": jnp.asarray(locs)}, KEY)
    tloss, (tmetrics, tout) = talgo.loss({"locs": torch.from_numpy(locs)})
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert tloss.requires_grad and tout.log_likelihood.requires_grad
    assert set(tmetrics) == set(METRICS) == set(jmetrics)
    for name in METRICS:
        assert not tmetrics[name].requires_grad, name
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-5)
    assert abs(tloss.item()) > 1e-3  # a zero advantage would make the rest vacuous

    tloss.backward()
    want = named_grads(jgrads)
    got = {k: p.grad for k, p in talgo.policy.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2
    if kind == "rollout":  # the snapshot took no gradient and no graph
        assert all(p.grad is None for p in talgo.baseline_state.bl_policy.parameters())


@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.1), ("adam", 1e-4)])
def test_one_full_train_step_matches_the_jax_step(optimizer, lr):
    """generate aside: rollout → loss → backward → clip 1.0 → optimiser step
    → baseline update, from identical weights on the same instances.

    sgd: parameters atol 2e-6 (lr 0.1 times the gradients' atol 1e-5, and the
    clip scale agrees to 1e-3 relative). adam: its first update is
    ``lr · g/(|g| + 1e-8)``, which turns a gradient that is rounding noise
    around an exact zero (a bias in front of batch norm, the key bias of a
    softmax) into anything between ±lr; so the update is compared in units of
    lr, atol 0.02, where the JAX gradient exceeds 1e-5, and bounded by lr
    everywhere."""
    jalgo, jparams, jstate, talgo = make_pair("rollout", optimizer=optimizer, lr=lr)
    locs = random_locs(8, B, N)
    start = {k: p.detach().clone() for k, p in talgo.policy.named_parameters()}

    tx = jalgo.make_optimizer()
    opt_state = tx.init(jparams)
    jgrads, (jmetrics, jout) = jax.grad(jalgo.loss, has_aux=True)(
        jparams, jstate, {"locs": jnp.asarray(locs)}, KEY)
    updates, opt_state = tx.update(jgrads, opt_state, jparams)
    jnew = optax.apply_updates(jparams, updates)
    jstate = jalgo.baseline.update_step(jstate, jout.reward)

    tmetrics = talgo.update({"locs": torch.from_numpy(locs)})
    assert talgo.step == 1 and talgo.optimizer.count == 1
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), atol=2e-5)
    np.testing.assert_allclose(talgo.optimizer.grad_norm.item(),
                               float(optax.global_norm(jgrads)), rtol=1e-3)
    np.testing.assert_allclose(talgo.baseline_state.value.item(), float(jstate.value),
                               atol=1e-6)
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jnew)).items()}
    jg = named_grads(jgrads)
    moved = 0.0
    for name, p in talgo.policy.named_parameters():
        got = p.detach().numpy()
        moved = max(moved, np.abs(got - start[name].numpy()).max())
        if optimizer == "sgd":
            np.testing.assert_allclose(got, want[name], rtol=0, atol=2e-6, err_msg=name)
        else:
            t_upd = (got - start[name].numpy()) / lr
            j_upd = (want[name] - start[name].numpy()) / lr
            assert np.abs(t_upd).max() <= 1.0 + 5e-3, name
            clear = np.abs(jg[name]) > 1e-5
            # start + lr·u rounds to f32 at the parameter's size: 6e-8 / 1e-4
            np.testing.assert_allclose(t_upd[clear], j_upd[clear], rtol=0, atol=0.02,
                                       err_msg=name)
    assert moved > (1e-3 if optimizer == "sgd" else 5e-5)


def test_replayed_actions_give_the_sampled_rollouts_loss_and_gradients():
    """`loss(instances, replay_actions)` on the actions a sampling rollout
    drew reproduces that rollout's loss and gradients (what `chip_smoke.py`
    uses to hold the kernel path against the plain path on the card)."""
    _, _, _, talgo = make_pair("rollout")
    talgo.train_spec = DecodeSpec(kind="sampling", tanh_clipping=10.0)
    talgo.reseed(3)
    inst = {"locs": torch.from_numpy(random_locs(9, B, N))}
    loss, (_, out) = talgo.loss(inst)
    loss.backward()
    first = {k: p.grad.clone() for k, p in talgo.policy.named_parameters()}
    assert len({tuple(a) for a in t2n(out.actions)}) > 1
    talgo.optimizer.zero_grad()
    loss2, (_, out2) = talgo.loss(inst, replay_actions=out.actions)
    loss2.backward()
    assert torch.equal(out2.actions, out.actions)
    np.testing.assert_allclose(loss2.item(), loss.item(), atol=1e-6)
    for k, p in talgo.policy.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), first[k].numpy(), atol=1e-6, err_msg=k)


def test_baseline_rollout_and_eval_step_build_no_graph():
    _, _, _, talgo = make_pair("rollout")
    inst = {"locs": torch.from_numpy(random_locs(10, B, N))}
    r = talgo.greedy_reward_fn()(talgo.policy, inst)   # the live policy requires grad
    assert not r.requires_grad and r.grad_fn is None
    m = talgo.make_eval_step()(inst)
    assert set(m) == {"reward", "max_reward"}
    assert not m["reward"].requires_grad and m["max_reward"] >= m["reward"]
    bl_val, bl_loss = talgo.baseline.eval(talgo.baseline_state, inst, r,
                                          talgo.greedy_reward_fn())
    assert not bl_val.requires_grad and bl_loss.item() == 0.0


def test_eval_step_matches_jax():
    jalgo, jparams, _, talgo = make_pair("rollout")
    locs = random_locs(11, B, N)
    jm = jalgo.make_eval_step()(jparams, {"locs": jnp.asarray(locs)}, KEY)
    tm = talgo.make_eval_step()({"locs": locs})
    for k in ("reward", "max_reward"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)


def test_train_step_generates_from_the_reseeded_generator():
    """Two algorithms reseeded alike draw the same batches and samples."""
    def run():
        torch.manual_seed(0)
        algo = AttentionModel(get_env("tsp", num_loc=6), baseline="mean",
                              policy_kwargs=dict(device="cpu", **SMALL),
                              train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
        algo.reseed(5, 0)
        return [algo.train_step(4)["reward"].item() for _ in range(2)], algo

    (a, algo), (b, _) = run(), run()
    assert a == b and algo.step == 2
    algo.reseed(5, 1)
    assert algo.train_step(4)["reward"].item() != a[0]


def test_options_that_are_not_ported_raise():
    """A ``model`` axis needs as many processes as the mesh has devices (the
    JAX package's `make_mesh` asserts ``dp * model`` devices); the Trainer
    refuses a mesh for a loss with batch means of its own
    (``data_parallel`` false)."""
    from rl4co_tpu_torch.models.zoo.mdam import MDAM, MDAMPolicy
    from rl4co_tpu_torch.parallel.mesh import Mesh, make_mesh

    with pytest.raises(ValueError, match=r"dp\(0\) \* model\(2\) != ranks\(1\)"):
        make_mesh(model=2)
    algo = MDAM(get_env("tsp", num_loc=6), MDAMPolicy(device="cpu", embed_dim=16, num_heads=2,
                                                      num_encoder_layers=1))
    assert not algo.data_parallel
    trainer = Trainer(algo, TrainerConfig(epochs=1, batch_size=4, train_data_size=8,
                                          val_data_size=4), mesh=Mesh(rank=0, world=2))
    with pytest.raises(ValueError, match="data-parallel"):
        trainer.fit()


def test_attention_model_defaults_are_the_published_recipe():
    algo = AttentionModel(get_env("tsp", num_loc=6),
                          policy_kwargs=dict(device="cpu", **SMALL))
    assert isinstance(algo, REINFORCE)
    assert isinstance(algo.baseline, tbl.WarmupBaseline) and algo.baseline.n_epochs == 1
    assert isinstance(algo.baseline.inner, tbl.RolloutBaseline)
    assert algo.train_spec.kind == "sampling" and algo.val_spec.kind == "greedy"
    assert not algo.train_spec.select_best
    assert isinstance(algo.optimizer.inner, torch.optim.Adam)
    assert algo.optimizer.schedule(0) == 1e-4 and algo.optimizer.grad_clip == 1.0
    assert algo.baseline_state.bl_policy is not algo.policy


def test_state_dict_round_trip_restores_every_part(tmp_path):
    """Through a checkpoint file: `state_dict` hands out the live tensors, as
    `nn.Module.state_dict` does."""
    _, _, _, a = make_pair("rollout")
    inst = {"locs": torch.from_numpy(random_locs(12, B, N))}
    a.update(inst)
    path = save_checkpoint(str(tmp_path / "ck" / "one.pt"), {"state": a.state_dict()})
    state = restore_checkpoint(path, map_location="cpu")["state"]
    _, _, _, b = make_pair("rollout")
    b.load_state_dict(state)
    assert b.step == 1 and b.optimizer.count == 1 and b.baseline_state.epoch == 1
    assert b.baseline_state.bl_policy is not a.baseline_state.bl_policy
    for (k, p), (_, q) in zip(a.policy.named_parameters(), b.policy.named_parameters()):
        assert torch.equal(p, q), k
    for p, q in zip(a.baseline_state.bl_policy.parameters(),
                    b.baseline_state.bl_policy.parameters()):
        assert torch.equal(p, q) and not q.requires_grad
    ma, mb = a.update(inst), b.update(inst)
    assert ma["loss"].item() == mb["loss"].item()
    for p, q in zip(a.policy.parameters(), b.policy.parameters()):
        assert torch.equal(p, q)
    _, _, _, c = make_pair("shared")
    with pytest.raises(ValueError, match="baseline"):
        c.load_state_dict(state)
