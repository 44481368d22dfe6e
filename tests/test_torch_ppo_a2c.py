"""The port's PPO, A2C, critic, reward scaler and DenseRewardTSP against the
JAX package's (`rl4co_tpu/rl/{ppo,a2c,critic,utils}.py`,
`rl4co_tpu/envs/routing/tsp.py::DenseRewardTSP`), and the golden files of
the chip phases `train_ppo_tsp50` and `train_a2c_tsp50`.

The two frameworks' random streams cannot be matched, so the port replays
the JAX package's draws: its sampled actions and, for PPO, its
`jax.random.permutation` minibatch blocks. The JAX side of a PPO step is its
own `_minibatch_loss` and optimiser in a Python loop (`jax_ppo_step`), held
first to `make_train_step` on the same key.

Tolerances: critic values atol 1e-5; reward scaler rtol 1e-6; A2C's
metrics and PPO's first minibatch's atol 2e-5 plus rtol 1e-5, PPO's later
minibatches' rtol 1e-4 (each Adam step moves both sides' parameters, whose
last bits differ, and the next minibatch's loss with them);
gradients rtol 1e-3 plus atol 1e-5 of the largest gradient (PPO's and A2C's
reach 4 to 10, where `test_torch_reinforce.py`'s atol 1e-5 was 1e-3 of
them); parameters after a step of Adam compared in units of the learning
rate, atol 0.05, where the JAX gradient exceeds 1e-5 (Adam turns rounding
noise around an exact zero into anything up to ±lr).

`python tests/test_torch_ppo_a2c.py` rewrites the golden files
(`rl4co_tpu_torch/golden/{ppo_a2c_tsp50,ppo_tsp50_grads,a2c_tsp50_grads}.npz`)
with the JAX package on the CPU in f32: AM from the committed TSP-50
checkpoint (`golden/am_tsp50_params.npz`), a critic from
`random_params_numpy(CRITIC_SEED, policy="critic")`, one PPO step and one A2C
step at batch 512 (about two minutes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
from rl4co_tpu.rl.a2c import A2C as JaxA2C
from rl4co_tpu.rl.critic import CriticNetwork as JaxCritic
from rl4co_tpu.rl.ppo import PPO as JaxPPO
from rl4co_tpu.rl.reinforce import TrainState
from rl4co_tpu_torch.convert import convert_params, load_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.rl.a2c import A2C
from rl4co_tpu_torch.rl.critic import CriticNetwork
from rl4co_tpu_torch.rl.ppo import PPO

from _torch_port import (
    SMALL,
    am_pair,
    env_pair,
    jax_instances,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    tree_to_numpy,
)

torch.set_num_threads(1)

PPO_METRICS = ("loss", "surrogate_loss", "value_loss", "entropy")
A2C_METRICS = ("loss", "reinforce_loss", "bl_loss", "reward", "bl_val", "entropy")
CRITIC_SEED = 7


def critic_pair(env_name, seed=CRITIC_SEED, **dims):
    """The same seeded critic weights as (JAX critic, its params, the
    port's critic on the CPU)."""
    dims = {**SMALL, **dims}
    tree = random_params_numpy(seed, dims["embed_dim"], dims["num_encoder_layers"],
                               dims["feedforward_hidden"], policy="critic", env_name=env_name)
    jc = JaxCritic(env_name=env_name, **dims)
    tc = load_params(CriticNetwork(env_name=env_name, device="cpu", **dims), tree)
    return jc, tree_to_jax(tree), tc


def assert_gradients_close(got, want):
    """Every gradient of ``got`` ({name: tensor}) within rtol 1e-3 plus atol
    1e-5 of the largest of ``want`` ({name: numpy})."""
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 1e-2  # a vanishing gradient would make the check vacuous
    for name, g in got.items():
        np.testing.assert_allclose(t2n(g), want[name], rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


def named(tree):
    """A JAX tree (params or gradients) as {torch parameter name: numpy}."""
    return {k: v.numpy() for k, v in convert_params(tree_to_numpy(tree)).items()}


@pytest.mark.parametrize("env_name", ["tsp", "cvrp", "smtwtp"])
def test_critic_forward_matches_jax(env_name):
    jc, jparams, tc = critic_pair(env_name)
    _, jenv = env_pair(env_name, 8)
    inst = jax_instances(jenv, 1, 6)
    want = np.asarray(jc.apply(jparams, to_jax(inst)))
    with torch.no_grad():
        got = t2n(tc(to_torch(inst)))
    assert got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reward_scaler_matches_jax():
    from rl4co_tpu.rl import utils as jutils
    from rl4co_tpu_torch.rl import utils as tutils

    rs = np.random.RandomState(0)
    js, ts = jutils.RewardScalerState.init(), tutils.RewardScalerState.init()
    for size in (8, 3, 16):
        x = (rs.standard_normal(size) * 3 - 5).astype(np.float32)
        js = jutils.reward_scaler_update(js, jnp.asarray(x))
        ts = tutils.reward_scaler_update(ts, torch.from_numpy(x))
        for f in ("count", "mean", "m2"):
            np.testing.assert_allclose(getattr(ts, f).item(), float(getattr(js, f)), rtol=1e-6)
        for kind in ("scale", "norm"):
            np.testing.assert_allclose(
                t2n(tutils.reward_scaler_transform(ts, torch.from_numpy(x), kind)),
                np.asarray(jutils.reward_scaler_transform(js, jnp.asarray(x), kind)),
                rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tutils.reward_scaler_transform(ts, torch.zeros(2), "other")


def test_dense_reward_tsp_steps_as_jax():
    """`DenseRewardTSP.step_with_reward` stepped beside the JAX package's on
    the same random tours, one step past the end: equal states, rewards
    within 1e-6, their sum the closed tour's negative length."""
    from rl4co_tpu.envs import DenseRewardTSP as JaxDense
    from rl4co_tpu_torch.envs import DenseRewardTSP

    from test_torch_env_op_pctsp import assert_states_equal

    n, b = 7, 6
    tenv, jenv = DenseRewardTSP(num_loc=n), JaxDense(num_loc=n)
    inst = jax_instances(jenv, 4, b)
    rs = np.random.RandomState(4)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    total, acts = np.zeros(b), []
    for _ in range(n + 1):
        act = np.array([rs.choice(np.flatnonzero(m)) for m in t2n(tenv.action_mask(ts))])
        acts.append(act)
        ts, r_t = tenv.step_with_reward(ts, torch.from_numpy(act))
        js, r_j = jenv.step_with_reward_batch(js, jnp.asarray(act, dtype=jnp.int32))
        assert_states_equal(ts, js)
        np.testing.assert_allclose(t2n(r_t), np.asarray(r_j), rtol=1e-6, atol=1e-7)
        total += t2n(r_t)
    assert t2n(ts.done).all() and (t2n(r_t) == 0).all()
    tour = torch.from_numpy(np.stack(acts[:n], axis=1))
    np.testing.assert_allclose(total, t2n(tenv.reward(ts, tour)), rtol=1e-5)


# ------------------------------------------------------------------- PPO

def jax_ppo_step(algo, params, key, batch_size, instances=None):
    """One PPO step of the JAX package as `make_train_step` takes it (the
    same keys, instances, rollout and minibatch blocks), its minibatches in
    a Python loop: returns the draws, every minibatch's metrics, the first
    minibatch's gradients and the parameters after the step."""
    tx = algo.make_optimizer()
    opt_state = tx.init(params)
    kdata, kroll, kperm = jax.random.split(jax.random.fold_in(key, 0), 3)
    if instances is None:
        instances = algo.env.generate_batch(kdata, batch_size)
    out = jax_rollout(algo.policy, params["policy"], algo.env, instances, kroll,
                      algo.train_spec)
    mb = max(1, int(batch_size * algo.mini_batch_fraction))
    num_mb = batch_size // mb
    blocks = jnp.concatenate([
        jax.random.permutation(jax.random.fold_in(kperm, e), batch_size)[: num_mb * mb]
        .reshape(num_mb, mb) for e in range(algo.ppo_epochs)])
    metrics, first = [], None
    grad_fn = jax.jit(jax.grad(algo._minibatch_loss, has_aux=True))
    for idx in blocks:
        take = lambda x: jnp.take(x, idx, axis=0)  # noqa: E731
        grads, m = grad_fn(params, jax.tree_util.tree_map(take, instances), take(out.actions),
                           take(out.log_likelihood), take(out.reward), kroll)
        first = grads if first is None else first
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"instances": {k: np.asarray(v) for k, v in instances.items()},
            "actions": np.asarray(out.actions), "reward": np.asarray(out.reward),
            "blocks": np.asarray(blocks), "metrics": metrics, "first_grads": first,
            "params": params}


def port_ppo_update(talgo, instances, actions, blocks):
    """`talgo.update` on the JAX draws, recording every minibatch's metrics
    and the first minibatch's gradients (before clipping)."""
    recorded, first = [], {}
    inner_loss, inner_step = talgo.minibatch_loss, talgo.optimizer.step

    def minibatch_loss(*args):
        loss, m = inner_loss(*args)
        recorded.append({k: v.item() for k, v in m.items()})
        return loss, m

    def step():
        if not first:
            for prefix, mod in (("policy", talgo.policy), ("critic", talgo.critic)):
                first.update({f"{prefix}.{n}": p.grad.clone() for n, p in mod.named_parameters()})
        inner_step()

    talgo.minibatch_loss, talgo.optimizer.step = minibatch_loss, step
    try:
        metrics = talgo.update(instances, replay_actions=torch.as_tensor(actions),
                               minibatches=torch.as_tensor(blocks))
    finally:
        del talgo.minibatch_loss, talgo.optimizer.step
    return metrics, recorded, first


def ppo_pair(normalize_adv, n=8):
    jpol, jparams, tpol = am_pair("tsp", seed=0)
    jc, jcparams, tc = critic_pair("tsp")
    tenv, jenv = env_pair("tsp", n)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxPPO(env=jenv, policy=jpol, critic=jc, normalize_adv=normalize_adv,
                   train_spec=JaxSpec(**spec))
    talgo = PPO(tenv, tpol.train(), critic=tc, normalize_adv=normalize_adv,
                train_spec=DecodeSpec(**spec))
    return jalgo, {"policy": jparams, "critic": jcparams}, talgo


def both_named(params):
    return {**{f"policy.{k}": v for k, v in named(params["policy"]).items()},
            **{f"critic.{k}": v for k, v in named(params["critic"]).items()}}


@pytest.mark.parametrize("normalize_adv", [False, True])
def test_ppo_step_matches_jax(normalize_adv):
    """One PPO step on TSP-8, batch 8 (minibatches of 2, 4 per epoch, 2
    epochs), the JAX draws replayed: every minibatch's metrics, the first
    minibatch's every gradient, the parameters after the step."""
    jalgo, params, talgo = ppo_pair(normalize_adv)
    key, b = jax.random.PRNGKey(3), 8
    want = jax_ppo_step(jalgo, params, key, b)
    # the replica is the JAX package's step
    state = TrainState(params=params, opt_state=jalgo.make_optimizer().init(params),
                       baseline_state=None, step=jnp.int32(0))
    _, last = jalgo.make_train_step(b, donate=False)(state, key)
    for k in PPO_METRICS:
        np.testing.assert_allclose(want["metrics"][-1][k], float(last[k]), rtol=1e-5, atol=1e-6)
    assert want["blocks"].shape == (8, 2)

    start = {f"{p}.{n}": t.detach().clone() for p, mod in (("policy", talgo.policy),
                                                           ("critic", talgo.critic))
             for n, t in mod.named_parameters()}
    metrics, recorded, first = port_ppo_update(talgo, want["instances"], want["actions"],
                                               want["blocks"])
    assert talgo.step == 1 and talgo.optimizer.count == 8 and len(recorded) == 8
    np.testing.assert_allclose(metrics["reward"].item(), want["reward"].mean(), rtol=1e-6)
    for i, (got, exp) in enumerate(zip(recorded, want["metrics"])):
        for k in PPO_METRICS:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-5 if i == 0 else 1e-4, atol=2e-5,
                                       err_msg=(i, k))
    assert abs(want["metrics"][0]["surrogate_loss"]) > 1e-3
    grads = both_named(want["first_grads"])
    assert_gradients_close(first, grads)
    after = both_named(want["params"])
    lr = 1e-4
    for p, mod in (("policy", talgo.policy), ("critic", talgo.critic)):
        for n, t in mod.named_parameters():
            name = f"{p}.{n}"
            t_upd = (t2n(t) - t2n(start[name])) / lr
            j_upd = (after[name] - t2n(start[name])) / lr
            assert np.abs(t_upd).max() <= 8.05, name
            clear = np.abs(grads[name]) > 1e-5
            np.testing.assert_allclose(t_upd[clear], j_upd[clear], rtol=0, atol=0.05,
                                       err_msg=name)


def test_ppo_draws_its_own_actions_and_blocks():
    """Without replayed draws: the generator samples the actions, then one
    permutation per epoch, cut to ``num_mb · mb``; the same seed repeats the
    step. `minibatch_shape` is the JAX package's arithmetic."""
    _, _, talgo = ppo_pair(False)
    assert talgo.minibatch_shape(8) == (4, 2) and talgo.minibatch_shape(5) == (5, 1)
    assert talgo.minibatch_shape(10) == (5, 2)
    talgo.reseed(1)
    blocks = talgo.draw_minibatches(10)
    assert blocks.shape == (10, 2)
    for e in range(2):
        assert len(set(blocks[5 * e:5 * e + 5].flatten().tolist())) == 10
    inst = talgo.env.generate(8, torch.Generator().manual_seed(0), "cpu")
    states = []
    for _ in range(2):
        _, _, talgo = ppo_pair(False)
        talgo.reseed(5)
        talgo.update(inst)
        states.append([p.detach().clone() for p in talgo.policy.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*states))


# ------------------------------------------------------------------- A2C

def test_a2c_loss_gradients_and_step_match_jax():
    """A2C on CVRP-6, batch 8, critic_lr 5e-4 (`tests/test_ppo_a2c.py`'s
    setting), the JAX sampled actions replayed: the six metrics, every
    gradient of the policy and the critic, then one step (policy moved in
    units of lr, the critic in units of critic_lr)."""
    n, b, lr, critic_lr = 6, 8, 1e-4, 5e-4
    jpol, jparams, tpol = am_pair("cvrp", seed=0)
    jc, jcparams, tc = critic_pair("cvrp")
    tenv, jenv = env_pair("cvrp", n)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxA2C(env=jenv, policy=jpol, critic=jc, critic_lr=critic_lr,
                   train_spec=JaxSpec(**spec))
    talgo = A2C(tenv, tpol.train(), critic=tc, critic_lr=critic_lr,
                train_spec=DecodeSpec(**spec))
    params = {"policy": jparams, "critic": jcparams}
    inst = jax_instances(jenv, 5, b)
    key = jax.random.PRNGKey(9)
    jgrads, (jm) = jax.grad(jalgo.loss, has_aux=True)(params, None, to_jax(inst), key)
    out = jax_rollout(jpol, jparams, jenv, to_jax(inst), key, jalgo.train_spec)
    tx = jalgo.make_optimizer()
    updates, _ = tx.update(jgrads, tx.init(params), params)
    after = both_named(optax.apply_updates(params, updates))

    start = {f"{p}.{n}": t2n(t).copy() for p, mod in (("policy", talgo.policy),
                                                      ("critic", talgo.critic))
             for n, t in mod.named_parameters()}
    loss, (tm, tout) = talgo.loss(inst, replay_actions=torch.from_numpy(np.asarray(out.actions)))
    for k in A2C_METRICS:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=2e-5, err_msg=k)
    loss.backward()
    want = both_named(jgrads)
    got = {f"{p}.{n}": t.grad for p, mod in (("policy", talgo.policy), ("critic", talgo.critic))
           for n, t in mod.named_parameters()}
    assert_gradients_close(got, want)
    assert max(np.abs(w).max() for k, w in want.items() if k.startswith("critic")) > 1e-2
    talgo.optimizer.step()
    for name, t in [(f"{p}.{n}", t) for p, mod in (("policy", talgo.policy),
                                                   ("critic", talgo.critic))
                    for n, t in mod.named_parameters()]:
        unit = critic_lr if name.startswith("critic") else lr
        t_upd, j_upd = (t2n(t) - start[name]) / unit, (after[name] - start[name]) / unit
        assert np.abs(t_upd).max() <= 1.005, name
        clear = np.abs(want[name]) > 1e-5
        np.testing.assert_allclose(t_upd[clear], j_upd[clear], rtol=0, atol=0.02, err_msg=name)


def test_amppo_builds_ppo_with_a_mirrored_critic():
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models.zoo import AMPPO

    algo = AMPPO(get_env("tsp", num_loc=6), policy_kwargs=dict(SMALL, device="cpu"))
    assert isinstance(algo, PPO) and algo.device.type == "cpu"
    c = algo.critic
    assert c.GraphAttentionNetwork_0.num_layers == SMALL["num_encoder_layers"]
    assert c.Dense_0.in_features == SMALL["embed_dim"] and c.Dense_0.out_features == 256
    assert (algo.clip_range, algo.ppo_epochs, algo.mini_batch_fraction, algo.vf_lambda,
            algo.entropy_lambda, algo.optimizer.grad_clip) == (0.2, 2, 0.25, 0.5, 0.0, 0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CriticNetwork()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AMPPO(get_env("tsp", num_loc=6))


# ------------------------------------------------------------- golden files
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rl4co_tpu_torch", "golden")
GOLDEN_N, GOLDEN_BATCH = 50, 512
PPO_KEY, A2C_KEY = 17, 18
UPDATE_NOISE_SHARE = 1e-5


def load_golden(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return {k: f[k] for k in f.files}


def test_golden_files_shapes():
    g = load_golden("ppo_a2c_tsp50.npz")
    assert int(g["critic_seed"]) == CRITIC_SEED
    assert g["locs"].shape == (GOLDEN_BATCH, GOLDEN_N, 2)
    assert g["ppo/actions"].shape == g["a2c/actions"].shape == (GOLDEN_BATCH, GOLDEN_N)
    assert g["ppo/blocks"].shape == (8, 128)
    for e in range(2):
        assert sorted(g["ppo/blocks"][4 * e:4 * e + 4].flatten()) == list(range(GOLDEN_BATCH))
    assert g["ppo/metrics"].shape == (8, len(PPO_METRICS)) and np.isfinite(g["ppo/metrics"]).all()
    norms = [k for k in g if k.startswith("ppo/update_norm/")]
    grads = load_golden("ppo_tsp50_grads.npz")
    assert len(norms) == len(grads) > 50
    assert set(load_golden("a2c_tsp50_grads.npz")) == set(grads)


def save_grads(grads, name):
    """``{"policy": ..., "critic": ...}`` gradient trees as one compressed
    npz keyed by ``/``-joined paths (what `convert.load_params_npz` reads)."""
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = np.asarray(v, np.float32)

    walk({k: tree_to_numpy(v)["params"] for k, v in grads.items()}, ())
    np.savez_compressed(os.path.join(GOLDEN, name), **flat)


def write_golden():
    """The golden files from the JAX package on the CPU in f32."""
    import time

    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu_torch.convert import load_params_npz

    from _torch_port import JaxPolicy

    t0 = time.time()
    jenv = jax_get_env("tsp", num_loc=GOLDEN_N)
    jpol = JaxPolicy(env_name="tsp")
    jc = JaxCritic(env_name="tsp")
    ckpt = load_params_npz(os.path.join(GOLDEN, "am_tsp50_params.npz"))
    params = {"policy": tree_to_jax(ckpt.get("params", ckpt)),
              "critic": tree_to_jax(random_params_numpy(CRITIC_SEED, policy="critic"))}
    spec = JaxSpec(kind="sampling", tanh_clipping=10.0)
    ppo = JaxPPO(env=jenv, policy=jpol, critic=jc, train_spec=spec)
    got = jax_ppo_step(ppo, params, jax.random.PRNGKey(PPO_KEY), GOLDEN_BATCH)
    print("ppo", got["metrics"][0], got["metrics"][-1], time.time() - t0, flush=True)
    out = {"critic_seed": np.int64(CRITIC_SEED), "locs": got["instances"]["locs"],
           "ppo/actions": got["actions"].astype(np.int8),
           "ppo/blocks": got["blocks"].astype(np.int16),
           "ppo/metrics": np.array([[m[k] for k in PPO_METRICS] for m in got["metrics"]],
                                   np.float64)}
    # each leaf's update norm over its elements whose first-minibatch
    # gradient is not rounding noise around an exact zero (`chip_smoke.py`'s
    # UPDATE_NOISE_SHARE of the largest gradient)
    before, after = both_named(params), both_named(got["params"])
    grads = both_named(got["first_grads"])
    scale = max(np.abs(g).max() for g in grads.values())
    for name in before:
        clear = np.abs(grads[name]) > UPDATE_NOISE_SHARE * scale
        out[f"ppo/update_norm/{name}"] = np.float64(np.linalg.norm(
            (after[name].astype(np.float64) - before[name])[clear]))
    save_grads(got["first_grads"], "ppo_tsp50_grads.npz")

    a2c = JaxA2C(env=jenv, policy=jpol, critic=jc, train_spec=spec)
    inst, key = {"locs": jnp.asarray(out["locs"])}, jax.random.PRNGKey(A2C_KEY)
    grads, m = jax.grad(a2c.loss, has_aux=True)(params, None, inst, key)
    actions = jax_rollout(jpol, params["policy"], jenv, inst, key, spec).actions
    out["a2c/actions"] = np.asarray(actions).astype(np.int8)
    for k in A2C_METRICS:
        out[f"a2c/{k}"] = np.float64(m[k])
    print("a2c", {k: float(v) for k, v in m.items()}, time.time() - t0, flush=True)
    save_grads(grads, "a2c_tsp50_grads.npz")
    np.savez_compressed(os.path.join(GOLDEN, "ppo_a2c_tsp50.npz"), **out)


if __name__ == "__main__":
    write_golden()
