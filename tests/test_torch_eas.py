"""The port's transductive search (`rl4co_tpu_torch/models/zoo/eas.py`:
EAS-Emb, EAS-Lay, Active Search) against the JAX package's
(`rl4co_tpu/models/zoo/eas.py`), the train command line's ``--search``, and
the golden file of the chip phase `eas_pomo_cvrp50`.

The two frameworks' random streams cannot be matched, so the port replays
the JAX package's sampled actions. The JAX side of an iteration is its
search's loss written out (`jax_iteration`), which returns what the jitted
step hides (the sampled actions, both losses, the gradients); the golden
generator holds it to the module's own `search` on the same key (the
trained tensors after two iterations at rtol 1e-5 plus 1 % of the learning
rate, the best rewards rtol 1e-6).

Tolerances: the RL and IL losses rtol 1e-4 plus atol 1e-6; the gradients,
every element, within 1.7e-4 of the largest (Active Search's: 1e-3 of the
largest, the f32 floor of a gradient through every layer of the encoder);
AdamW's update in units of the learning rate, atol 0.05, where the JAX
gradient exceeds 1e-3 of the largest (its first step is ±lr for any
gradient above eps, so rounding noise around zero decides the sign); the
incumbents (best actions, have_best) equal and the best rewards rtol 1e-6;
three AdamW updates of the port against optax's adamw, rtol 1e-7. Before
its second iteration the port's trained tensors and incumbents are set to
the JAX package's (the AdamW moments stay its own), so that the sign noise
of the first update does not move the second iteration's inputs. (On the
full-width golden file two starts of one instance may reach tours whose
costs tie to the last bits; `chip_smoke.hold_incumbents` accounts for such
incumbents by their equal best rewards.)

`python tests/test_torch_eas.py` rewrites `rl4co_tpu_torch/golden/
eas_cvrp50.npz` with the JAX package on the CPU in f32: the POMO CVRP-50
checkpoint (`golden/pomo_cvrp50_params.npz`) on the first 4 instances of
`data/cvrp/test50_seed1234.npz` (×8 dihedral augments for EAS-Emb), two
EAS-Emb and two EAS-Lay iterations with their sampled actions, losses,
gradients, trained tensors and incumbents, and one Active Search iteration
with its sampled actions, loss, every leaf's gradient norm and update norm,
and the gradients of the leaves outside the encoder in full (3.5 MB; the
whole gradient would be 5 MB).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.data.transforms import augment_instances as jax_augment
from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.policies.constructive import rollout as jax_rollout
from rl4co_tpu.models.policies.constructive import rollout_from_cache as jax_from_cache
from rl4co_tpu.models.zoo import eas as jeas
from rl4co_tpu.utils.ops import unbatchify as jax_unbatchify
from rl4co_tpu_torch.convert import convert_eas_params, load_params_npz
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.zoo.eas import ActiveSearch, EASEmb, EASLay
from rl4co_tpu_torch.utils.optim import get_optimizer

from _torch_port import CVRP50_FILE, ROOT, pomo_pair, random_cvrp, t2n, to_jax

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "eas_cvrp50.npz")
GOLDEN_COUNT = 4
LOSS_RTOL = 1e-4
GRAD_GAUGE = 1.7e-4          # of the largest gradient
AS_GRAD_GAUGE = 1e-3
UPDATE_ATOL = 0.05           # in units of the learning rate
BIG_GRAD = 1e-3              # ... where |g| exceeds this share of the largest


def jax_iteration(kind, jpol, params, env, inst, trainable, opt_state, inc, key, tx,
                  embeddings=None, lam=0.013):
    """One iteration of the JAX package's EAS-Emb (``kind="emb"``), EAS-Lay
    (``"lay"``, on ``embeddings``) or Active Search (``"as"``, ``trainable``
    the policy's params): its loss, `jax.grad` and the optax update, and the
    incumbents' update. ``inc``: (best, best_actions, have_best)."""
    s = env.get_num_starts()
    spec = JaxSpec(kind="sampling", multistart=True, num_starts=s, tanh_clipping=10.0)
    spec_eval = dataclasses.replace(spec, kind="evaluate", multistart=False, num_starts=0)
    best, best_actions, have_best = inc

    def loss_fn(tr):
        if kind == "as":
            out = jax_rollout(jpol, tr, env, inst, key, spec)
        else:
            emb = tr if kind == "emb" else embeddings + jax.nn.relu(
                embeddings @ tr["w1"] + tr["b1"]) @ tr["w2"] + tr["b2"]
            cache = jpol.apply(params, emb, method="precompute")
            out = jax_from_cache(jpol, params, env, inst, cache, key, spec)
        reward = jax_unbatchify(out.reward, s)
        ll = jax_unbatchify(out.log_likelihood, s)
        rl = -((reward - reward.mean(axis=-1, keepdims=True)) * ll).mean()
        if kind == "as":
            return rl, (rl, jnp.zeros(()), reward, out.actions)
        out_best = jax_from_cache(jpol, params, env, inst, cache, key, spec_eval,
                                  replay_actions=best_actions)
        il = -jnp.where(have_best, out_best.log_likelihood, 0.0).mean()
        return rl + lam * il, (rl, il, reward, out.actions)

    grads, (rl, il, reward, actions) = jax.jit(jax.grad(loss_fn, has_aux=True))(trainable)
    updates, opt_state = tx.update(grads, opt_state, trainable)
    trainable = optax.apply_updates(trainable, updates)
    iter_best = reward.max(axis=-1)
    if kind == "as":
        best = jnp.maximum(best, iter_best)
    else:
        acts = jax_unbatchify(actions, s)
        iter_actions = jnp.take_along_axis(acts, reward.argmax(axis=-1)[:, None, None],
                                           axis=1)[:, 0]
        improved = iter_best > best
        best = jnp.where(improved, iter_best, best)
        best_actions = jnp.where(improved[:, None], iter_actions, best_actions)
        have_best = have_best | improved
    return dict(grads=grads, rl=float(rl), il=float(il), actions=np.asarray(actions),
                trainable=trainable, opt_state=opt_state,
                inc=(best, best_actions, have_best))


def jax_search_states(kind, jpol, params, env, inst, key, iters, lr, hidden_dim=0):
    """``iters`` iterations of `jax_iteration` from the start the JAX search
    takes (its augmentation, encoding, EAS-Lay's draw of ``w1`` and its key
    split), and that start."""
    if kind == "emb":
        inst = jax_augment(inst, 8, "dihedral8")
    tx = optax.adamw(lr, weight_decay=1e-6)
    embeddings = None if kind == "as" else jpol.apply(params, inst, method="encode")
    if kind == "emb":
        trainable = embeddings
    elif kind == "lay":
        d = embeddings.shape[-1]
        h = hidden_dim or d
        k0, key = jax.random.split(key)
        trainable = {"w1": 0.01 * jax.random.normal(k0, (d, h)), "b1": jnp.zeros((h,)),
                     "w2": jnp.zeros((h, d)), "b2": jnp.zeros((d,))}
    else:
        trainable = params
    b = jax.tree_util.tree_leaves(inst)[0].shape[0]
    inc = (jnp.full((b,), -jnp.inf), jnp.zeros((b, env.max_steps), jnp.int32),
           jnp.zeros((b,), bool))
    start = dict(trainable=trainable, inst=inst)
    opt_state, its = tx.init(trainable), []
    for it in range(iters):
        r = jax_iteration(kind, jpol, params, env, inst, trainable, opt_state, inc,
                          jax.random.fold_in(key, it), tx, embeddings)
        trainable, opt_state, inc = r["trainable"], r["opt_state"], r["inc"]
        its.append(r)
    return start, its


def check_iteration(got, want, lr, before, after, grad_gauge, what):
    """One port iteration against the JAX one (see the module docstring)."""
    np.testing.assert_allclose(float(got["rl_loss"] if "rl_loss" in got else got["loss"]),
                               want["rl"], rtol=LOSS_RTOL, atol=1e-6, err_msg=what)
    if "il_loss" in got:
        np.testing.assert_allclose(float(got["il_loss"]), want["il"], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=what)
    jg = jax_flat(want["grads"])
    tg = {k: t2n(v) for k, v in got["grads"].items()}
    assert set(jg) == set(tg), sorted(set(jg) ^ set(tg))
    scale = max(np.abs(g).max() for g in jg.values())
    for k, g in jg.items():
        np.testing.assert_allclose(tg[k], g, rtol=0, atol=grad_gauge * scale,
                                   err_msg=f"{what} gradient {k}")
    for k, g in jg.items():
        big = np.abs(g) > BIG_GRAD * scale
        np.testing.assert_allclose((after[k] - before[k])[big] / lr,
                                   (jax_flat(want["trainable"])[k] - before[k])[big] / lr,
                                   atol=UPDATE_ATOL, err_msg=f"{what} update {k}")


def jax_flat(tree):
    """A JAX tree of the trainable tensors under the port's names."""
    if isinstance(tree, dict) and set(tree) == {"w1", "b1", "w2", "b2"}:
        return {k: np.asarray(v) for k, v in tree.items()}
    if not isinstance(tree, dict):
        return {"embeddings": np.asarray(tree)}
    from rl4co_tpu_torch.convert import convert_params

    return {k: t2n(v) for k, v in convert_params(jax.tree_util.tree_map(np.asarray, tree)).items()}


def port_flat(trainable):
    return {k: t2n(v.detach()).copy() for k, v in trainable.items()}


def small_setup(seed=0):
    jpol, params, tpol = pomo_pair(seed, embed_dim=16, num_heads=2, num_encoder_layers=1,
                                   feedforward_hidden=32)
    inst = random_cvrp(seed + 1, 2, 6)
    return (jpol, params, tpol.train(), jax_get_env("cvrp", num_loc=6),
            get_env("cvrp", num_loc=6), inst)


@pytest.mark.parametrize("kind", ["emb", "lay", "as"])
def test_two_iterations_match_jax_on_replayed_actions(kind):
    jpol, params, tpol, jenv, tenv, inst = small_setup()
    lr = {"emb": 4.1e-3, "lay": 4.1e-3, "as": 2.6e-4}[kind]
    start, its = jax_search_states(kind, jpol, params, jenv, to_jax(inst),
                                   jax.random.PRNGKey(7), 2 if kind != "as" else 1, lr)
    if kind == "emb":
        search = EASEmb(tenv, tpol)
        state = search.init_state(inst)
        np.testing.assert_allclose(t2n(state.trainable["embeddings"]),
                                   np.asarray(start["trainable"]), atol=1e-5)
    elif kind == "lay":
        search = EASLay(tenv, tpol)
        state = search.init_state(inst, eas_init=convert_eas_params(
            jax.tree_util.tree_map(np.asarray, start["trainable"])))
    else:
        search = ActiveSearch(tenv, tpol)
        state = search.init_state(inst)
    for it, want in enumerate(its):
        before = port_flat(state.trainable)
        got = search.step(state, replay_actions=torch.tensor(want["actions"]).long(),
                          keep_grads=True)
        np.testing.assert_array_equal(t2n(got["actions"]), want["actions"])
        check_iteration(got, want, lr, before, port_flat(state.trainable),
                        AS_GRAD_GAUGE if kind == "as" else GRAD_GAUGE, f"{kind} iteration {it}")
        best, best_actions, have_best = want["inc"]
        np.testing.assert_allclose(t2n(state.best), np.asarray(best), rtol=1e-6)
        if kind != "as":
            np.testing.assert_array_equal(t2n(state.best_actions), np.asarray(best_actions))
            np.testing.assert_array_equal(t2n(state.have_best), np.asarray(have_best))
        # the next iteration starts from JAX's trained tensors, where Adam's
        # sign noise moved the port's, and from its incumbents
        with torch.no_grad():
            for k, v in jax_flat(want["trainable"]).items():
                state.trainable[k].copy_(torch.from_numpy(np.array(v)))
            state.best = torch.from_numpy(np.array(best))
            state.best_actions = torch.from_numpy(np.array(best_actions)).long()
            state.have_best = torch.from_numpy(np.array(have_best))
    assert all(p.requires_grad for p in tpol.parameters()), "the policy stays trainable"


def test_adamw_update_is_optaxs():
    rs = np.random.RandomState(0)
    p0 = rs.standard_normal((5, 7)).astype(np.float32)
    grads = [rs.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(4.1e-3, weight_decay=1e-6)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    opt = get_optimizer([tp], "adamw", 4.1e-3, weight_decay=1e-6)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(t2n(tp), np.asarray(jp), rtol=1e-7, atol=1e-9)


def test_search_entry_points_run_and_refuse_to_run_without_a_card():
    _, _, tpol, _, tenv, inst = small_setup(3)
    g = torch.Generator().manual_seed(0)
    res = EASEmb(tenv, tpol, max_iters=2).search(inst, g)
    assert res["best_reward"].shape == (2,) and torch.isfinite(res["best_reward"]).all()
    assert res["embeddings"].shape == (16, 7, 16) and res["best_actions"].shape[0] == 16
    res = EASLay(tenv, tpol, max_iters=2, hidden_dim=8).search(inst, g)
    assert res["eas_params"]["w1"].shape == (16, 8) and torch.isfinite(res["best_reward"]).all()
    before = [p.clone() for p in tpol.parameters()]
    res = ActiveSearch(tenv, tpol, max_iters=2).search(inst, g)
    assert torch.isfinite(res["best_reward"]).all()
    assert all(torch.equal(a, b) for a, b in zip(before, tpol.parameters())), \
        "Active Search tunes a copy"
    for tenv_cls in (EASEmb, EASLay, ActiveSearch):
        assert tenv_cls(tenv, tpol).device.type == "cpu"


def write_golden():
    """The chip phase's golden file (see the module docstring)."""
    from rl4co_tpu.data.io import load_reference_npz as jax_load
    from rl4co_tpu.models.zoo.pomo import make_pomo_policy as jax_make_pomo_policy

    tree = load_params_npz(os.path.join(ROOT, "rl4co_tpu_torch", "golden",
                                        "pomo_cvrp50_params.npz"))
    tree = tree if set(tree) == {"params"} else {"params": tree}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jpol = jax_make_pomo_policy("cvrp", pointer_impl="xla")
    env = jax_get_env("cvrp", num_loc=50)
    inst = {k: jnp.asarray(v[:GOLDEN_COUNT]) for k, v in jax_load(CVRP50_FILE, "cvrp").items()}
    out = {"count": GOLDEN_COUNT}
    for kind, iters, lr, cls in (("emb", 2, 4.1e-3, jeas.EASEmb), ("lay", 2, 4.1e-3, jeas.EASLay),
                                 ("as", 1, 2.6e-4, jeas.ActiveSearch)):
        key = jax.random.PRNGKey({"emb": 11, "lay": 12, "as": 13}[kind])
        start, its = jax_search_states(kind, jpol, params, env, inst, key, iters, lr)
        # the written-out iterations are the module's search on the same key
        mod = cls(env=env, policy=jpol, max_iters=iters).search(params, inst, key)
        np.testing.assert_allclose(np.asarray(mod["best_reward"]), np.asarray(
            jax_unbatchify(its[-1]["inc"][0], 8).max(axis=-1) if kind == "emb"
            else its[-1]["inc"][0]), rtol=1e-6)
        trained = {"emb": "embeddings", "lay": "eas_params", "as": "params"}[kind]
        for a, b in zip(jax.tree_util.tree_leaves(mod[trained]),
                        jax.tree_util.tree_leaves(its[-1]["trainable"])):
            # the JAX program differs from the module's in its fusions: a few
            # elements move by Adam's sign noise, within 1 % of lr
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=0.01 * lr)
        if kind == "lay":
            for k, v in start["trainable"].items():
                out[f"lay/init/{k}"] = np.asarray(v)
        for i, r in enumerate(its):
            pre = f"{kind}/{i}/"
            out[pre + "actions"] = r["actions"].astype(np.int8)
            out[pre + "rl_loss"], out[pre + "il_loss"] = np.float32(r["rl"]), np.float32(r["il"])
            grads, trained = jax_flat(r["grads"]), jax_flat(r["trainable"])
            if kind == "as":   # the whole policy: norms, and the decoder's leaves in full
                before = jax_flat(start["trainable"])
                scale = max(np.abs(g).max() for g in grads.values())
                for k, g in grads.items():
                    out[pre + "grad_norm/" + k] = np.float32(np.linalg.norm(g))
                    big = np.abs(g) > BIG_GRAD * scale
                    out[pre + "update_norm/" + k] = np.float32(
                        np.linalg.norm((trained[k] - before[k])[big]))
                    if not k.startswith("encoder_net"):
                        out[pre + "grads/" + k] = g
            else:
                for k, g in grads.items():
                    out[pre + "grads/" + k] = g
                for k, v in trained.items():
                    out[pre + "trained/" + k] = v
            best, best_actions, have_best = r["inc"]
            out[pre + "best"] = np.asarray(best)
            out[pre + "best_actions"] = np.asarray(best_actions).astype(np.int8)
            out[pre + "have_best"] = np.asarray(have_best)
            print(kind, i, "rl", r["rl"], "il", r["il"], flush=True)
    np.savez_compressed(GOLDEN, **out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")


if __name__ == "__main__":
    write_golden()
