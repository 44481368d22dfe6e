"""The port's multi-env policy and its REINFORCE against the JAX package's
(`rl4co_tpu/models/policies/multi_env.py`, `rl4co_tpu/rl/multi_env.py`).

- the parameter tree: the JAX package's own initial tree (dense and MoE
  trunks) loads into the port, every leaf consumed and every parameter set,
  and comes back through the npz export unchanged; `random_params_numpy`
  makes trees of the same paths and shapes;
- greedy rollouts of both envs through ``for_env``: equal actions, rewards
  within 1e-5, log-likelihoods within 1e-4 (f32 and bf16), for the dense and
  the MoE trunk;
- the REINFORCE loss of each env (a greedy train spec, so that both sides
  take the same actions) within 2e-5, and every gradient at the tolerances
  of `test_torch_reinforce.py` (f32: rtol 1e-3, atol 1e-5) and
  `test_torch_bf16.py` (bf16: rtol 2e-2, one bf16 ulp of the leaf's largest
  gradient);
- one trunk, each parameter owned once, moved by steps of both envs, and the
  other env's embeddings moved by Adam's moments as optax moves them;
- the env of every train step, against the JAX Trainer's dispatches, at one
  step per dispatch and at several, over two epochs and over a resume (the
  JAX side's parameters, loss and evaluation stubbed: the order of the envs
  is the Trainer's and the algorithm's code alone).

`python tests/test_torch_multi_env.py` rewrites the golden files of the
full-width configuration (`rl4co_tpu_torch/golden/multienv_op_pctsp_*.npz`)
with the JAX package on the CPU; no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models.policies.constructive import rollout as jax_rollout  # noqa: E402
from rl4co_tpu.models.policies.multi_env import (  # noqa: E402
    MultiEnvAttentionPolicy as JaxMultiEnv,
    MultiEnvMoEPolicy as JaxMultiEnvMoE,
    init_multi_env_params,
)
from rl4co_tpu.rl.multi_env import MultiEnvBaselineState  # noqa: E402
from rl4co_tpu.rl.multi_env import MultiEnvREINFORCE as JaxMultiEnvREINFORCE  # noqa: E402
from rl4co_tpu.rl.reinforce import TrainState  # noqa: E402
from rl4co_tpu.trainer import Trainer as JaxTrainer  # noqa: E402
from rl4co_tpu.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from rl4co_tpu_torch.convert import (  # noqa: E402
    convert_params,
    load_params,
    load_params_npz,
    random_params_numpy,
    save_params_npz,
)
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import rollout  # noqa: E402
from rl4co_tpu_torch.models.policies.multi_env import (  # noqa: E402
    MultiEnvAttentionPolicy,
    MultiEnvMoEPolicy,
)
from rl4co_tpu_torch.rl.multi_env import MultiEnvREINFORCE  # noqa: E402
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig  # noqa: E402

from _torch_port import ROOT, SMALL, t2n, tree_to_jax, tree_to_numpy  # noqa: E402

torch.set_num_threads(1)

NAMES = ("op", "pctsp")
N, B = 8, 6
KEY = jax.random.PRNGKey(0)
GOLDEN_PARAMS = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "multienv_op_pctsp_params.npz")
GOLDEN_COSTS = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "multienv_op_pctsp_costs.npz")
# the golden configuration: OP-20 and PCTSP-20 at AM's published widths, one
# greedy dispatch of 1024 instances per env
GOLDEN_NUM_LOC, GOLDEN_COUNT, GOLDEN_SEED = 20, 1024, 1234
# the small widths with one encoder layer (the JAX side's compile time)
DIMS = {**SMALL, "num_encoder_layers": 1}
TREES = {"multienv": (JaxMultiEnv, MultiEnvAttentionPolicy),
         "multienv_moe": (JaxMultiEnvMoE, MultiEnvMoEPolicy)}


def envs_pair(n=N, names=NAMES):
    return ({k: get_env(k, num_loc=n) for k in names},
            {k: jax_get_env(k, num_loc=n) for k in names})


def jax_instances(jenv, seed, b):
    return {k: np.asarray(v) for k, v in jenv.generate_batch(jax.random.PRNGKey(seed), b).items()}


def multi_pair(kind="multienv", seed=0, **dims):
    """(JAX policy, its params, the port's policy on the CPU) on the same
    seeded tree of ``kind``."""
    dims = {**DIMS, **dims}
    tree_keys = ("embed_dim", "num_encoder_layers", "feedforward_hidden", "normalization")
    tree = random_params_numpy(seed, policy=kind, env_names=NAMES,
                               **{k: v for k, v in dims.items() if k in tree_keys})
    jcls, tcls = TREES[kind]
    jpol = jcls(env_name=NAMES[0], env_names=NAMES, **dims)
    tpol = tcls(env_name=NAMES[0], env_names=NAMES, device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree)


def flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("kind", list(TREES))
def test_tree_round_trip_through_convert(kind, tmp_path):
    """The dense trunk's tree is the golden file's (`init_multi_env_params` at
    full width). The MoE trunk's is `random_params_numpy`'s at the small
    widths, held to the paths and shapes of `init_multi_env_params`'s (traced
    with `jax.eval_shape`, not run)."""
    jcls, tcls = TREES[kind]
    dims = {} if kind == "multienv" else DIMS
    widths = {k: v for k, v in dims.items() if k != "num_heads"}
    ours = random_params_numpy(0, policy=kind, env_names=NAMES, **widths)
    if kind == "multienv":
        tree = load_params_npz(GOLDEN_PARAMS)
    else:
        jpol = jcls(env_name="op", env_names=NAMES, **dims)
        shapes = jax.eval_shape(lambda k: init_multi_env_params(jpol, envs_pair()[1], k), KEY)
        assert flat_shapes(ours) == flat_shapes(shapes["params"])
        tree = ours
    tpol = load_params(tcls(env_name="op", env_names=NAMES, device="cpu", **dims), tree)
    path = str(tmp_path / "tree.npz")
    save_params_npz(tree, path)
    back = load_params(tcls(env_name="pctsp", env_names=NAMES, device="cpu", **dims),
                       load_params_npz(path))
    want = convert_params(tree)
    assert set(tpol.state_dict()) == set(want) == set(back.state_dict())
    for name, p in tpol.state_dict().items():
        assert torch.equal(p, want[name]) and torch.equal(back.state_dict()[name], p), name
    assert flat_shapes(ours) == flat_shapes(tree)
    # the per-env names, one trunk
    keys = set(want)
    assert {"init_embeddings_op.init_embed.weight", "context_embeddings_pctsp."
            "project_context.weight"} <= keys
    assert not any(k.startswith(("init_embedding.", "context_embedding.")) for k in keys)
    assert any(k.startswith("encoder_net." if kind == "multienv" else "moe_layer_0.")
               for k in keys)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", list(TREES))
def test_greedy_rollouts_through_for_env_match_jax(kind, compute_dtype):
    tenvs, jenvs = envs_pair()
    jpol, params, tpol = multi_pair(kind, seed=1)
    tpol.eval()
    for i, name in enumerate(NAMES):
        inst = jax_instances(jenvs[name], 10 + i, B)
        want = jax_rollout(jpol.for_env(name), params, jenvs[name],
                           {k: jnp.asarray(v) for k, v in inst.items()}, KEY,
                           JaxSpec(kind="greedy", tanh_clipping=10.0,
                                   compute_dtype=compute_dtype))
        with torch.no_grad():
            got = rollout(tpol.for_env(name), tenvs[name], inst,
                          DecodeSpec(kind="greedy", tanh_clipping=10.0,
                                     compute_dtype=compute_dtype), device="cpu")
        np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions), err_msg=name)
        np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), rtol=0, atol=1e-5)
        np.testing.assert_allclose(t2n(got.log_likelihood), np.asarray(want.log_likelihood),
                                   atol=1e-4)
        tenvs[name].check_solution_validity(inst, t2n(got.actions))


def loss_pair(compute_dtype, seed=2):
    spec = dict(kind="greedy", tanh_clipping=10.0, compute_dtype=compute_dtype)
    tenvs, jenvs = envs_pair()
    jpol, params, tpol = multi_pair(seed=seed)
    jalgo = JaxMultiEnvREINFORCE(envs=jenvs, policy=jpol, train_spec=JaxSpec(**spec))
    talgo = MultiEnvREINFORCE(tenvs, policy=tpol, train_spec=DecodeSpec(**spec))
    return jalgo, params, talgo


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_jax(name, compute_dtype):
    jalgo, params, talgo = loss_pair(compute_dtype)
    inst = jax_instances(jalgo.envs[name], 20, B)
    bl_state = jalgo._baselines[name].init_state(KEY, params, jalgo.greedy_reward_fn(name))
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jalgo._loss_for(name), has_aux=True))(
        params, bl_state, {k: jnp.asarray(v) for k, v in inst.items()}, KEY)
    tloss, (tmetrics, _) = talgo.loss(name, {k: torch.tensor(v) for k, v in inst.items()})
    for k in jmetrics:
        np.testing.assert_allclose(tmetrics[k].item(), float(jmetrics[k]), atol=2e-5, err_msg=k)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads["params"])).items()}
    assert set(want) == {k for k, _ in talgo.policy.named_parameters()}
    scale = max(np.abs(w).max() for w in want.values())
    other = [n for n in NAMES if n != name][0]
    under_batch_norm = (".mha.out_proj.bias", ".ffn.Dense_1.bias")
    for pname, p in talgo.policy.named_parameters():
        got = np.zeros_like(want[pname]) if p.grad is None else p.grad.numpy()
        if f"_{other}." in pname:  # the other env's embeddings: no part in this loss
            assert p.grad is None and not want[pname].any(), pname
            continue
        if compute_dtype is None:
            np.testing.assert_allclose(got, want[pname], rtol=1e-3, atol=1e-5, err_msg=pname)
            continue
        leaf_max = np.abs(want[pname]).max()
        if pname.endswith(under_batch_norm):  # zero in exact arithmetic
            assert leaf_max < 1e-5 * scale and np.abs(got).max() < 1e-5 * scale, pname
            continue
        np.testing.assert_allclose(got, want[pname], rtol=2e-2, atol=2**-7 * leaf_max,
                                   err_msg=pname)


def test_trunk_moves_under_both_envs_and_each_parameter_is_owned_once():
    tenvs, jenvs = envs_pair()
    _, params, tpol = multi_pair(seed=3)
    talgo = MultiEnvREINFORCE(tenvs, policy=tpol,
                              train_spec=DecodeSpec(kind="greedy", tanh_clipping=10.0))
    params_list = list(tpol.parameters())
    assert len({id(p) for p in params_list}) == len(params_list)
    optimised = [p for g in talgo.optimizer.inner.param_groups for p in g["params"]]
    assert [id(p) for p in optimised] == [id(p) for p in params_list]
    assert len(params_list) == len(jax.tree_util.tree_leaves(params))
    keys = list(tpol.state_dict())
    for name in NAMES:
        view = tpol.for_env(name)
        assert list(view.state_dict()) == keys
        assert all(a is b for a, b in zip(view.parameters(), params_list))
        assert view.init_embedding is getattr(tpol, f"init_embeddings_{name}")
    assert tpol.env_name == "op"

    def snap():
        return {k: v.clone() for k, v in tpol.state_dict().items()}

    def moved(a, b, prefix):
        return [k for k in a if k.startswith(prefix) and not torch.equal(a[k], b[k])]

    trunk = ("encoder_net.", "project_node_embeddings.", "project_fixed_context.", "pointer.")
    s0 = snap()
    talgo.update("op", jax_instances(jenvs["op"], 30, B))
    s1 = snap()
    talgo.update("pctsp", jax_instances(jenvs["pctsp"], 31, B))
    s2 = snap()
    for prefix in trunk:
        assert moved(s0, s1, prefix) and moved(s1, s2, prefix), prefix
    # step 1 (OP): PCTSP's embeddings have a zero gradient and Adam's first
    # update of a zero moment is zero; step 2 (PCTSP): OP's embeddings move by
    # their moments alone, as optax moves a leaf whose gradient is zero
    assert not moved(s0, s1, "init_embeddings_pctsp.") and moved(s0, s1, "init_embeddings_op.")
    assert moved(s1, s2, "init_embeddings_pctsp.") and moved(s1, s2, "init_embeddings_op.")
    tx = optax.adam(1e-4)
    leaf = jnp.ones(3)
    state = tx.init(leaf)
    first, state = tx.update(jnp.full(3, 0.5), state, leaf)
    second, _ = tx.update(jnp.zeros(3), state, leaf)
    assert (np.asarray(second) != 0).all()
    assert talgo.step == 2 and talgo.optimizer.inner.state[params_list[0]]["step"] == 2


# ------------------------------------------------- the env of every step

SEQ_N, SEQ_B, SEQ_STEPS = 3, 2, 3   # 3 steps per epoch
SEQ_DIMS = dict(embed_dim=8, num_heads=2, num_encoder_layers=1, feedforward_hidden=8)


def jax_env_sequence(spd, tmp_path, resume):
    """The env of every train step of the JAX Trainer over two epochs
    (``resume``: one epoch, then a second ``fit`` resumed from its checkpoint)."""
    _, jenvs = envs_pair(SEQ_N)
    jpol = JaxMultiEnv(env_name="op", env_names=NAMES, **SEQ_DIMS)
    algo = JaxMultiEnvREINFORCE(envs=jenvs, policy=jpol)
    # the Trainer's choice of chunk and the algorithm's turns are the JAX
    # code's own; the parameters, the loss and the evaluation are stubs, which
    # keep the JAX side's set-up and compile time to seconds

    def stub_init(key):
        params = {"w": jnp.zeros(2)}
        return TrainState(params=params, opt_state=algo.make_optimizer().init(params),
                          baseline_state=MultiEnvBaselineState(states={
                              n: algo._baselines[n].init_state(key, params, None)
                              for n in NAMES}),
                          step=jnp.int32(0))

    def stub_loss(name):
        def loss(params, bl_state, instances, key):
            value = jnp.sum(params["w"]) * 0.0
            return value, {"loss": value, "reward": value}
        return loss

    object.__setattr__(algo, "init", stub_init)
    object.__setattr__(algo, "_loss_for", stub_loss)
    object.__setattr__(algo, "make_eval_step", lambda *a, **k: (
        lambda params, instances, key: {"reward": jnp.float32(0.0)}))
    seen = []
    make = algo.make_train_step

    def recording(batch_size, mesh=None, donate=False, chunk=1):  # the signature the
        dispatch = make(batch_size, mesh, donate, chunk)           # Trainer inspects

        def step(state, key):
            state, metrics = dispatch(state, key)
            seen.extend(np.atleast_1d(metrics["env"]).tolist())
            return state, metrics

        return step

    object.__setattr__(algo, "make_train_step", recording)

    def fit(epochs, ckpt, resume_from=None):
        cfg = JaxTrainerConfig(epochs=epochs, batch_size=SEQ_B,
                               train_data_size=SEQ_STEPS * SEQ_B, val_data_size=SEQ_B,
                               val_batch_size=SEQ_B, steps_per_dispatch=spd, ckpt_dir=ckpt)
        JaxTrainer(algo, cfg, logger=lambda m: None).fit(resume_from=resume_from)

    if resume:
        ckpt = str(tmp_path / "jax")
        fit(1, ckpt)
        fit(2, ckpt, resume_from=ckpt + "/last")
    else:
        fit(2, None)
    return seen


def port_env_sequence(spd, tmp_path, resume):
    tenvs, _ = envs_pair(SEQ_N)
    torch.manual_seed(0)
    algo = MultiEnvREINFORCE(tenvs, policy=MultiEnvAttentionPolicy(
        env_name="op", env_names=NAMES, device="cpu", **SEQ_DIMS))
    seen, update = [], algo.update

    def recording(name, *args, **kwargs):
        seen.append(name)
        return update(name, *args, **kwargs)

    algo.update = recording
    logged = []

    def fit(epochs, ckpt, resume_from=None):
        cfg = TrainerConfig(epochs=epochs, batch_size=SEQ_B,
                            train_data_size=SEQ_STEPS * SEQ_B, val_data_size=SEQ_B,
                            val_batch_size=SEQ_B, steps_per_dispatch=spd, ckpt_dir=ckpt)
        Trainer(algo, cfg, logger=logged.append).fit(resume_from=resume_from)

    if resume:
        ckpt = str(tmp_path / "port")
        fit(1, ckpt)
        fit(2, ckpt, resume_from=os.path.join(ckpt, "last.pt"))
    else:
        fit(2, None)
    # every dispatch is logged with its env (the JAX Trainer logs a chunk's last step)
    if spd != 1:
        assert [r["env"] for r in logged if "env" in r] == seen[SEQ_STEPS - 1::SEQ_STEPS]
    return seen


@pytest.mark.parametrize("spd,resume", [(1, False), (None, False), (None, True)],
                         ids=["chunk1", "chunk3", "chunk3-resumed"])
def test_env_of_every_step_matches_the_jax_trainer(spd, resume, tmp_path):
    want = jax_env_sequence(spd, tmp_path, resume)
    got = port_env_sequence(spd, tmp_path, resume)
    assert got == want and len(got) == 2 * SEQ_STEPS
    # chunk 1 alternates step by step; chunk 3 gives each epoch to one env,
    # and a resumed fit starts again at the first env
    expected = {1: ["op", "pctsp"] * 3, None: ["op"] * 3 + ["pctsp"] * 3}[spd]
    assert want == (["op"] * 6 if resume else expected)


def test_golden_files_load_into_the_port():
    tree = load_params_npz(GOLDEN_PARAMS)
    policy = load_params(MultiEnvAttentionPolicy(device="cpu"), tree)
    assert sum(p.numel() for p in policy.parameters()) == 711_680
    with np.load(GOLDEN_COSTS) as f:
        assert int(f["dispatch"]) == GOLDEN_COUNT
        for name in NAMES:
            assert f[f"{name}/greedy"].shape == (GOLDEN_COUNT,)
            assert f[f"{name}/locs"].shape == (GOLDEN_COUNT, GOLDEN_NUM_LOC, 2)


def write_golden():
    """The JAX package's full-width multi-env tree (`init_multi_env_params`,
    key 0) and, per env, 1024 instances of `generate_batch(PRNGKey(1234))`
    with their greedy rewards in one dispatch (tanh clipping 10, f32)."""
    envs = {k: jax_get_env(k, num_loc=GOLDEN_NUM_LOC) for k in NAMES}
    policy = JaxMultiEnv(env_name=NAMES[0], env_names=NAMES)
    params = init_multi_env_params(policy, envs, KEY)
    save_params_npz(tree_to_numpy(params["params"]), GOLDEN_PARAMS)
    out = {"dispatch": np.int64(GOLDEN_COUNT)}
    for name, env in envs.items():
        inst = env.generate_batch(jax.random.PRNGKey(GOLDEN_SEED), GOLDEN_COUNT)
        res = jax.jit(lambda p, i, e=env, n=name: jax_rollout(
            policy.for_env(n), p, e, i, KEY, JaxSpec(kind="greedy", tanh_clipping=10.0)).reward)(
            params, inst)
        out.update({f"{name}/{k}": np.asarray(v) for k, v in inst.items()})
        out[f"{name}/greedy"] = np.asarray(res)
        print(name, "mean greedy reward", float(np.mean(out[f"{name}/greedy"])))
    np.savez(GOLDEN_COSTS, **out)


if __name__ == "__main__":
    write_golden()
