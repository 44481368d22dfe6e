"""Helpers shared by the tests of the PyTorch port (`tests/test_torch_*.py`).

The tests, unlike the port, import both frameworks: inputs and weights are
made with numpy and go through the JAX package and through its counterpart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.models.zoo.pomo import make_pomo_policy as jax_make_pomo_policy
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.envs.routing.cvrp import default_capacity
from rl4co_tpu_torch.models import AttentionModelPolicy as TorchPolicy
from rl4co_tpu_torch.models.zoo.pomo import make_pomo_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSP50_FILE = os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz")
TSP100_FILE = os.path.join(ROOT, "data", "tsp", "test100_seed1234.npz")
CVRP50_FILE = os.path.join(ROOT, "data", "cvrp", "test50_seed1234.npz")

# the small size of the port's tests
SMALL = dict(embed_dim=32, num_heads=4, num_encoder_layers=2, feedforward_hidden=64)


def tree_to_numpy(tree):
    """A JAX/Flax parameter tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def tree_to_jax(tree):
    """Nested dicts of numpy arrays as a Flax ``{"params": ...}`` tree."""
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def policy_pair(seed=0, jax_pointer_impl="xla", torch_pointer_impl="kernel", **dims):
    """The same seeded weights as (JAX policy, its params, PyTorch policy on the CPU)."""
    dims = {**SMALL, **dims}
    tree = random_params_numpy(
        seed, dims["embed_dim"], dims["num_encoder_layers"], dims["feedforward_hidden"]
    )
    jpol = JaxPolicy(env_name="tsp", pointer_impl=jax_pointer_impl, **dims)
    tpol = TorchPolicy(env_name="tsp", pointer_impl=torch_pointer_impl,
                       device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def random_locs(seed, b, n):
    return np.random.RandomState(seed).random_sample((b, n, 2)).astype(np.float32)


def pomo_tree(seed, embed_dim, num_encoder_layers, feedforward_hidden):
    """A POMO/CVRP ``params`` tree from numpy seeds: AM's encoder with instance
    norm, the CVRP embeddings, no graph-context projection."""
    tree = random_params_numpy(seed, embed_dim, num_encoder_layers, feedforward_hidden,
                               normalization="instance")
    rs, d = np.random.RandomState(seed + 1), embed_dim

    def dense(fan_in, fan_out, use_bias=True):
        out = {"kernel": (rs.standard_normal((fan_in, fan_out))
                          / np.sqrt(fan_in)).astype(np.float32)}
        if use_bias:
            out["bias"] = (0.1 * rs.standard_normal(fan_out)).astype(np.float32)
        return out

    tree["init_embedding"] = {"init_embed_depot": dense(2, d), "init_embed": dense(3, d)}
    tree["context_embedding"] = {"project_context": dense(d + 1, d, use_bias=False)}
    del tree["project_fixed_context"]
    return tree


def pomo_pair(seed=0, jax_pointer_impl="xla", torch_pointer_impl="kernel", **dims):
    """The same seeded weights as (JAX POMO policy, its params, the port's on the CPU)."""
    dims = {**SMALL, **dims}
    tree = pomo_tree(seed, dims["embed_dim"], dims["num_encoder_layers"],
                     dims["feedforward_hidden"])
    jpol = jax_make_pomo_policy("cvrp", pointer_impl=jax_pointer_impl, **dims)
    tpol = make_pomo_policy("cvrp", pointer_impl=torch_pointer_impl, device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def random_cvrp(seed, b, n):
    """CVRP instances as numpy arrays: uniform locations and depot, integer
    demands 1..9 divided by the capacity of the table."""
    rs = np.random.RandomState(seed)
    return {
        "locs": rs.random_sample((b, n, 2)).astype(np.float32),
        "depot": rs.random_sample((b, 2)).astype(np.float32),
        "demand": (rs.randint(1, 10, size=(b, n)) / default_capacity(n)).astype(np.float32),
    }


def zoo_pair(policy, env_name="tsp", seed=0, **dims):
    """The same seeded weights (`random_params_numpy(policy=...)`) as (JAX
    policy of the zoo, its params, the port's policy on the CPU). ``dims``
    holds the policy's own arguments (``k``, ``num_experts``, ...) beside the
    small widths."""
    from rl4co_tpu.models.zoo.mvmoe import MVMoEPolicy as JaxMVMoE
    from rl4co_tpu.models.zoo.polynet import PolyNetPolicy as JaxPolyNet
    from rl4co_tpu.models.zoo.symnco import SymNCOPolicy as JaxSymNCO
    from rl4co_tpu_torch.models.zoo.mvmoe import MVMoEPolicy
    from rl4co_tpu_torch.models.zoo.polynet import PolyNetPolicy
    from rl4co_tpu_torch.models.zoo.symnco import SymNCOPolicy

    dims = {**SMALL, **dims}
    tree_keys = ("embed_dim", "num_encoder_layers", "feedforward_hidden", "normalization",
                 "use_graph_context", "num_experts", "k", "poly_layer_dim")
    tree = random_params_numpy(seed, policy=policy, env_name=env_name,
                               **{k: v for k, v in dims.items() if k in tree_keys})
    classes = {"symnco": (JaxSymNCO, SymNCOPolicy), "mvmoe": (JaxMVMoE, MVMoEPolicy),
               "polynet": (JaxPolyNet, PolyNetPolicy)}[policy]
    jpol = classes[0](env_name=env_name, **dims)
    tpol = classes[1](env_name=env_name, device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def decode_logits_pair(jpol, jparams, tpol, env_name, inst, repeats, first=None):
    """Both packages' logits of one decode step on ``inst`` (numpy) with
    ``repeats`` queries per instance: step 0, or the step after the forced
    flat actions ``first``. Returns (JAX logits, the port's), numpy."""
    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu.utils.ops import batchify as jax_batchify
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.utils.ops import batchify

    num_loc = next(iter(inst.values())).shape[1]
    jenv, tenv = jax_get_env(env_name, num_loc=num_loc), get_env(env_name, num_loc=num_loc)
    jinst = {k: jnp.asarray(v) for k, v in inst.items()}
    cache = jpol.apply(jparams, jpol.apply(jparams, jinst, method="encode"), method="precompute")
    state = jenv.reset_batch(jax_batchify(jinst, repeats))
    if first is not None:
        state = jenv.step_batch(state, jnp.asarray(first))
    want = jpol.apply(jparams, cache, state, jenv.action_mask_batch(state), repeats,
                      method="decode_step")
    tinst = {k: torch.from_numpy(v) for k, v in inst.items()}
    with torch.no_grad():
        tcache = tpol.precompute(tpol.encode(tinst))
        tstate = tenv.reset(batchify(tinst, repeats))
        if first is not None:
            tstate = tenv.step(tstate, torch.from_numpy(first))
        got = tpol.decode_step(tcache, tstate, tenv.action_mask(tstate), repeats)
    return np.asarray(want), t2n(got)


# the NAR encoders' small size in the port's tests
NAR_SMALL = dict(embed_dim=16, num_layers_graph_encoder=2, num_layers_heatmap_generator=2)


def nar_pair(policy="nargnn", env_name="tsp", seed=0, z_out_dim=1):
    """The same seeded weights (`random_params_numpy(policy="nargnn"|"gfacs")`)
    as (JAX encoder, its params, the port's encoder on the CPU), at NAR_SMALL."""
    from rl4co_tpu.models.zoo.gfacs import GFACSEncoder as JaxGFACSEncoder
    from rl4co_tpu.models.zoo.nargnn import NARGNNEncoder as JaxNARGNNEncoder
    from rl4co_tpu_torch.models.zoo.gfacs import GFACSEncoder
    from rl4co_tpu_torch.models.zoo.nargnn import NARGNNEncoder

    tree = random_params_numpy(seed, embed_dim=NAR_SMALL["embed_dim"], policy=policy,
                               env_name=env_name,
                               gnn_layers=NAR_SMALL["num_layers_graph_encoder"],
                               heatmap_layers=NAR_SMALL["num_layers_heatmap_generator"],
                               z_out_dim=z_out_dim)
    if policy == "gfacs":
        jenc = JaxGFACSEncoder(env_name=env_name, z_out_dim=z_out_dim, **NAR_SMALL)
        tenc = GFACSEncoder(env_name=env_name, z_out_dim=z_out_dim, device="cpu", **NAR_SMALL)
    else:
        jenc = JaxNARGNNEncoder(env_name=env_name, **NAR_SMALL)
        tenc = NARGNNEncoder(env_name=env_name, device="cpu", **NAR_SMALL)
    return jenc, tree_to_jax(tree), load_params(tenc, tree)


def nar_instances(env_name, seed, b, n):
    """TSP or CVRP instances as numpy arrays from a numpy seed."""
    return {"locs": random_locs(seed, b, n)} if env_name == "tsp" else random_cvrp(seed, b, n)


# ---- the routing envs of the multi-task VRP slice (CVRPTW, SDVRP, PDP,
# mTSP, SHPP, MTVRP): helpers shared by `tests/test_torch_env_*.py`

KEY = jax.random.PRNGKey(0)


# the envs outside routing at the tests' small sizes: their size arguments
# are not ``num_loc`` (FLP's is, beside the facilities it chooses)
SMALL_ENVS = {
    "smtwtp": dict(num_job=8),
    "dpp": dict(size=4, max_decaps=4, num_freq=8, num_keepout_max=5),
    "mdpp": dict(size=4, max_decaps=4, num_freq=8, num_keepout_max=5),
    "flp": dict(num_loc=12, to_choose=3),
    "mcp": dict(num_items=20, num_sets=10, n_sets_to_choose=3),
}


def env_pair(name, n, **kw):
    """(the port's env, the JAX package's) of one registry name: a routing
    env at ``num_loc=n``, an env of `SMALL_ENVS` at its small size."""
    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu_torch.envs import get_env

    kw = {**(SMALL_ENVS[name] if name in SMALL_ENVS else {"num_loc": n}), **kw}
    return get_env(name, **kw), jax_get_env(name, **kw)


def jax_instances(jenv, seed, b):
    """Instances generated by the JAX package, as numpy arrays."""
    inst = jenv.generate_batch(jax.random.PRNGKey(seed), b)
    return {k: np.asarray(v) for k, v in inst.items()}


def to_torch(inst):
    return {k: torch.tensor(np.asarray(v)) for k, v in inst.items()}


def to_jax(inst):
    return {k: jnp.asarray(v) for k, v in inst.items()}


def am_pair(env_name, seed=0, pomo=False, **dims):
    """The same seeded weights (`random_params_numpy` on ``env_name``) as (JAX
    AM policy, its params, the port's on the CPU); ``pomo``: POMO's
    deviations (instance norm, no graph context)."""
    dims = {**SMALL, **dims}
    arch = dict(normalization="instance", use_graph_context=False) if pomo else {}
    tree = random_params_numpy(seed, dims["embed_dim"], dims["num_encoder_layers"],
                               dims["feedforward_hidden"], env_name=env_name, **arch)
    jpol = JaxPolicy(env_name=env_name, **dims, **arch)
    tpol = TorchPolicy(env_name=env_name, device="cpu", **dims, **arch)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def rollout_pair(jpol, jparams, tpol, name, inst, replay=None, **spec):
    """Both packages' rollouts of ``inst`` (numpy) under the same spec
    (``replay``: actions for ``kind="evaluate"``); returns (JAX output with
    numpy fields, the port's output)."""
    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models import rollout as jax_rollout

    _, jenv = env_pair(name, _num_loc(name, inst))
    want = jax_rollout(jpol, jparams, jenv, to_jax(inst), KEY, JaxSpec(**spec),
                       None if replay is None else jnp.asarray(replay))
    return jax.tree_util.tree_map(np.asarray, want), port_rollout(tpol, name, inst, replay,
                                                                  **spec)


def port_rollout(tpol, name, inst, replay=None, **spec):
    """The port's rollout of ``inst`` (numpy) on the CPU, without a graph."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models import rollout

    tenv, _ = env_pair(name, _num_loc(name, inst))
    with torch.no_grad():
        return rollout(tpol, tenv, inst, DecodeSpec(**spec), device="cpu",
                       replay_actions=None if replay is None else torch.as_tensor(replay))


def jax_sampled(jpol, jparams, name, inst, seed=3, **spec):
    """A JAX sampling rollout of ``inst`` (numpy fields): actions for the
    port to replay."""
    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models import rollout as jax_rollout

    _, jenv = env_pair(name, _num_loc(name, inst))
    out = jax_rollout(jpol, jparams, jenv, to_jax(inst), jax.random.PRNGKey(seed),
                      JaxSpec(kind="sampling", **spec))
    return jax.tree_util.tree_map(np.asarray, out)


def _num_loc(name, inst):
    """The env's ``num_loc`` of instances ``inst``: MTVRP's ``locs`` hold the
    depot, mTSP's and SHPP's are all the nodes; None for an env of
    `SMALL_ENVS`, which `env_pair` builds at its small size."""
    if name in SMALL_ENVS:
        return None
    if "cost_matrix" in inst:   # ATSP
        return inst["cost_matrix"].shape[1]
    n = inst["locs"].shape[1]
    return n - 1 if name == "mtvrp" else n


def assert_rollouts_match(want, got, reward_rtol=1e-5, ll_atol=1e-4):
    """Equal actions, rewards within ``reward_rtol``, log-likelihoods within
    ``ll_atol``: `test_torch_rollout.py`'s tolerances."""
    np.testing.assert_array_equal(t2n(got.actions), want.actions)
    np.testing.assert_allclose(t2n(got.reward), want.reward, rtol=reward_rtol, atol=1e-6)
    np.testing.assert_allclose(t2n(got.log_likelihood), want.log_likelihood, atol=ll_atol)


def embedding_pair(kind, env_name, seed=0, embed_dim=32):
    """One env's init or context embedding in both packages on the same
    weights: (JAX module, its params, the port's module on the CPU)."""
    from rl4co_tpu.models.nn.env_embeddings import context as jctx, init as jinit
    from rl4co_tpu_torch.convert import convert_params
    from rl4co_tpu_torch.models.nn.env_embeddings import (
        env_context_embedding,
        env_init_embedding,
    )

    # a context without parameters (DPP's) has no subtree
    tree = random_params_numpy(seed, embed_dim, 1, 16, env_name=env_name).get(
        f"{kind}_embedding", {})
    if kind == "init":
        jmod = jinit.env_init_embedding(env_name, embed_dim)
        tmod = env_init_embedding(env_name, embed_dim)
    else:
        jmod = jctx.env_context_embedding(env_name, embed_dim)
        tmod = env_context_embedding(env_name, embed_dim)
    tmod.load_state_dict(convert_params(tree), strict=True)
    return jmod, {"params": jax.tree_util.tree_map(jnp.asarray, tree)}, tmod


def check_embeddings(env_name, inst, tstates, jstates, atol=1e-5, rtol=1e-6):
    """The init embedding of ``inst`` and the context embedding of every
    state pair, in f32 and with the parameters rounded through bf16 (JAX:
    `cast_floating`; the port: `rounded_parameters`, as a bf16 rollout
    does), within ``atol`` plus ``rtol`` of the largest value: CVRPTW's
    unscaled coordinates and times make terms in the hundreds, where one f32
    ulp is above 1e-5, and a small output may be their difference."""

    def close(got, want, what):
        err = np.abs(got - want).max()
        assert err <= atol + rtol * np.abs(want).max(), (what, err, np.abs(want).max())

    from rl4co_tpu.utils.dtype import cast_floating
    from rl4co_tpu_torch.utils.dtype import rounded_parameters

    for bf16 in (False, True):
        mods = {}
        for kind in ("init", "context"):
            jmod, jparams, tmod = embedding_pair(kind, env_name)
            if bf16:
                jparams = cast_floating(jparams, jnp.bfloat16)
                rounded = rounded_parameters(tmod, torch.bfloat16)
                with torch.no_grad():
                    for name, p in tmod.named_parameters():
                        p.copy_(rounded[name])
            mods[kind] = jmod, jparams, tmod
        jmod, jparams, tmod = mods["init"]
        want = np.asarray(jmod.apply(jparams, to_jax(inst)), dtype=np.float32)
        with torch.no_grad():
            got = t2n(tmod(to_torch(inst)))
        close(got, want, f"init bf16={bf16}")
        jmod, jparams, tmod = mods["context"]
        emb = np.random.RandomState(1).standard_normal(want.shape).astype(np.float32)
        for ts, js in zip(tstates, jstates):
            want_c = np.asarray(jmod.apply(jparams, jnp.asarray(emb), js), dtype=np.float32)
            with torch.no_grad():
                got_c = t2n(tmod(torch.from_numpy(emb), ts))
            close(got_c, want_c, f"context bf16={bf16}")


# ---- the improvement trio (DACT, N2S, NeuOpt) ----

TRIO_SMALL = dict(embed_dim=16, num_heads=2, num_encoder_layers=1, feedforward_hidden=16)


def trio_setup(name, n, **dims):
    """(JAX env, port env, JAX policy, port policy class, JAX act, port act,
    embeds width of the critic) of one improvement model; ``n`` customers."""
    import functools

    from rl4co_tpu.envs.routing.pdp_ruin_repair import PDPRuinRepair as JaxRR
    from rl4co_tpu.envs.routing.tsp_kopt import TSPkopt as JaxKopt
    from rl4co_tpu.models.zoo.dact import DACTPolicy as JaxDACT, dact_act as jax_dact_act
    from rl4co_tpu.models.zoo.n2s import N2SPolicy as JaxN2S, n2s_act as jax_n2s_act
    from rl4co_tpu.models.zoo.neuopt import NeuOptPolicy as JaxNeuOpt
    from rl4co_tpu.models.zoo.neuopt import neuopt_act as jax_neuopt_act
    from rl4co_tpu_torch.envs.routing.pdp_ruin_repair import PDPRuinRepair
    from rl4co_tpu_torch.envs.routing.tsp_kopt import TSPkopt
    from rl4co_tpu_torch.models.zoo.dact import DACTPolicy, dact_act
    from rl4co_tpu_torch.models.zoo.n2s import N2SPolicy, n2s_act
    from rl4co_tpu_torch.models.zoo.neuopt import NeuOptPolicy, neuopt_act

    if name == "dact":
        return (JaxKopt(num_loc=n, k_max=2), TSPkopt(num_loc=n, k_max=2), JaxDACT(**dims),
                DACTPolicy, jax_dact_act, dact_act, 2 * dims.get("embed_dim", 64))
    if name == "n2s":
        return (JaxRR(num_loc=n), PDPRuinRepair(num_loc=n), JaxN2S(**dims), N2SPolicy,
                jax_n2s_act, n2s_act, dims.get("embed_dim", 128))
    return (JaxKopt(num_loc=n, k_max=4), TSPkopt(num_loc=n, k_max=4), JaxNeuOpt(**dims),
            NeuOptPolicy, functools.partial(jax_neuopt_act, k_max=4),
            functools.partial(neuopt_act, k_max=4), dims.get("embed_dim", 128))


def trio_state_to_torch(tenv, inst_np, jst):
    """The port's state of the JAX state ``jst`` (its initial tour, then the
    JAX fields that the moves made), on the CPU."""
    import dataclasses as dc

    st = tenv.reset_from(to_torch(inst_np), torch.tensor(np.asarray(jst.rec_current)).long())
    fields = {f.name: torch.tensor(np.asarray(getattr(jst, f.name))) for f in dc.fields(st)
              if f.name != "locs"}
    return dc.replace(st, **{k: (v.long() if not v.is_floating_point() else v)
                             for k, v in fields.items()})


def seeded_tree_like(shapes, seed):
    """Weights of the structure of a Flax tree of shapes (`jax.eval_shape`
    of an ``init``: no compile) from ``np.random.RandomState(seed)``:
    kernels normal over sqrt(fan in), everything else normal·0.1."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rs.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        return (0.1 * rs.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def trio_params(jpol, jst, seed):
    """Seeded numpy weights in the tree of the JAX improvement policy ``jpol``."""
    return seeded_tree_like(jax.eval_shape(jpol.init, jax.random.PRNGKey(0), jst), seed)


def trio_jax_state(jenv, tenv, inst_np, seed):
    """(JAX state, the port's) from one random initial tour drawn by the port."""
    st = tenv.reset(to_torch(inst_np), torch.Generator().manual_seed(seed))
    fields = {k: jnp.asarray(getattr(st, k).numpy()) for k in
              ("locs", "rec_current", "rec_best", "cost_current", "cost_bsf", "visited_time",
               "i")}
    for k in ("rec_current", "rec_best", "visited_time", "i"):
        fields[k] = fields[k].astype(jnp.int32)
    if hasattr(st, "action_record"):
        fields["action_record"] = jnp.asarray(st.action_record.numpy())
    return _jax_state_class(jenv)(**fields), st


def _jax_state_class(jenv):
    from rl4co_tpu.envs.routing.pdp_ruin_repair import PDPRRState
    from rl4co_tpu.envs.routing.tsp_kopt import TSPkoptState

    return PDPRRState if jenv.name == "pdp_ruin_repair" else TSPkoptState


# ---- the rest of the zoo (MatNet, MatNet-FFSP, MDAM, HAM, L2D) ----

def zoo_tree_pair(tree_name, jax_cls, torch_cls, seed=0, **kwargs):
    """The same seeded weights (`random_params_numpy(policy=tree_name,
    policy_kwargs=kwargs)`) as (JAX module, its params, the port's module on
    the CPU); the tree has the JAX module's structure."""
    tree = random_params_numpy(seed, policy=tree_name, policy_kwargs=kwargs)
    return jax_cls(**kwargs), tree_to_jax(tree), load_params(torch_cls(device="cpu", **kwargs),
                                                             tree)


def assert_gradients_close(tpolicy, jgrads, gauge=1e-4, floor=1e-3):
    """Every parameter's gradient within ``gauge`` of the largest JAX
    gradient, and the largest above ``floor`` (a vanishing loss would make
    the check vacuous)."""
    from rl4co_tpu_torch.convert import convert_params

    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    got = {k: p.grad for k, p in tpolicy.named_parameters()}
    assert set(got) == set(want), set(got) ^ set(want)
    largest = max(np.abs(w).max() for w in want.values())
    assert largest > floor, largest
    for name, g in got.items():
        assert g is not None, name
        err = np.abs(g.numpy() - want[name]).max()
        assert err <= gauge * largest, (name, err, largest)


def assert_loss_close(got, want, terms_scale, rtol=1e-5):
    """A REINFORCE-type loss within ``rtol`` of its terms' scale (the mean of
    |advantage · log-likelihood|): the loss is a mean of terms of both signs
    that cancel, so its own size says nothing of the noise in it."""
    assert terms_scale > 0
    assert abs(float(got) - float(want)) <= rtol * terms_scale, (float(got), float(want),
                                                                 terms_scale)


def reinforce_terms_scale(reward, ll, group_axis_size=None):
    """mean |(reward - its mean) · ll| over rows (numpy), the mean taken over
    the batch, or per group of ``group_axis_size`` repeat-major rows."""
    reward, ll = np.asarray(reward, np.float64), np.asarray(ll, np.float64)
    if group_axis_size:
        r = reward.reshape(group_axis_size, -1)
        adv = (r - r.mean(0, keepdims=True)).reshape(-1)
    else:
        adv = reward - reward.mean(0, keepdims=True)
    return float(np.abs(adv * ll).mean())
