"""The decoder's dynamic route against the JAX package's: SDVRP's dynamic
embedding (`rl4co_tpu/models/nn/env_embeddings/dynamic.py`), the AM decode
step that adds its deltas to K/V/logit keys (`rl4co_tpu/models/zoo/am.py`),
and the cache tiled per repeat in multistart, sampling and beam search
(`rl4co_tpu/models/policies/constructive.py`, `beam_search.py`).

Tolerances: the embedding's deltas and the decode step's logits atol 1e-5
(f32, other summation orders); rollouts: equal actions, rewards rtol 1e-5,
log-likelihoods atol 1e-4 (`test_torch_rollout.py`'s); the REINFORCE loss
atol 2e-5 and every gradient, ``dynamic_embedding.projection`` included,
rtol 1e-3 / atol 1e-5 (`test_torch_reinforce.py`'s), the atol scaled by the
largest gradient where that exceeds 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.models.nn.env_embeddings.dynamic import SDVRPDynamicEmbedding as JaxDynamic
from rl4co_tpu.rl import baselines as jbl
from rl4co_tpu.rl.reinforce import REINFORCE as JaxREINFORCE
from rl4co_tpu_torch.convert import convert_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import (
    DYNAMIC_EMBEDDING_REGISTRY,
    JSSPDynamicEmbedding,
    SDVRPDynamicEmbedding,
    StaticEmbedding,
    env_dynamic_embedding,
)
from rl4co_tpu_torch.rl import baselines as tbl
from rl4co_tpu_torch.rl.reinforce import REINFORCE
from rl4co_tpu_torch.utils.ops import batchify

from _torch_port import (
    KEY,
    am_pair,
    assert_rollouts_match,
    env_pair,
    jax_instances,
    rollout_pair,
    t2n,
    to_jax,
    to_torch,
    tree_to_numpy,
)

torch.set_num_threads(1)

N, B = 8, 4


def sdvrp_states(inst, steps=5, seed=0):
    """Pairs of states along a random feasible episode of both envs."""
    tenv, jenv = env_pair("sdvrp", N)
    rs = np.random.RandomState(seed)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch(to_jax(inst))
    pairs = [(ts, js)]
    for _ in range(steps):
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, act)
        pairs.append((ts, js))
    return pairs


def test_registry_and_the_static_embedding():
    assert set(DYNAMIC_EMBEDDING_REGISTRY) == {"sdvrp"}
    assert isinstance(env_dynamic_embedding("cvrp", 16), StaticEmbedding)
    assert isinstance(env_dynamic_embedding("sdvrp", 16), SDVRPDynamicEmbedding)
    assert list(StaticEmbedding(16).parameters()) == []
    # L2D's scheduling deltas read the encoder's machine embeddings: the L2D
    # policy holds them, the routing registry does not
    assert [n for n, _ in JSSPDynamicEmbedding(16).named_parameters()] == [
        "project_node_step.weight", "project_edge_step.weight"]


def test_sdvrp_dynamic_embedding_matches_jax():
    d = 16
    kernel = np.random.RandomState(0).standard_normal((1, 3 * d)).astype(np.float32)
    jmod = JaxDynamic(embed_dim=d)
    tmod = SDVRPDynamicEmbedding(d)
    tmod.load_state_dict(convert_params({"projection": {"kernel": kernel}}))
    inst = jax_instances(env_pair("sdvrp", N)[1], 1, B)
    for ts, js in sdvrp_states(inst):
        want = jmod.apply({"params": {"projection": {"kernel": jnp.asarray(kernel)}}}, js)
        with torch.no_grad():
            got = tmod(ts)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=0, atol=1e-5)


def test_decode_step_adds_the_deltas_as_jax_and_refuses_grouping():
    jpol, params, tpol = am_pair("sdvrp", seed=1)
    inst = jax_instances(env_pair("sdvrp", N)[1], 2, B)
    jinst, tinst = to_jax(inst), to_torch(inst)
    jcache = jpol.apply(params, jpol.apply(params, jinst, method="encode"), method="precompute")
    tenv, jenv = env_pair("sdvrp", N)
    with torch.no_grad():
        tcache = tpol.precompute(tpol.encode(tinst))
        for ts, js in sdvrp_states(inst, seed=3):
            want = jpol.apply(params, jcache, js, jenv.action_mask_batch(js), 1,
                              method="decode_step")
            got = tpol.decode_step(tcache, ts, tenv.action_mask(ts), 1)
            np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=1e-5)
        state = tenv.reset(batchify(tinst, 2))
        with pytest.raises(ValueError, match="static embeddings"):
            tpol.decode_step(tcache, state, tenv.action_mask(state), 2)


@pytest.mark.parametrize("spec", [
    dict(kind="greedy", multistart=True, num_starts=N),
    dict(kind="beam_search", beam_width=3, select_best=True),
    dict(kind="beam_search", beam_width=3, select_best=False),
], ids=["multistart", "beam-best", "beam-all"])
def test_tiled_route_matches_jax(spec):
    """Multistart greedy and beam search on SDVRP: the cache tiled per
    repeat, one query per row at every step."""
    jpol, params, tpol = am_pair("sdvrp", seed=5)
    inst = jax_instances(env_pair("sdvrp", N)[1], 3, B)
    seen = []
    inner = tpol.decode_step

    def decode_step(cache, state, mask, num_repeats=1):
        seen.append((num_repeats, cache.glimpse_key.shape[0], state.done.shape[0]))
        return inner(cache, state, mask, num_repeats)

    tpol.decode_step = decode_step
    want, got = rollout_pair(jpol, params, tpol, "sdvrp", inst, tanh_clipping=10.0, **spec)
    repeats = spec.get("num_starts") or spec["beam_width"]
    assert set(seen) == {(1, repeats * B, repeats * B)}
    assert_rollouts_match(want, got)


def test_sampling_repeats_take_the_tiled_route():
    """Samples drawn by each package differ: the port's own samples replay
    through the tiled route to the rewards and log-likelihoods it drew."""
    _, _, tpol = am_pair("sdvrp", seed=6)
    inst = jax_instances(env_pair("sdvrp", N)[1], 4, B)
    from rl4co_tpu_torch.models import rollout

    tenv, _ = env_pair("sdvrp", N)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        drawn = rollout(tpol, tenv, inst, DecodeSpec(kind="sampling", num_samples=3),
                        generator=gen, device="cpu")
        replay = rollout(tpol, tenv, {k: np.concatenate([v] * 3) for k, v in inst.items()},
                         DecodeSpec(kind="evaluate"), replay_actions=drawn.actions, device="cpu")
    np.testing.assert_allclose(t2n(replay.log_likelihood), t2n(drawn.log_likelihood), atol=1e-5)
    np.testing.assert_array_equal(t2n(replay.reward), t2n(drawn.reward))
    tenv.check_solution_validity({k: np.concatenate([v] * 3) for k, v in inst.items()},
                                 t2n(drawn.actions))


def named_grads(jgrads):
    return {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}


@pytest.mark.parametrize("multistart", [False, True], ids=["greedy", "multistart"])
def test_reinforce_loss_and_every_gradient_match_jax(multistart):
    """The REINFORCE loss of AM on SDVRP (greedy train spec on both sides, so
    the actions are equal; the batch mean as the baseline, or POMO's shared
    one over the tiled starts) and every gradient, the dynamic projection's included: it
    reaches the loss only through the pointer step's K/V/logit keys."""
    jpol, jparams, tpol = am_pair("sdvrp", seed=7)
    tpol.train().requires_grad_(True)
    spec = dict(kind="greedy", tanh_clipping=10.0)
    if multistart:
        spec.update(multistart=True, num_starts=N)
        jbase, tbase = jbl.SharedBaseline(num_repeats=N), tbl.SharedBaseline(num_repeats=N)
    else:
        jbase, tbase = jbl.MeanBaseline(), tbl.MeanBaseline()
    tenv, jenv = env_pair("sdvrp", N)
    jalgo = JaxREINFORCE(env=jenv, policy=jpol, baseline=jbase, train_spec=JaxSpec(**spec))
    talgo = REINFORCE(tenv, tpol, baseline=tbase, train_spec=DecodeSpec(**spec))
    inst = jax_instances(jenv, 8, B)
    (jloss, (_, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, jbl.BaselineState(), to_jax(inst), KEY)
    tloss, (_, tout) = talgo.loss(to_torch(inst))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-5)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = named_grads(jgrads)
    got = {k: p.grad for k, p in tpol.named_parameters()}
    assert set(got) == set(want) and "dynamic_embedding.projection.weight" in got
    # atol 1e-5 of the largest gradient where that exceeds 1: SDVRP's
    # advantages reach the gradients at up to 17 (3N decode steps), where f32
    # sums in another order differ by 2e-6 of it
    atol = 1e-5 * max(1.0, max(np.abs(w).max() for w in want.values()))
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=atol, err_msg=name)
    assert np.abs(want["dynamic_embedding.projection.weight"]).max() > 1e-3


def test_the_pointer_function_records_the_step_on_fresh_keys():
    """With gradients on, every step's logits come from the pointer's
    `autograd.Function` called on that step's new K/V/logit keys (on a CUDA
    tensor it launches the kernel there; nothing takes another route)."""
    _, _, tpol = am_pair("sdvrp", seed=9)
    tenv, jenv = env_pair("sdvrp", N)
    inst = to_torch(jax_instances(jenv, 9, B))
    cache = tpol.precompute(tpol.encode(inst))
    state = tenv.reset(inst)
    logits = tpol.decode_step(cache, state, tenv.action_mask(state), 1)
    assert "PointerLogits" in type(logits.grad_fn).__name__
    logits.sum().backward()
    assert tpol.dynamic_embedding.projection.weight.grad.abs().max() > 0
    # the tree's leaf for it: Flax's Dense kernel [1, 3D]
    assert random_params_numpy(0, 16, 1, 16, env_name="sdvrp")["dynamic_embedding"][
        "projection"]["kernel"].shape == (1, 48)
