"""The port's improvement policies DACT, N2S and NeuOpt against the JAX
package's (`rl4co_tpu/models/zoo/{dact,n2s,n2s_encoder,neuopt}.py`), on
numpy-seeded weights in the Flax trees' structure carried across by the
weight bridge (`tests/test_torch_convert_improvement.py` takes Flax's own
initialisation through it).

The two frameworks' random streams cannot be matched, so the port replays
the JAX package's sampled moves, with the same previous-action masks, step
after step along the JAX episode: the log-probabilities are held at atol
1e-5, the embeds at atol 1e-5, and the packed action that the port decodes
from the replayed selections must equal the JAX package's to the integer
(NeuOpt's ends and stops included). The evaluation without the previous
action's mask, as the PPO epochs run it, is held in
`test_torch_n_step_ppo.py`. The port's own draws give valid tours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu_torch.convert import load_params
from rl4co_tpu_torch.decoding import DecodeSpec

from _torch_port import (TRIO_SMALL, t2n, trio_jax_state, trio_params, trio_setup,
                         trio_state_to_torch)

torch.set_num_threads(1)

ATOL = 1e-5
SPEC = DecodeSpec(kind="sampling", tanh_clipping=6.0)
JSPEC = JaxSpec(kind="sampling", tanh_clipping=6.0)
SIZES = {"dact": 10, "n2s": 10, "neuopt": 10}


def trio_pair(name, b=4, seed=0):
    jenv, tenv, jpol, tcls, jact, tact, _ = trio_setup(name, SIZES[name], **TRIO_SMALL)
    inst = {k: np.asarray(v) for k, v in
            jenv.generate_batch(jax.random.PRNGKey(seed), b).items()}
    jst, _ = trio_jax_state(jenv, tenv, inst, seed + 1)
    params = trio_params(jpol, jst, seed + 2)
    tpol = load_params(tcls(**TRIO_SMALL, device="cpu"), params)
    return jenv, tenv, jpol, params, tpol, jact, tact, inst, jst


@pytest.mark.parametrize("name", ["dact", "n2s", "neuopt"])
def test_replayed_episode_gives_the_jax_logprobs_embeds_and_actions(name):
    jenv, tenv, jpol, params, tpol, jact, tact, inst, jst = trio_pair(name)
    jact = jax.jit(jact, static_argnums=(0, 4))
    step = jax.jit(jenv.step_batch)
    width = {"dact": 2, "n2s": 3, "neuopt": 12}[name]
    prev = jnp.zeros((4, width), jnp.int32)
    evaluate = DecodeSpec(kind="evaluate", tanh_clipping=6.0)
    for t in range(4):
        action, logp, embeds = jact(jpol, params, jst, jax.random.PRNGKey(10 + t), JSPEC,
                                    prev)
        tst = trio_state_to_torch(tenv, inst, jst)
        replay = torch.tensor(np.asarray(action)).long()
        got_a, got_lp, got_emb = tact(tpol, tst, evaluate, None,
                                      torch.tensor(np.asarray(prev)).long(), replay)
        np.testing.assert_array_equal(t2n(got_a), np.asarray(action))
        np.testing.assert_allclose(t2n(got_lp), np.asarray(logp), atol=ATOL)
        np.testing.assert_allclose(t2n(got_emb), np.asarray(embeds), atol=ATOL)
        jst, _ = step(jst, action)
        prev = action


@pytest.mark.parametrize("name", ["dact", "n2s", "neuopt"])
def test_sampled_moves_keep_valid_tours(name):
    jenv, tenv, jpol, params, tpol, jact, tact, inst, jst = trio_pair(name, seed=5)
    st = trio_state_to_torch(tenv, inst, jst)
    g = torch.Generator().manual_seed(0)
    prev = None
    for _ in range(6):
        prev, logp, _ = tact(tpol, st, SPEC, g, prev)
        assert torch.isfinite(logp).all() and (logp <= 0).all()
        st, reward = tenv.step(st, prev)
        assert (reward >= 0).all()
        for b in range(4):
            tenv.check_solution_validity(None, t2n(st.rec_current[b]))
            tenv.check_solution_validity(None, t2n(st.rec_best[b]))
    if name == "dact":
        assert (prev[:, 0] != prev[:, 1]).all()


def test_dact_pair_logits_match_jax():
    jenv, tenv, jpol, params, tpol, *_, inst, jst = trio_pair("dact", seed=3)
    logits, embeds = jpol.apply(params, jst)
    got_l, got_e = tpol(trio_state_to_torch(tenv, inst, jst))
    np.testing.assert_allclose(t2n(got_l), np.asarray(logits), atol=ATOL)
    np.testing.assert_allclose(t2n(got_e), np.asarray(embeds), atol=ATOL)


def test_models_build_their_defaults_and_refuse_to_run_without_a_card():
    from rl4co_tpu_torch.models.zoo.dact import DACT
    from rl4co_tpu_torch.models.zoo.n2s import N2S
    from rl4co_tpu_torch.models.zoo.neuopt import NeuOpt

    algos = {"dact": DACT(device="cpu"), "n2s": N2S(device="cpu"),
             "neuopt": NeuOpt(device="cpu")}
    assert algos["dact"].env.k_max == 2 and algos["neuopt"].env.k_max == 4
    assert algos["dact"].policy.embed_dim == 64 and algos["n2s"].policy.embed_dim == 128
    assert algos["neuopt"].action_dim == 12 and algos["n2s"].action_dim == 3
    assert algos["dact"].critic.project_node.in_features == 128
    assert algos["n2s"].critic.project_node.in_features == 128
    if not torch.cuda.is_available():
        for ctor in (DACT, N2S, NeuOpt):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ctor()
