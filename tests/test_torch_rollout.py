"""The slice as a whole at small size: the port's rollout against the JAX
package's, with the JAX pointer step both as the interpreted Pallas kernel
("pallas") and as plain XLA ("xla"). Actions equal; reward rtol 1e-5;
log-likelihood and entropy atol 1e-4 (sums of f32 log-probs in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import rollout as jax_rollout
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.models.policies.constructive import select_best

from _torch_port import policy_pair, random_locs, t2n

torch.set_num_threads(1)

N, B = 10, 6
KEY = jax.random.PRNGKey(0)


def both(spec_kwargs, jimpl, replay=None, seed=0):
    jpol, jparams, tpol = policy_pair(seed=seed, jax_pointer_impl=jimpl)
    locs = random_locs(seed + 1, B, N)
    jout = jax_rollout(jpol, jparams, jax_get_env("tsp", num_loc=N),
                       {"locs": jnp.asarray(locs)}, KEY, JaxSpec(**spec_kwargs),
                       None if replay is None else jnp.asarray(replay, dtype=jnp.int32))
    tout = rollout(tpol, get_env("tsp", num_loc=N), {"locs": locs},
                   DecodeSpec(**spec_kwargs), replay_actions=replay, device="cpu")
    return jout, tout


def assert_outputs_match(jout, tout):
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    np.testing.assert_allclose(t2n(tout.reward), np.asarray(jout.reward), rtol=1e-5)
    np.testing.assert_allclose(t2n(tout.log_likelihood), np.asarray(jout.log_likelihood),
                               atol=1e-4)
    np.testing.assert_allclose(t2n(tout.logprobs), np.asarray(jout.logprobs), atol=1e-4)
    np.testing.assert_allclose(t2n(tout.entropy), np.asarray(jout.entropy), atol=1e-4)


@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
def test_greedy_rollout(jimpl):
    jout, tout = both(dict(kind="greedy", tanh_clipping=10.0), jimpl)
    assert tout.actions.shape == (B, N)
    assert_outputs_match(jout, tout)


@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
@pytest.mark.parametrize("select", [False, True], ids=["all-starts", "select-best"])
def test_multistart_greedy_rollout(jimpl, select):
    jout, tout = both(dict(kind="greedy", tanh_clipping=10.0, multistart=True,
                           num_starts=N, select_best=select), jimpl)
    assert tout.actions.shape == ((B, N) if select else (N * B, N))
    assert_outputs_match(jout, tout)
    if not select:
        # forced first actions, repeat-major: start s of every instance, then s+1
        np.testing.assert_array_equal(t2n(tout.actions[:, 0]), np.repeat(np.arange(N), B))
        assert (t2n(tout.logprobs[:, 0]) == 0.0).all()


@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
def test_evaluate_replays_given_actions(jimpl):
    rs = np.random.RandomState(3)
    replay = np.stack([rs.permutation(N) for _ in range(B)])
    jout, tout = both(dict(kind="evaluate", tanh_clipping=10.0), jimpl, replay=replay)
    np.testing.assert_array_equal(t2n(tout.actions), replay)
    assert_outputs_match(jout, tout)


@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
def test_sampled_actions_have_the_jax_log_likelihood(jimpl):
    """`jax.random` and `torch.Generator` give different draws, so the port's
    sampled actions are fed to the JAX package in evaluate mode."""
    samples = 3
    jpol, jparams, tpol = policy_pair(jax_pointer_impl=jimpl)
    locs = random_locs(5, B, N)
    gen = torch.Generator().manual_seed(7)
    tout = rollout(tpol, get_env("tsp", num_loc=N), {"locs": locs},
                   DecodeSpec(kind="sampling", tanh_clipping=10.0, num_samples=samples),
                   generator=gen, device="cpu")
    actions = t2n(tout.actions)
    assert actions.shape == (samples * B, N)
    assert (np.sort(actions, axis=-1) == np.arange(N)).all()
    assert len({tuple(a) for a in actions}) > B  # the samples differ
    jout = jax_rollout(jpol, jparams, jax_get_env("tsp", num_loc=N),
                       {"locs": jnp.asarray(locs)}, KEY,
                       JaxSpec(kind="evaluate", tanh_clipping=10.0, num_samples=samples),
                       jnp.asarray(actions, dtype=jnp.int32))
    assert_outputs_match(jout, tout)


def test_kernel_and_plain_pointer_paths_agree_on_cpu():
    _, _, t_kernel = policy_pair(torch_pointer_impl="kernel")
    _, _, t_plain = policy_pair(torch_pointer_impl="plain")
    locs = random_locs(2, B, N)
    env = get_env("tsp", num_loc=N)
    spec = DecodeSpec(kind="greedy", tanh_clipping=10.0, multistart=True, num_starts=N)
    a = rollout(t_kernel, env, {"locs": locs}, spec, device="cpu")
    b = rollout(t_plain, env, {"locs": locs}, spec, device="cpu")
    np.testing.assert_array_equal(t2n(a.actions), t2n(b.actions))
    np.testing.assert_allclose(t2n(a.log_likelihood), t2n(b.log_likelihood), atol=1e-5)


def test_select_best_takes_the_best_repeat():
    _, _, tpol = policy_pair()
    locs = random_locs(4, B, N)
    env = get_env("tsp", num_loc=N)
    spec = DecodeSpec(kind="greedy", tanh_clipping=10.0, multistart=True, num_starts=N)
    out = rollout(tpol, env, {"locs": locs}, spec, device="cpu")
    best = select_best(out, N)
    np.testing.assert_allclose(t2n(best.reward), t2n(out.reward).reshape(N, B).max(axis=0))
    env.check_solution_validity({}, t2n(best.actions))


def test_rollout_builds_no_graph_and_refuses_beam_search():
    """The graph follows the ambient grad mode: none under `torch.no_grad()`
    or with frozen parameters, one back to every parameter otherwise; the
    entry points that only need tours (`evaluate_policy`) build none."""
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    _, _, tpol = policy_pair()
    tpol.requires_grad_(True)
    env = get_env("tsp", num_loc=N)
    inst = {"locs": random_locs(0, 2, N)}
    with torch.no_grad():
        out = rollout(tpol, env, inst, DecodeSpec(kind="greedy"), device="cpu")
    assert not out.reward.requires_grad and not out.log_likelihood.requires_grad
    assert out.log_likelihood.grad_fn is None and out.entropy.grad_fn is None

    for spec in (DecodeSpec(kind="sampling", tanh_clipping=10.0),
                 DecodeSpec(kind="sampling", tanh_clipping=10.0, multistart=True,
                            num_starts=N)):
        out = rollout(tpol, env, inst, spec, generator=torch.Generator().manual_seed(0),
                      device="cpu")
        assert out.log_likelihood.requires_grad and out.logprobs.requires_grad
        assert out.entropy.requires_grad
        assert not out.reward.requires_grad and not out.actions.requires_grad
        tpol.zero_grad()
        out.log_likelihood.sum().backward()  # no in-place write on a recorded tensor
        for name, p in tpol.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    if spec.multistart:  # the forced first step has log-probability 0 and no graph
        assert (out.logprobs[:, 0] == 0).all()

    res = evaluate_policy(env, tpol, inst, "sampling", num_samples=3, device="cpu",
                          warmup=False, return_actions=True)
    assert res["rewards"].shape == (2,)  # numpy: nothing recorded reaches the caller

    tpol.requires_grad_(False)
    out = rollout(tpol, env, inst, DecodeSpec(kind="greedy"), device="cpu")
    assert not out.log_likelihood.requires_grad
    # beam search, once refused, now runs (`test_torch_beam_search.py` holds it
    # to the JAX package): valid best tours, and no graph with frozen weights
    out = rollout(tpol, env, inst, DecodeSpec(kind="beam_search", select_best=True),
                  device="cpu")
    assert out.actions.shape == (2, N) and not out.log_likelihood.requires_grad
    env.check_solution_validity({}, t2n(out.actions))


def test_policy_options_match_jax():
    """AM's ``mask_inner=False`` (plain pointer path; the JAX package's XLA
    path) on TSP, multistart greedy."""
    from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
    from rl4co_tpu_torch.convert import load_params, random_params_numpy
    from rl4co_tpu_torch.models import AttentionModelPolicy

    from _torch_port import SMALL, tree_to_jax

    tree = random_params_numpy(8, SMALL["embed_dim"], SMALL["num_encoder_layers"],
                               SMALL["feedforward_hidden"])
    inst = {"locs": random_locs(9, B, N)}
    jpol = JaxPolicy(env_name="tsp", mask_inner=False, **SMALL)
    tpol = load_params(AttentionModelPolicy(env_name="tsp", mask_inner=False,
                                            pointer_impl="plain", device="cpu", **SMALL), tree)
    spec = dict(kind="greedy", tanh_clipping=10.0, multistart=True, num_starts=N)
    jout = jax_rollout(jpol, tree_to_jax(tree), jax_get_env("tsp", num_loc=N),
                       {k: jnp.asarray(v) for k, v in inst.items()}, KEY, JaxSpec(**spec))
    with torch.no_grad():
        tout = rollout(tpol, get_env("tsp", num_loc=N), inst, DecodeSpec(**spec),
                       device="cpu")
    assert_outputs_match(jout, tout)
    torch.testing.assert_close(tpol.init_embed({k: torch.from_numpy(v) for k, v in inst.items()}),
                               tpol.init_embedding({k: torch.from_numpy(v)
                                                    for k, v in inst.items()}))
