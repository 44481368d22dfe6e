"""Symmetric augmentation (`data/transforms.py`) and the evaluation methods
built on it, against `rl4co_tpu/data/transforms.py`.

The JAX package draws each copy's angle and reflection from `jax.random`,
the port from a `torch.Generator`: the streams differ, so the parity test
draws the angles and reflections from the JAX key with the JAX package's own
calls and hands them to the port. Tolerance atol 1e-6 (cosine and sine of
one f32 angle in two libraries, coordinates in [-0.3, 1.3]); copy 0 and the
features that are not transformed are equal to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.data.transforms import augment_instances as jax_augment
from rl4co_tpu_torch.data.transforms import augment_instances, symmetric_augment
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.tasks.eval import evaluate_policy
from rl4co_tpu_torch.utils.ops import unbatchify

from _torch_port import policy_pair, random_cvrp, random_locs, t2n

torch.set_num_threads(1)

A, B, N = 5, 3, 8


def jax_angles_and_flips(key, num_augment):
    """The angle and reflection JAX's `symmetric_transform` draws for each copy."""
    thetas, flips = [], []
    for k in jax.random.split(key, num_augment):
        ktheta, kflip = jax.random.split(k)
        thetas.append(jax.random.uniform(ktheta, ()) * 2 * jnp.pi)
        flips.append(jax.random.bernoulli(kflip, 0.5))
    return torch.from_numpy(np.asarray(thetas)), torch.from_numpy(np.asarray(flips))


@pytest.mark.parametrize("env_name", ["tsp", "cvrp"])
def test_symmetric_augmentation_matches_jax(env_name):
    inst = random_cvrp(1, B, N) if env_name == "cvrp" else {"locs": random_locs(1, B, N)}
    key = jax.random.PRNGKey(7)
    want = jax_augment({k: jnp.asarray(v) for k, v in inst.items()}, A, "symmetric", key=key)
    theta, flip = jax_angles_and_flips(key, A)
    assert flip.any() and not flip.all()  # both branches are exercised
    got = symmetric_augment({k: torch.from_numpy(v) for k, v in inst.items()}, theta, flip)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == torch.float32, k
        if k in ("locs", "depot"):
            np.testing.assert_allclose(t2n(got[k]), v, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(t2n(got[k]), v, err_msg=k)
        np.testing.assert_array_equal(t2n(got[k][:B]), inst[k])  # copy 0 untransformed


def test_symmetric_copies_keep_every_distance():
    locs = torch.from_numpy(random_locs(2, B, N))
    out = augment_instances({"locs": locs}, A, "symmetric",
                            generator=torch.Generator().manual_seed(0))["locs"]
    dist = torch.cdist(unbatchify(out, A).reshape(B * A, N, 2),
                       unbatchify(out, A).reshape(B * A, N, 2)).reshape(B, A, N, N)
    torch.testing.assert_close(dist, dist[:, :1].expand_as(dist), atol=1e-5, rtol=0)
    assert not torch.allclose(out[B:], out[:B].repeat(A - 1, 1, 1), atol=1e-3)


def test_symmetric_draws_come_from_the_generator():
    locs = {"locs": torch.from_numpy(random_locs(3, B, N))}

    def draw(seed):
        return augment_instances(locs, A, "symmetric",
                                 generator=torch.Generator().manual_seed(seed))["locs"]

    assert torch.equal(draw(4), draw(4)) and not torch.equal(draw(4), draw(5))
    with pytest.raises(ValueError):
        augment_instances(locs, A, "nonsense")


@pytest.mark.parametrize("method,multistart", [("augment", False),
                                               ("multistart_greedy_augment", True)])
def test_symmetric_eval_methods_take_the_best_copy(method, multistart):
    """The methods' own plumbing: the same generator's copies through a greedy
    (or multistart greedy) rollout, the max over starts and then copies."""
    _, _, tpol = policy_pair(seed=1)
    env = get_env("tsp", num_loc=N)
    locs = torch.from_numpy(random_locs(4, B, N))
    res = evaluate_policy(env, tpol, {"locs": locs}, method, batch_size=B, warmup=False,
                          generator=torch.Generator().manual_seed(9), check_solutions=True,
                          device="cpu")
    copies = augment_instances({"locs": locs}, 8, "symmetric",
                               generator=torch.Generator().manual_seed(9))
    spec = DecodeSpec(kind="greedy", tanh_clipping=10.0, multistart=multistart,
                      num_starts=N if multistart else 0)
    with torch.no_grad():
        r = rollout(tpol, env, copies, spec, device="cpu").reward
    if multistart:
        r = unbatchify(r, N).max(dim=-1).values
    np.testing.assert_array_equal(res["rewards"], t2n(unbatchify(r, 8).max(dim=-1).values))
