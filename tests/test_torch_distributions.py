"""The port's location samplers (`rl4co_tpu_torch/envs/distributions.py`)
against the JAX package's (`rl4co_tpu/envs/distributions.py`) and TSP's
``loc_distribution``.

The two draw from different generators, so the draws are held loosely: the
shape, the range and the first two moments of 20 000 points per axis from
each package within 5 standard errors of each other (and of the law's own
moments where it has them). The deterministic part of each clustered sampler
(cluster centres picked, noise added, clipped; mixing; min-max normalising)
is held exactly on the JAX package's own draws, taken from its keys as its
sampler splits them."""

import jax
import numpy as np
import pytest
import torch

from rl4co_tpu.envs.distributions import get_sampler as jax_get_sampler
from rl4co_tpu_torch.envs import distributions as dist
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.rl.reinforce import seeded_generator

from _torch_port import t2n

torch.set_num_threads(1)

NAMES = sorted(dist.SAMPLERS)
B, N = 200, 50  # 10 000 points, 20 000 coordinates
RANGES = {"uniform": (0, 1), "cluster": (0, 1), "mixed": (0, 1), "gaussian_mixture": (0, 1),
          "mix_distribution": (0, 1), "exponential": (0, np.inf), "poisson": (0, np.inf)}


def port_draw(name, seed=0, shape=(B, N, 2)):
    gen = seeded_generator(torch.device("cpu"), seed)
    return t2n(dist.get_sampler(name).sample(shape, gen, device="cpu"))


def jax_draw(name, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    sampler = jax_get_sampler(name)
    return np.asarray(jax.vmap(lambda k: sampler.sample(k, (N, 2)))(keys))


@pytest.mark.parametrize("name", NAMES)
def test_shape_range_and_moments_match_jax(name):
    got, want = port_draw(name), jax_draw(name)
    assert got.shape == want.shape == (B, N, 2) and got.dtype == np.float32
    lo, hi = RANGES.get(name, (-np.inf, np.inf))
    assert got.min() >= lo and got.max() <= hi, (got.min(), got.max())
    # the per-instance choices (centres, variants) make instances, not points,
    # the unit of independence: standard errors over the B instance means
    for axis in range(2):
        g, w = got[..., axis], want[..., axis]
        for stat in (lambda x: x.mean(-1), lambda x: (x ** 2).mean(-1)):
            a, b = stat(g), stat(w)
            se = np.sqrt(a.var() / B + b.var() / B) + 1e-9
            assert abs(a.mean() - b.mean()) <= 5 * se, (name, axis, a.mean(), b.mean(), se)


@pytest.mark.parametrize("name,mean,var", [("uniform", 0.5, 1 / 12), ("normal", 0.5, 0.04),
                                           ("exponential", 1.0, 1.0), ("poisson", 1.0, 1.0)])
def test_plain_laws_have_their_moments(name, mean, var):
    x = port_draw(name, seed=1).reshape(-1)
    se = np.sqrt(var / x.size)
    assert abs(x.mean() - mean) <= 5 * se, (x.mean(), mean)
    assert abs(x.var() - var) <= 0.05 * var, (x.var(), var)
    if name == "poisson":
        assert (x == np.round(x)).all()


def test_cluster_transform_is_jax_on_jax_draws():
    key, shape = jax.random.PRNGKey(3), (4, 30, 2)
    kc, kp, ka = jax.random.split(key, 3)   # the JAX sampler's own split
    centers = jax.random.uniform(kc, (4, 3, 2), minval=0.2, maxval=0.8)
    assign = jax.random.randint(ka, (4, 30), 0, 3)
    noise = jax.random.normal(kp, shape)
    want = np.asarray(jax_get_sampler("cluster").sample(key, shape))
    got = t2n(dist.cluster_points(*(torch.from_numpy(np.asarray(a).copy())
                                    for a in (centers, assign, noise)), 0.07))
    np.testing.assert_array_equal(got, want)


def test_mixed_transform_is_jax_on_jax_draws():
    key, shape = jax.random.PRNGKey(4), (4, 30, 2)
    ku, kc, km = jax.random.split(key, 3)
    uniform_pts = jax.random.uniform(ku, shape)
    cluster_pts = jax_get_sampler("cluster", n_cluster=1).sample(kc, shape)
    take = jax.random.bernoulli(km, 0.5, (4, 30, 1))
    want = np.asarray(jax_get_sampler("mixed").sample(key, shape))
    got = t2n(dist.mixed_points(*(torch.from_numpy(np.asarray(a).copy())
                                  for a in (uniform_pts, cluster_pts, take))))
    np.testing.assert_array_equal(got, want)


def test_gaussian_mixture_transform_is_jax_on_jax_draws():
    key, shape = jax.random.PRNGKey(5), (4, 30, 2)
    kc, kp, ka = jax.random.split(key, 3)
    centers = jax.random.uniform(kc, (4, 3, 2), minval=0.0, maxval=10.0)
    assign = jax.random.randint(ka, (4, 30), 0, 3)
    noise = jax.random.normal(kp, shape)
    want = np.asarray(jax_get_sampler("gaussian_mixture").sample(key, shape))
    got = t2n(dist.gaussian_mixture_points(*(torch.from_numpy(np.asarray(a).copy())
                                             for a in (centers, assign, noise))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_mix_distribution_draws_each_variant_per_instance():
    gen = seeded_generator(torch.device("cpu"), 0)
    pts = t2n(dist.MixDistribution().sample((300, 20, 2), gen, device="cpu"))
    spread = pts.std(axis=1).mean(-1)  # clustered instances are tight
    assert (spread < 0.2).any() and (spread > 0.25).any()


def test_get_sampler_factory_matches_jax():
    for name in NAMES:
        assert type(dist.get_sampler(name)).__name__ == type(jax_get_sampler(name)).__name__
    const = dist.get_sampler(0.25)
    assert (const.low, const.high) == (0.25, 0.25)
    assert (t2n(const.sample((3, 2), device="cpu")) == 0.25).all()
    fn = lambda shape, generator=None, device="cpu": torch.zeros(shape)  # noqa: E731
    assert dist.get_sampler(fn) is fn
    with pytest.raises(ValueError, match="Invalid distribution"):
        dist.get_sampler("zipf")
    with pytest.raises(ValueError, match="Invalid distribution"):
        jax_get_sampler("zipf")


@pytest.mark.parametrize("name", NAMES)
def test_tsp_takes_every_loc_distribution(name):
    from rl4co_tpu.envs import get_env as jax_get_env

    env = get_env("tsp", num_loc=12, loc_distribution=name)
    locs = t2n(env.generate(8, seeded_generator(torch.device("cpu"), 1), device="cpu")["locs"])
    want = np.asarray(jax_get_env("tsp", num_loc=12, loc_distribution=name).generate_batch(
        jax.random.PRNGKey(0), 8)["locs"])
    assert locs.shape == want.shape == (8, 12, 2)
    assert locs.dtype == want.dtype == np.float32 and np.isfinite(locs).all()


def test_uniform_tsp_draw_is_unchanged():
    env, plain = get_env("tsp", num_loc=9, loc_distribution="uniform"), get_env("tsp", num_loc=9)
    a = env.generate(4, seeded_generator(torch.device("cpu"), 7), device="cpu")["locs"]
    b = plain.generate(4, seeded_generator(torch.device("cpu"), 7), device="cpu")["locs"]
    assert torch.equal(a, b)
    gen = seeded_generator(torch.device("cpu"), 7)
    assert torch.equal(a, torch.rand((4, 9, 2), generator=gen))
