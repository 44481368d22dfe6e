"""The port's `load_reference_npz` against the JAX loader on OP and PCTSP/SPCTSP
files in the reference's format: the same keys, equal float32 values, and the
same exception where a key is missing. Files are generated from a seed."""

import numpy as np
import pytest

from rl4co_tpu.data.io import load_reference_npz as jax_load_reference_npz
from rl4co_tpu_torch.data.io import load_reference_npz

KEYS = {
    "op": ("locs", "depot", "prize", "max_length"),
    "pctsp": ("locs", "depot", "penalty", "deterministic_prize", "stochastic_prize"),
    "spctsp": ("locs", "depot", "penalty", "deterministic_prize", "stochastic_prize"),
}


def reference_file(tmp_path, env_name, layout, seed=0):
    """A file as the reference writes it (float64 arrays), with the env's keys,
    one more (``extra``) or one fewer (``missing``)."""
    rs = np.random.RandomState(seed)
    b, n = 4, 10
    shapes = {"locs": (b, n, 2), "depot": (b, 2), "prize": (b, n), "max_length": (b,),
              "penalty": (b, n), "deterministic_prize": (b, n), "stochastic_prize": (b, n)}
    data = {k: rs.random_sample(shapes[k]) for k in KEYS[env_name]}
    if layout == "extra":
        data["capacity"] = np.full((b,), 2.0)
    elif layout == "missing":
        del data[KEYS[env_name][-1]]
    path = tmp_path / f"{env_name}_{layout}.npz"
    np.savez(path, **data)
    return str(path)


@pytest.mark.parametrize("layout", ["exact", "extra"])
@pytest.mark.parametrize("env_name", sorted(KEYS))
def test_load_reference_npz_keeps_the_reference_keys(tmp_path, env_name, layout):
    path = reference_file(tmp_path, env_name, layout)
    ours, ref = load_reference_npz(path, env_name), jax_load_reference_npz(path, env_name)
    assert sorted(ours) == sorted(ref) == sorted(KEYS[env_name])
    for k in ref:
        assert ours[k].dtype == np.float32 == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))


@pytest.mark.parametrize("env_name", sorted(KEYS))
def test_load_reference_npz_missing_key_raises_as_jax(tmp_path, env_name):
    path = reference_file(tmp_path, env_name, "missing")
    with pytest.raises(KeyError) as jax_err:
        jax_load_reference_npz(path, env_name)
    with pytest.raises(KeyError) as ours:
        load_reference_npz(path, env_name)
    assert type(ours.value) is type(jax_err.value)
