"""The golden file `rl4co_tpu_torch/golden/am_tsp50_rs0.json`: the JAX
package's greedy tours, log-likelihoods and costs for seeded full-width
weights on the first 16 instances of the committed TSP-50 test set, in one
dispatch. The card's smoke run replays it where no JAX exists; here it is
recomputed so it cannot rot, and the port is held to it on the CPU.

Run this module as a script to (re)write the file:
    JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import json
import os
import sys

import jax
import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

from _torch_port import ROOT, TSP50_FILE, policy_pair, t2n  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models import rollout as jax_rollout  # noqa: E402
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import rollout  # noqa: E402

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "rl4co_tpu_torch", "golden", "am_tsp50_rs0.json")
FULL = dict(embed_dim=128, num_heads=8, num_encoder_layers=3, feedforward_hidden=512)
NUM_INSTANCES = 16


def compute_golden() -> dict:
    """Greedy rollout of the JAX package: `random_params_numpy(0)`, full width."""
    jpol, jparams, _ = policy_pair(seed=0, **FULL)
    locs = np.load(TSP50_FILE)["locs"][:NUM_INSTANCES]
    out = jax_rollout(jpol, jparams, jax_get_env("tsp", num_loc=50), {"locs": locs},
                      jax.random.PRNGKey(0), JaxSpec(kind="greedy", tanh_clipping=10.0))
    return {
        "what": "JAX package, AM 128/8/3/512 batch norm, random_params_numpy(0), greedy, "
                "tanh clipping 10, first 16 instances of data/tsp/test50_seed1234.npz "
                "in one dispatch, CPU f32",
        "numpy": np.__version__,
        "jax": jax.__version__,
        "actions": np.asarray(out.actions).astype(int).tolist(),
        "log_likelihood": [float(x) for x in np.asarray(out.log_likelihood)],
        "cost": [float(-x) for x in np.asarray(out.reward)],
    }


def test_golden_file_is_what_the_jax_package_computes():
    with open(GOLDEN) as f:
        stored = json.load(f)
    fresh = compute_golden()
    np.testing.assert_array_equal(np.asarray(stored["actions"]), np.asarray(fresh["actions"]))
    np.testing.assert_allclose(stored["log_likelihood"], fresh["log_likelihood"], atol=1e-4)
    np.testing.assert_allclose(stored["cost"], fresh["cost"], rtol=1e-6)


def test_port_reproduces_golden_on_cpu():
    with open(GOLDEN) as f:
        stored = json.load(f)
    actions = np.asarray(stored["actions"])
    assert actions.shape == (NUM_INSTANCES, 50)
    _, _, tpol = policy_pair(seed=0, **FULL)
    env = get_env("tsp", num_loc=50)
    inst = {"locs": np.load(TSP50_FILE)["locs"][:NUM_INSTANCES]}
    greedy = rollout(tpol, env, inst, DecodeSpec(kind="greedy", tanh_clipping=10.0),
                     device="cpu")
    np.testing.assert_array_equal(t2n(greedy.actions), actions)
    replay = rollout(tpol, env, inst, DecodeSpec(kind="evaluate", tanh_clipping=10.0),
                     replay_actions=actions, device="cpu")
    np.testing.assert_allclose(t2n(replay.log_likelihood), stored["log_likelihood"], atol=1e-4)
    np.testing.assert_allclose(-t2n(replay.reward), stored["cost"], rtol=1e-5)


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(compute_golden(), f, indent=1)
        f.write("\n")
    print("wrote", GOLDEN)
