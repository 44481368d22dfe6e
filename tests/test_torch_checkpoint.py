"""The committed AM TSP-50 checkpoint, full width, through both packages on
the CPU: greedy on the first 64 instances of the committed test set in one
dispatch. (The checkpoint's score over all 10 000 instances is not asked
for: through batch norm it depends on the dispatch sizes of that run.)"""

import os

import numpy as np
import torch

from rl4co_tpu.checkpoint import restore_checkpoint_raw
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate
from rl4co_tpu_torch.convert import load_params
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.tasks.eval import evaluate_policy

from _torch_port import ROOT, TSP50_FILE, tree_to_numpy

torch.set_num_threads(1)

CKPT = os.path.join(ROOT, "runs", "ckpt_am_tsp50", "best")
COUNT = 64


def test_committed_checkpoint_gives_the_same_greedy_tours():
    params = restore_checkpoint_raw(CKPT)["state"]["params"]
    tree = tree_to_numpy(params)
    policy = load_params(AttentionModelPolicy(env_name="tsp", device="cpu"), tree).eval()
    locs = np.load(TSP50_FILE)["locs"][:COUNT]
    jres = jax_evaluate(jax_get_env("tsp", num_loc=50), JaxPolicy(env_name="tsp"), params,
                        {"locs": locs}, "greedy", batch_size=COUNT, return_actions=True,
                        check_solutions=True, warmup=False)
    tres = evaluate_policy(get_env("tsp", num_loc=50), policy, {"locs": locs}, "greedy",
                           batch_size=COUNT, check_solutions=True, warmup=False,
                           device="cpu")
    same = (tres["actions"] == jres["actions"]).all(axis=1).sum()
    assert same >= COUNT - 1, f"only {same} of {COUNT} tours equal"
    rel = abs(tres["mean_reward"] - jres["mean_reward"]) / abs(jres["mean_reward"])
    assert rel <= 1e-4, rel
    # a trained model: well below the ~26 of a random tour on TSP-50
    assert 5.5 < -tres["mean_reward"] < 6.2, tres["mean_reward"]
