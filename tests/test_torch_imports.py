"""The port stands alone: it imports nothing of JAX or of the JAX package,
builds nothing at import, and runs on the CPU only when asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import ROOT

PKG = os.path.join(ROOT, "rl4co_tpu_torch")
FORBIDDEN = ("jax", "flax", "orbax", "optax", "rl4co_tpu", "triton", "chex")


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_has_the_modules_of_the_slice():
    rel = {os.path.relpath(p, ROOT) for p in port_files()}
    for want in ("utils/ops.py", "data/io.py", "data/transforms.py", "envs/base.py",
                 "envs/routing/tsp.py", "models/nn/ops.py", "models/nn/attention.py",
                 "models/nn/graph/attnnet.py", "models/nn/env_embeddings/init.py",
                 "models/nn/env_embeddings/context.py", "ops/pointer_kernel.py",
                 "ops/_build.py", "decoding.py", "models/policies/constructive.py",
                 "models/zoo/am.py", "tasks/eval.py", "convert.py",
                 "rl/baselines.py", "rl/reinforce.py", "utils/optim.py", "checkpoint.py",
                 "trainer.py", "envs/routing/cvrp.py", "models/zoo/pomo.py",
                 "models/nn/env_embeddings/edge.py", "models/nn/graph/gnn.py",
                 "models/zoo/nargnn.py", "models/policies/nonautoregressive.py",
                 "envs/routing/local_search.py", "models/zoo/deepaco.py",
                 "models/zoo/gfacs.py", "envs/routing/cvrptw.py", "envs/routing/sdvrp.py",
                 "envs/routing/pdp.py", "envs/routing/mtsp.py", "envs/routing/mtvrp.py",
                 "models/nn/env_embeddings/dynamic.py", "data/solomon.py",
                 "envs/distributions.py", "envs/routing/cvrpmvc.py", "envs/routing/svrp.py",
                 "envs/routing/mpdp.py", "envs/routing/mdcpdp.py", "data/tsplib.py",
                 "data/generate.py", "models/zoo/glop.py", "rl/critic.py", "rl/utils.py",
                 "rl/ppo.py", "rl/a2c.py", "envs/scheduling/smtwtp.py", "envs/eda/dpp.py",
                 "envs/graph/flp.py", "envs/graph/mcp.py", "models/zoo/eas.py",
                 "models/nn/pos_embeddings.py", "envs/routing/tsp_kopt.py",
                 "envs/routing/pdp_ruin_repair.py", "models/zoo/dact.py", "rl/n_step_ppo.py",
                 "models/zoo/n2s_encoder.py", "models/zoo/n2s.py", "models/zoo/neuopt.py"):
        assert os.path.join("rl4co_tpu_torch", want) in rel, want
    for source in ("pointer_kernel.cu", "local_search.cpp"):
        assert os.path.exists(os.path.join(PKG, "csrc", source)), source


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"
        assert not mod.startswith("torch.utils.cpp_extension"), f"{path} imports {mod}"
    with open(path) as f:
        assert "cpp_extension" not in f.read()


def test_import_leaves_jax_out_and_builds_nothing():
    # no compiler may start while the modules are imported (the build
    # directory is shared with tests that build the local search meanwhile)
    code = """
import importlib, os, pkgutil, subprocess, sys
def refuse(*args, **kwargs):
    raise AssertionError(f"a process was started at import: {args}")
subprocess.Popen = refuse
import rl4co_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rl4co_tpu_torch.__path__, "rl4co_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "orbax", "optax", "triton", "rl4co_tpu")]
assert not bad, bad
print("imported", len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[-1]) >= 20


def test_entry_points_refuse_to_run_without_a_card():
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.models import AttentionModelPolicy, rollout
    from rl4co_tpu_torch.models.zoo.am import AttentionModel
    from rl4co_tpu_torch.models.zoo.pomo import POMO
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    small = dict(embed_dim=16, num_heads=2, num_encoder_layers=1, feedforward_hidden=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttentionModelPolicy(**small)
    env = get_env("tsp", num_loc=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.generate(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttentionModel(env, policy_kwargs=small)  # the trainer's algorithm, too
    cvrp = get_env("cvrp", num_loc=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cvrp.generate(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        POMO(cvrp, policy_kwargs=small)
    policy = AttentionModelPolicy(device="cpu", **small)
    inst = {"locs": np.random.RandomState(0).rand(2, 5, 2).astype(np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout(policy, env, inst, DecodeSpec(kind="greedy"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_policy(env, policy, inst)
    assert evaluate_policy(env, policy, inst, device="cpu")["rewards"].shape == (2,)


def test_no_silent_move_to_the_cpu_in_the_source():
    for path in port_files():
        with open(path) as f:
            text = f.read()
        for line in text.splitlines():
            if "is_available()" in line:
                assert "cpu" not in line.split("#")[0].replace("device='cpu'", ""), (path, line)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
