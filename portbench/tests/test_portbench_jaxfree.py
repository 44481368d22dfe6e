import subprocess
import sys

from portbench.harness import core, manifest


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("jax.numpy", "flax", "rl4co_tpu.envs.routing", "jaxlib.xla_client"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("rl4co_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert core.forbidden_modules() == ["flax", "jax", "jaxlib", "rl4co_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {manifest.ROOT!r})\n"
        "from portbench.harness.core import run_cell, forbidden_modules\n"
        "cfg = dict(embed_dim=16, num_heads=2, feedforward_hidden=32, num_loc=6, num_encoder_layers=1)\n"
        "run_cell('pomo_cvrp50.serve_aug8', 3, 0.2, False, torch.device('cpu'), time.perf_counter(),\n"
        "         cfg_overrides=cfg, param_overrides=dict(instances_per_dispatch=2,\n"
        "         pool_dispatches=2, check_instances=2))\n"
        "run_cell('am_tsp100.train', 3, 0.2, False, torch.device('cpu'), time.perf_counter(),\n"
        "         cfg_overrides=cfg, param_overrides=dict(batch=4, pool_batches=4))\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_prints_no_result():
    out = subprocess.run([sys.executable, f"{manifest.PKG}/run.py", "--workload",
                          "am_tsp100.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(manifest.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{manifest.ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "am_tsp100.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
