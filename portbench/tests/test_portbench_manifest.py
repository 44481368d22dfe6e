import json
import os
import re
import shutil

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    bench = manifest.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert [m["name"] for m in manifest.end_to_end_of(bench, w["name"])][0] == "setup_s"
        assert len(manifest.end_to_end_of(bench, w["name"])) >= 2
        assert manifest.per_layer_of(bench, w["name"])


@pytest.mark.parametrize("cell", ["pomo_cvrp50.serve_aug8", "am_tsp100.train"])
def test_cell_found_by_name(cell):
    bench = manifest.benchmark()
    wl = manifest.workload(bench, cell)
    cfg = manifest.config(bench, wl["config"])
    program, reference = manifest.family(cfg["family"])
    assert manifest.traffic(wl["kind"]).run
    assert reference.param_schema(cfg) and program.make_policy
    assert wl["limits"]


def test_metric_readers_match_their_entries():
    bench = manifest.benchmark()
    for m in bench["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert reader.read({}) is None     # nothing to read: no number, not 0


def test_configurations_state_what_is_run():
    bench = manifest.benchmark()
    for c in bench["configs"]:
        cfg = manifest.config(bench, c["name"])
        assert c["file"].startswith("portbench/configs/") and c["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
        assert (cfg["embed_dim"], cfg["num_heads"], cfg["feedforward_hidden"]) == (128, 8, 512)


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return str(root)


def test_a_cell_a_configuration_and_a_metric_added_as_new_files(tmp_path):
    root = _copy(tmp_path)
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, files in os.walk(os.path.join(root, "portbench")) for p in files}
    bench = manifest.benchmark(root)
    cfg = manifest.config(bench, "am_tsp100", root)
    # new files only
    with open(os.path.join(root, "portbench/configs/am_tsp50.json"), "w") as f:
        json.dump({**cfg, "num_loc": 50}, f)
    why = "AM greedy dispatches of 8192 TSP-50 instances"
    with open(os.path.join(root, "portbench/workloads/am_tsp50.serve_greedy.json"), "w") as f:
        json.dump({"config": "am_tsp50", "traffic": "serve_greedy", "chips": 1, "why": why,
                   "kind": "serve_dispatch",
                   "params": {"method": "greedy", "instances_per_dispatch": 8192,
                              "pool_dispatches": 2, "traced_dispatches": 2,
                              "check_instances": 256},
                   "limits": {"logit_gap": 1e-3, "cost_mismatch_share": 0.05}}, f)
    with open(os.path.join(root, "portbench/metrics/kernel.k2_roofline.serve.py"), "w") as f:
        f.write('from portbench.harness import reduce\nLAYER = "x"\nUNIT = "%"\n'
                'MOVES = "solve_rate"\n\n\ndef read(rec):\n'
                '    return reduce.roofline_pct(rec, "pointer_step_single")\n')
    # and entries in BENCHMARK.json
    bench["configs"].append({"name": "am_tsp50", "source": "https://arxiv.org/abs/1803.08475",
                             "file": "portbench/configs/am_tsp50.json", "reduced": [],
                             "why": "smaller"})
    bench["workloads"].append({"name": "am_tsp50.serve_greedy", "config": "am_tsp50",
                               "traffic": "serve_greedy", "chips": 1, "why": why})
    bench["per_layer"].append({"name": "kernel.k2_roofline.serve", "unit": "%",
                               "better": "higher", "source": "device_trace", "layer": "x",
                               "moves": "solve_rate", "workloads": ["am_tsp50.serve_greedy"]})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_rate":
            m["workloads"].append("am_tsp50.serve_greedy")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    bench = manifest.benchmark(root)
    wl = manifest.workload(bench, "am_tsp50.serve_greedy", root)
    assert manifest.config(bench, wl["config"], root)["num_loc"] == 50
    assert [m["name"] for m in manifest.per_layer_of(bench, "am_tsp50.serve_greedy")] == \
        ["kernel.k2_roofline.serve"]
    assert [m["name"] for m in manifest.end_to_end_of(bench, "am_tsp50.serve_greedy")] == \
        ["setup_s", "solve_rate"]
    assert manifest.metric_reader("kernel.k2_roofline.serve", root).read({}) is None
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, files in os.walk(os.path.join(root, "portbench")) for p in files}
    assert all(after[p] == before[p] for p in before)     # no file that was there changed


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    root = _copy(tmp_path)
    path = os.path.join(root, "portbench/workloads/am_tsp100.train.json")
    cell = manifest.load_json(path)
    with open(path, "w") as f:
        json.dump({**cell, "chips": 4}, f)
    with pytest.raises(ValueError, match="chips"):
        manifest.workload(manifest.benchmark(root), "am_tsp100.train", root)
