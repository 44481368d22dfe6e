"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's root,
and under `portbench/` a file or module per configuration, cell, traffic kind,
model family and per-layer metric. A later change adds a cell, a
configuration or a metric by adding files and entries, and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _entry(entries: list, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def workload(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name``: its entry merged with ``portbench/workloads/<name>.json``
    (``kind``, ``params``, ``limits``), which must agree with the entry on
    ``config``, ``traffic``, ``chips`` and ``why``."""
    entry = _entry(bench["workloads"], name, "cells")
    cell = load_json(os.path.join(root, "portbench", "workloads", name + ".json"))
    for key in ("config", "traffic", "chips", "why"):
        if cell.get(key) != entry[key]:
            raise ValueError(f"cell {name}: {key} is {cell.get(key)!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return {**entry, **cell}


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _entry(bench["configs"], name, "configurations")
    return load_json(os.path.join(root, entry["file"]))


def reports(metric: dict, cell: str, end_to_end: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric lists
    no cells and (per-layer) the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def end_to_end_of(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if reports(m, cell, set())]


def per_layer_of(bench: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"] if reports(m, cell, e2e)]


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """``portbench/metrics/<name>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(records) -> float | None``."""
    return _module(os.path.join(root, "portbench", "metrics", name + ".py"),
                   "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def traffic(kind: str):
    """``portbench/traffic/<kind>.py``: ``run(cell) -> Outcome``."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def family(name: str):
    """(``portbench/programs/<name>.py``, ``portbench/reference/<name>.py``)."""
    return (importlib.import_module(f"portbench.programs.{name}"),
            importlib.import_module(f"portbench.reference.{name}"))
