"""FJSP instance file format read/write (counterpart of
`rl4co_tpu/envs/scheduling/parser.py`: numpy only, the port's own copy; the
standard Brandimarte-style format).

Format per instance file:
    line 1: <num_jobs> <num_machines> [<avg eligible>]
    then one line per job:
        <num_ops> { <num_eligible> { <machine(1-indexed)> <proc_time> } ... }
"""

from __future__ import annotations

import os
from typing import List

import numpy as np


def parse_fjsp_file(path: str) -> dict:
    """Parse one FJSP file into numpy arrays (unbatched instance dict)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split()
    num_jobs, num_mas = int(header[0]), int(float(header[1]))
    ops_per_job: List[List[tuple]] = []
    for job_line in lines[1 : 1 + num_jobs]:
        vals = [int(float(x)) for x in job_line.split()]
        n_ops = vals[0]
        idx = 1
        job_ops = []
        for _ in range(n_ops):
            k = vals[idx]
            idx += 1
            pairs = []
            for _ in range(k):
                ma, t = vals[idx], vals[idx + 1]
                idx += 2
                pairs.append((ma - 1, t))
            job_ops.append(pairs)
        ops_per_job.append(job_ops)

    n_ops_total = sum(len(j) for j in ops_per_job)
    proc = np.zeros((num_mas, n_ops_total), dtype=np.float32)
    start_op, end_op = [], []
    op = 0
    for job_ops in ops_per_job:
        start_op.append(op)
        for pairs in job_ops:
            for ma, t in pairs:
                proc[ma, op] = t
            op += 1
        end_op.append(op - 1)
    return {
        "proc_times": proc,
        "pad_mask": np.zeros((n_ops_total,), dtype=bool),
        "start_op_per_job": np.asarray(start_op, dtype=np.int32),
        "end_op_per_job": np.asarray(end_op, dtype=np.int32),
        "num_jobs": num_jobs,
        "num_mas": num_mas,
    }


def write_fjsp_file(path: str, instance: dict) -> None:
    """Write one (unbatched) instance dict to the standard format
    (reference `fjsp/parser.py` `write`)."""
    proc = np.asarray(instance["proc_times"])
    pad = np.asarray(instance["pad_mask"])
    start = np.asarray(instance["start_op_per_job"])
    end = np.asarray(instance["end_op_per_job"])
    num_mas = proc.shape[0]
    num_jobs = len(start)
    lines = []
    avg_elig = (proc > 0).sum(0)[~pad].mean() if (~pad).any() else 0.0
    lines.append(f"{num_jobs} {num_mas} {avg_elig:.1f}")
    for j in range(num_jobs):
        ops = [o for o in range(start[j], end[j] + 1) if not pad[o]]
        parts = [str(len(ops))]
        for o in ops:
            mas = np.nonzero(proc[:, o])[0]
            parts.append(str(len(mas)))
            for ma in mas:
                parts.append(str(ma + 1))
                parts.append(str(int(proc[ma, o])))
        lines.append(" ".join(parts))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_fjsp_dir(dir_path: str, n_ops_max: int | None = None) -> dict:
    """Load all instance files in a directory into one padded batch."""
    files = sorted(
        os.path.join(dir_path, f)
        for f in os.listdir(dir_path)
        if not f.startswith(".")
    )
    parsed = [parse_fjsp_file(f) for f in files]
    o_max = n_ops_max or max(p["proc_times"].shape[1] for p in parsed)
    m = parsed[0]["proc_times"].shape[0]
    j = parsed[0]["num_jobs"]
    b = len(parsed)
    proc = np.zeros((b, m, o_max), np.float32)
    pad = np.ones((b, o_max), bool)
    start = np.zeros((b, j), np.int32)
    end = np.zeros((b, j), np.int32)
    for i, p in enumerate(parsed):
        o = p["proc_times"].shape[1]
        proc[i, :, :o] = p["proc_times"]
        pad[i, :o] = False
        start[i] = p["start_op_per_job"]
        end[i] = p["end_op_per_job"]
    return {
        "proc_times": proc,
        "pad_mask": pad,
        "start_op_per_job": start,
        "end_op_per_job": end,
    }
