"""Solution rendering (counterpart of `rl4co_tpu/envs/render.py`): one
matplotlib dispatcher keyed on ``env.name`` for every registered env, on the
Agg back end where no interactive one is set. Inputs are one instance (its
fields without the batch axis, numpy or tensors) and its actions ``[T]``;
rendering is host-side tooling and never touches the rollout.

Usage::

    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.envs.render import render

    env = get_env("cvrp", num_loc=20)
    batch = env.generate(1, torch.Generator(), device="cpu")
    instance = {k: v[0] for k, v in batch.items()}
    ax = render(env, instance, actions)      # actions: [T] ints
    ax.figure.savefig("tour.png")
"""

from __future__ import annotations

import numpy as np
import torch


def _get_ax(ax=None):
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "module://matplotlib_inline.backend_inline"):
        try:  # headless-safe default
            matplotlib.use("Agg")
        except Exception:
            pass
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    return ax


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _routes_from_actions(actions: np.ndarray, depot_ids) -> list:
    """Split a flat action sequence into ``(depot, route)`` pairs at depot
    visits. Each route is anchored at the depot that opened it (multi-depot
    envs like mdcpdp hand over between depots mid-sequence)."""
    depot_list = [int(d) for d in np.atleast_1d(depot_ids)]
    depot_set = set(depot_list)
    routes, cur = [], []
    depot = depot_list[0]
    for a in actions.tolist():
        if a in depot_set:
            if cur:
                routes.append((depot, cur))
            cur = []
            depot = a
        else:
            cur.append(a)
    if cur:
        routes.append((depot, cur))
    return routes


def render_tour(locs, actions, ax=None, title=None):
    """Closed tour through ``locs[actions]`` (reference `tsp/render.py`)."""
    ax = _get_ax(ax)
    locs, actions = _np(locs), _np(actions).astype(int)
    tour = locs[np.concatenate([actions, actions[:1]])]
    ax.plot(tour[:, 0], tour[:, 1], "-", color="tab:gray", lw=1)
    ax.scatter(locs[:, 0], locs[:, 1], s=20, color="tab:blue", zorder=3)
    ax.scatter(*locs[actions[0]], s=60, color="tab:green", marker="s", zorder=4)
    if title:
        ax.set_title(title)
    return ax


def render_routes(locs, actions, depot_ids=(0,), ax=None, title=None,
                  node_sizes=None):
    """Multi-route plot: one color per depot-delimited route (reference
    `cvrp/render.py`, `mtsp/render.py`)."""
    import matplotlib.pyplot as plt

    ax = _get_ax(ax)
    locs, actions = _np(locs), _np(actions).astype(int)
    routes = _routes_from_actions(actions, depot_ids)
    cmap = plt.get_cmap("tab10")
    for ri, (d, route) in enumerate(routes):
        if not route:
            continue
        path = locs[[d] + route + [d]]
        ax.plot(path[:, 0], path[:, 1], "-", color=cmap(ri % 10), lw=1,
                label=f"route {ri}" if ri < 10 else None)
    s = 20 if node_sizes is None else 10 + 90 * _np(node_sizes)
    ax.scatter(locs[:, 0], locs[:, 1], s=s, color="tab:blue", zorder=3)
    for d in np.atleast_1d(depot_ids):
        ax.scatter(*locs[int(d)], s=90, color="tab:red", marker="*", zorder=4)
    if title:
        ax.set_title(title)
    return ax


def render_gantt(start_times, durations, machine_of, labels=None, ax=None,
                 title=None):
    """Gantt chart (reference `fjsp/render.py`, `ffsp/render.py`)."""
    import matplotlib.pyplot as plt

    ax = _get_ax(ax)
    start_times, durations, machine_of = map(_np, (start_times, durations, machine_of))
    cmap = plt.get_cmap("tab20")
    for i, (s, dur, m) in enumerate(zip(start_times, durations, machine_of)):
        if dur <= 0 or s < 0 or m < 0:
            continue
        lab = labels[i] if labels is not None else i
        ax.barh(int(m), float(dur), left=float(s), height=0.8,
                color=cmap(int(lab) % 20), edgecolor="black", lw=0.3)
        ax.text(float(s) + float(dur) / 2, int(m), str(lab), ha="center",
                va="center", fontsize=6)
    ax.set_xlabel("time")
    ax.set_ylabel("machine")
    if title:
        ax.set_title(title)
    return ax


def _replay(env, instance, actions):
    """The env's state after ``actions``, on the CPU, as a batch of one."""
    state = env.reset({k: torch.as_tensor(_np(v))[None] for k, v in instance.items()})
    for a in _np(actions).astype(int).tolist():
        state = env.step(state, torch.tensor([a]))
    return state


class _Row:
    """A state of a batch of one seen as the instance's own state: every
    field as a numpy array without the batch axis."""

    def __init__(self, state):
        self._state = state

    def __getattr__(self, name):
        return _np(getattr(self._state, name))[0]


def render(env, instance, actions=None, state=None, ax=None):
    """Dispatch on ``env.name``; returns the matplotlib Axes. ``state`` (for
    the envs drawn from a state) is the port's state of a batch of one, as
    ``env.reset`` and ``env.step`` give it; without it the actions are
    replayed."""
    name = getattr(env, "name", "")
    acts = None if actions is None else _np(actions).astype(int)
    inst = {k: _np(v) for k, v in instance.items()}

    if name in ("tsp", "tsp_dense", "shpp", "tsp_kopt"):
        return render_tour(inst["locs"], acts, ax=ax, title=name)

    if name == "atsp":
        # no coordinates: lay the visit order out on a circle
        n = len(acts)
        theta = 2 * np.pi * np.arange(n) / n
        locs = np.stack([np.cos(theta), np.sin(theta)], -1)
        return render_tour(locs, np.argsort(acts), ax=ax, title="atsp (visit order)")

    if name in ("cvrp", "cvrptw", "cvrpmvc", "sdvrp", "svrp", "op", "pctsp",
                "spctsp", "pdp", "mtvrp"):
        locs = np.concatenate([inst["depot"][None, :], inst["locs"]], 0) \
            if "depot" in inst else inst["locs"]
        sizes = None
        for key in ("demand", "prize", "deterministic_prize"):
            if key in inst:
                v = inst[key]
                sizes = np.concatenate([[0.0], v / (np.max(v) + 1e-9)])
                break
        return render_routes(locs, acts, depot_ids=(0,), ax=ax, title=name,
                             node_sizes=sizes)

    if name in ("mtsp", "mpdp"):
        return render_routes(inst["locs"], acts, depot_ids=(0,), ax=ax, title=name)

    if name == "mdcpdp":
        n_depot = inst["depots"].shape[0]
        locs = np.concatenate([inst["depots"], inst["locs"]], 0)
        return render_routes(locs, acts, depot_ids=tuple(range(n_depot)),
                             ax=ax, title=name)

    if name == "flp":
        ax = _get_ax(ax)
        locs = inst["locs"]
        chosen = acts if acts is not None else []
        ax.scatter(locs[:, 0], locs[:, 1], s=15, color="tab:blue")
        ax.scatter(locs[chosen, 0], locs[chosen, 1], s=120, color="tab:red",
                   marker="*", zorder=4, label="facility")
        # assignment lines client -> nearest chosen facility
        if len(chosen):
            d = np.linalg.norm(locs[:, None] - locs[None, chosen], axis=-1)
            near = np.asarray(chosen)[d.argmin(-1)]
            for i, j in enumerate(near):
                ax.plot([locs[i, 0], locs[j, 0]], [locs[i, 1], locs[j, 1]],
                        "-", color="tab:gray", lw=0.4, zorder=1)
        ax.set_title("flp")
        return ax

    if name == "mcp":
        ax = _get_ax(ax)
        membership, weights = inst["membership"], inst["weights"]
        covered = np.zeros(len(weights) + 1, bool)
        for s in (acts if acts is not None else []):
            covered[membership[int(s)].astype(int)] = True
        item_w = np.concatenate([[0.0], weights])
        ax.bar(np.arange(len(item_w)), item_w,
               color=np.where(covered, "tab:green", "tab:gray"))
        ax.set_xlabel("item")
        ax.set_ylabel("weight")
        ax.set_title(f"mcp covered weight = {item_w[covered].sum():.2f}")
        return ax

    if name in ("dpp", "mdpp"):
        ax = _get_ax(ax)
        st = _Row(state if state is not None else _replay(env, instance, actions))
        locs = _np(st.locs)
        keepout, placed = _np(st.keepout), _np(st.placed)
        ax.scatter(locs[:, 0], locs[:, 1], s=8, color="lightgray")
        ax.scatter(locs[keepout, 0], locs[keepout, 1], s=20, color="black",
                   marker="x", label="keepout")
        probe = _np(st.probe)
        pidx = np.nonzero(probe)[0] if probe.ndim else [int(probe)]   # MDPP's mask, DPP's index
        ax.scatter(locs[pidx, 0], locs[pidx, 1], s=120, color="tab:red",
                   marker="*", label="probe")
        ax.scatter(locs[placed, 0], locs[placed, 1], s=40, color="tab:green",
                   marker="s", label="decap")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(name)
        return ax

    if name == "smtwtp":
        st = _Row(state if state is not None else _replay(env, instance, actions))
        proc = _np(st.job_process_time)[acts]
        starts = np.concatenate([[0.0], np.cumsum(proc)[:-1]])
        return render_gantt(starts, proc, np.zeros(len(acts), int),
                            labels=acts, ax=ax, title="smtwtp")

    if name == "ffsp":
        st = _Row(state if state is not None else _replay(env, instance, actions))
        sched = _np(st.schedule)  # [M_total, J+1] start times; col J = wait job
        m_ids, j_ids = np.nonzero(sched > -1)
        run = _np(instance["run_time"]) if "run_time" in instance else None
        num_job = run.shape[0] if run is not None else sched.shape[1] - 1
        keep = j_ids < num_job  # drop the dummy wait-job column
        m_ids, j_ids = m_ids[keep], j_ids[keep]
        starts = sched[m_ids, j_ids]
        # run_time layout is [J, M_total] (ffsp.py::generate)
        durs = run[j_ids, m_ids] if run is not None else np.ones_like(starts)
        return render_gantt(starts, durs, m_ids, labels=j_ids, ax=ax, title="ffsp")

    if name in ("fjsp", "jssp"):
        st = _Row(state if state is not None else _replay(env, instance, actions))
        starts, finish = _np(st.start_times), _np(st.finish_times)
        ma, sched = _np(st.ma_of_op), _np(st.op_scheduled)
        jobs = _np(st.ops_job_map)
        keep = sched & ~_np(st.pad_mask)
        return render_gantt(starts[keep], (finish - starts)[keep], ma[keep],
                            labels=jobs[keep], ax=ax, title=name)

    raise NotImplementedError(f"render: no renderer for env '{name}'")
