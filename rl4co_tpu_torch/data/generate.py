"""Dataset generation (counterpart of `rl4co_tpu/data/generate.py`).

Seeded npz validation and test sets with the reference's seed conventions
(validation 4321, test 1234, 10 000 instances):

    python -m rl4co_tpu_torch.data.generate --problem tsp --num-loc 50 \\
        --data-dir data/ --dataset-size 10000 [--device cpu]

``--convention reference`` rebuilds the reference's canonical files (the
committed ``data/tsp/*.npz`` and ``data/cvrp/*.npz``) byte for byte from
numpy's stream; the default draws through the port's envs from a
`torch.Generator` seeded with ``--seed``, on ``--device``, for every env of
the registry (ATSP's cost matrices, FFSP's run times, FJSP's and JSSP's
operations among them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rl4co_tpu_torch.data.io import save_instances_npz, to_numpy

DEFAULT_SEEDS = {"val": 4321, "test": 1234}
DEFAULT_PROBLEMS = ("tsp", "cvrp", "op", "pctsp", "pdp", "atsp", "mdpp")

# Kool et al. 2019's capacity schedule, as the reference hardcodes it
_VRP_CAPACITIES = {
    10: 20.0, 15: 25.0, 20: 30.0, 30: 33.0, 40: 37.0, 50: 40.0, 60: 43.0,
    75: 45.0, 100: 50.0, 125: 55.0, 150: 60.0, 200: 70.0, 500: 100.0,
    1000: 150.0,
}
# envs whose generator takes no ``num_loc``
_NO_NUM_LOC = ("mcp", "ffsp", "fjsp", "jssp", "dpp", "mdpp")


def generate_reference_convention(
    problem: str, num_loc: int, dataset_size: int, seed: int
) -> dict:
    """The reference's canonical dataset, bit for bit: numpy's global stream
    seeded with ``seed`` (here a `RandomState`, the same MT19937 stream),
    drawn in the reference generator's order. Returns the reference's raw
    format (integer demands and a capacity for CVRP); `data.io.
    load_reference_npz` reads it into the port's conventions."""
    rng = np.random.RandomState(seed)
    if problem == "tsp":
        return {"locs": rng.uniform(size=(dataset_size, num_loc, 2)).astype(np.float32)}
    if problem in ("cvrp", "vrp", "sdvrp"):
        # draw order: depot, locs, demand
        return {
            "depot": rng.uniform(size=(dataset_size, 2)).astype(np.float32),
            "locs": rng.uniform(size=(dataset_size, num_loc, 2)).astype(np.float32),
            "demand": rng.randint(1, 10, size=(dataset_size, num_loc)).astype(np.float32),
            "capacity": np.full(dataset_size, _VRP_CAPACITIES[num_loc]).astype(np.float32),
        }
    if problem == "atsp":
        raise NotImplementedError("atsp reference stream not mirrored")
    raise NotImplementedError(f"reference convention for {problem!r} not mirrored")


def generate_dataset(
    problem: str, num_loc: int, dataset_size: int, seed: int, device="cuda", **env_kwargs
) -> dict:
    """``dataset_size`` instances of the port's env ``problem``, drawn on
    ``device`` from a generator seeded with ``seed``, as numpy arrays."""
    import torch

    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.rl.reinforce import seeded_generator
    from rl4co_tpu_torch.utils.device import resolve_device

    kwargs = dict(env_kwargs)
    if problem not in _NO_NUM_LOC:
        kwargs["num_loc"] = num_loc
    env = get_env(problem, **kwargs)
    device = resolve_device(device)
    with torch.no_grad():
        instances = env.generate(dataset_size, seeded_generator(device, seed), device=device)
    return {k: to_numpy(v) for k, v in instances.items()}


def generate_default_datasets(
    data_dir: str,
    problems=DEFAULT_PROBLEMS,
    sizes=(20, 50, 100),
    dataset_size: int = 10_000,
    device="cuda",
) -> list:
    """Every problem × size × phase that ``data_dir`` lacks; returns the
    paths written."""
    written = []
    for problem in problems:
        for n in sizes:
            for phase, seed in DEFAULT_SEEDS.items():
                path = os.path.join(data_dir, problem, f"{phase}{n}_seed{seed}.npz")
                if os.path.exists(path):
                    continue
                data = generate_dataset(problem, n, dataset_size, seed, device=device)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_instances_npz(data, path)
                written.append(path)
    return written


def main(argv=None):
    from rl4co_tpu_torch.envs import ENV_REGISTRY

    p = argparse.ArgumentParser(description="rl4co-tpu (PyTorch port) dataset generation")
    p.add_argument("--problem", default="tsp", choices=sorted(ENV_REGISTRY))
    p.add_argument("--num-loc", type=int, default=50)
    p.add_argument("--dataset-size", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--name", default=None)
    p.add_argument("--convention", default="native", choices=["native", "reference"],
                   help="'reference' rebuilds the reference repo's numpy streams bit for "
                        "bit (canonical test/val sets)")
    p.add_argument("--device", default="cuda", help="where the port's envs draw (native)")
    args = p.parse_args(argv)
    if args.convention == "reference":
        data = generate_reference_convention(
            args.problem, args.num_loc, args.dataset_size, args.seed)
    else:
        data = generate_dataset(args.problem, args.num_loc, args.dataset_size, args.seed,
                                device=args.device)
    name = args.name or f"{args.problem}{args.num_loc}_seed{args.seed}.npz"
    path = os.path.join(args.data_dir, args.problem, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_instances_npz(data, path)
    print(f"Wrote {path}")


if __name__ == "__main__":
    main()
