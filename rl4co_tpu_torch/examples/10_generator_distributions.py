"""Instance-generator distributions for generalisation studies.

The port's counterpart of `examples/10_generator_distributions.py`: the
cluster, mixed, Gaussian-mixture and mix-distribution samplers, drawn on the
device from a `torch.Generator`; envs take a ``loc_distribution`` name. No
model runs here, so no pointer kernel.

Run: python3 rl4co_tpu_torch/examples/10_generator_distributions.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.envs.distributions import get_sampler  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import seeded_generator  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(n=200, device="cuda"):
    device = resolve_device(device)
    stats = {}
    for name, kwargs in [
        ("uniform", {}),
        ("cluster", {"n_cluster": 3}),
        ("mixed", {"n_cluster_mix": 2}),
        ("gaussian_mixture", {"num_modes": 5, "cdist": 50.0}),
        ("mix_distribution", {}),
    ]:
        sampler = get_sampler(name, **kwargs)
        pts = sampler.sample((n, 2), seeded_generator(device, 0), device).cpu().numpy()
        stats[name] = {"mean": pts.mean(0).tolist(), "std": pts.std(0).tolist(),
                       "min": float(pts.min()), "max": float(pts.max())}
        print(f"{name:<18} mean={pts.mean(0).round(3)} "
              f"std={pts.std(0).round(3)} range=[{pts.min():.3f},{pts.max():.3f}]")

    # envs take the distribution by name: train / evaluate on shifted data
    env = get_env("tsp", num_loc=20, loc_distribution="cluster")
    batch = env.generate(4, seeded_generator(device, 1), device)
    print("cluster-TSP batch locs shape:", tuple(batch["locs"].shape))

    # a constant scalar gives fixed values; callables pass through
    const = get_sampler(0.5).sample((4,), seeded_generator(device, 0), device)
    print("constant sampler:", const.unique().cpu().numpy())
    stats["cluster_tsp_shape"] = list(batch["locs"].shape)
    stats["constant"] = const.unique().cpu().tolist()
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
