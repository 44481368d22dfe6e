"""rl4co_tpu_torch: the PyTorch/CUDA port of `rl4co_tpu`.

Same sub-packages and module names as the JAX package, so a module's
counterpart is found by path. Plain tensor code is PyTorch; the per-token
pointer decode step is a hand-written CUDA C++ kernel
(`csrc/pointer_kernel.cu`, built at first use by `ops/_build.py`).

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when there is no card; pass ``device="cpu"`` to run on the CPU.
"""

__version__ = "0.1.0"

from rl4co_tpu_torch.envs import ENV_REGISTRY, get_env  # noqa: F401
