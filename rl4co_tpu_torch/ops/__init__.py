# the kernels are built at their first launch (`ops/_build.py`), not here
from rl4co_tpu_torch.ops.pointer_kernel import fused_pointer_logits  # noqa: F401
