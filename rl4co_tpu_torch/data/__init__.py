from rl4co_tpu_torch.data.transforms import (  # noqa: F401
    augment_instances,
    dihedral_8_transform,
    symmetric_transform,
)
