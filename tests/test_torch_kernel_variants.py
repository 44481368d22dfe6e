"""The kernel-variant harness patches the current CUDA source (no nvcc needed).

Every default variant of both pointer kernels applies each of its
substitutions exactly once (`kernel_variants.sub` asserts it); a patched
variant differs from the source and the shipped kernels' names leave it as it
is, so the harness cannot rot silently as the kernel changes.
"""

import pytest

from rl4co_tpu_torch.ops import kernel_variants as kv


@pytest.mark.parametrize("name", kv.DEFAULT_SINGLE + kv.DEFAULT_GROUPED)
def test_default_variant_patches_source(name):
    src = open(kv.SOURCE).read()
    out = kv.patched(name)
    assert (out == src) == (name in kv.BASE)


@pytest.mark.parametrize("name", ["grouped-tileL32-subL16-fullsub", "grouped-minb1-noproj"])
def test_patches_combine(name):
    out = kv.patched(name)
    assert out != open(kv.SOURCE).read()


def test_unknown_patch_raises():
    with pytest.raises(ValueError, match="unknown patch"):
        kv.patched("grouped-nosuchpatch")
