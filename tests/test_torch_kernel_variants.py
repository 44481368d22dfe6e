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


@pytest.mark.parametrize("name", ["grouped-tileN32-mt4", "grouped-mt2-noproj",
                                  "grouped-copyonly-tileN16", "grouped-tf32x1-mt2",
                                  "grouped-cudacore-regs96", "grouped-fastexp-mt1"])
def test_patches_combine(name):
    out = kv.patched(name)
    assert out != open(kv.SOURCE).read()


def test_tf32x1_keeps_one_pass():
    """tf32x1 leaves the a_hi . b_hi product alone: one mma per product."""
    src, out = open(kv.SOURCE).read(), kv.patched("grouped-tf32x1")
    assert src.count("mma_tf32(d, a_") == 3 and out.count("mma_tf32(d, a_") == 1
    assert "mma_tf32(d, a_hi, b_hi);" in out


def test_parse_args_takes_several_baselines():
    assert kv.parse_args(["--baseline", "a.cu", "grouped", "--baseline", "b.cu", "g4t128n32"]) == (
        {"baseline": "a.cu", "baseline2": "b.cu"}, ["grouped", "g4t128n32"])


def test_grouped_shapes_cover_chip_smoke():
    """The harness times K1 at every grouped shape the smoke script times."""
    import chip_smoke

    shapes = set(kv.SHAPES["grouped"])
    want = {s for name, s in [*chip_smoke.MAIN_SHAPES.items(), *chip_smoke.EXTRA_TIMES]
            if name == "pointer_step_grouped"}
    assert want <= shapes
    assert all(len(s) == 5 and s[1] is None for s in kv.SHAPES["single"])


def test_unknown_patch_raises():
    with pytest.raises(ValueError, match="unknown patch"):
        kv.patched("grouped-nosuchpatch")
    with pytest.raises(ValueError, match="multiple of 8"):
        kv.patched("grouped-tileN12")
