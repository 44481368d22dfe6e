import pytest

from portbench.harness import reduce
from portbench.harness.trace import Trace, breakdown, idle_gaps, union_us


def test_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert union_us(iv, 0, 50) == 25
    # clipped to the stretch
    assert union_us(iv, 8, 22) == 7 + 2
    # a sum of the kernels would count the overlap twice
    assert sum(e - s for s, e in iv) == 31


def test_idle_gaps_cover_the_rest():
    iv = [(5, 10), (8, 12), (20, 30)]
    gaps = idle_gaps(iv, 0, 40)
    assert gaps == [(0, 5), (12, 20), (30, 40)]
    assert sum(e - s for s, e in gaps) + union_us(iv, 0, 40) == 40


def _trace():
    device = [("k1 pointer_step_grouped_mma_kernel<8, 4>", 10, 30),
              ("elementwise", 25, 40),
              ("k1 pointer_step_grouped_mma_kernel<8, 4>", 60, 80),
              ("gemm", 90, 100)]
    host = [("aten::copy_", 0, 45), ("aten::nonzero", 41, 59), ("cudaStreamSynchronize", 42, 58),
            ("aten::argmax", 80, 92)]
    return Trace(device=device, host=host, window=(0, 100))


def test_idle_share_and_breakdown():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(60e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert reduce.idle_pct({"trace": tr}) == pytest.approx(40.0)
    b = breakdown(tr)
    assert b["device_ops"][0] == ["k1 pointer_step_grouped_mma_kernel<8, 4>", pytest.approx(40e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # each gap is put on the innermost host operator open as it began, the
    # runtime's own calls passed over
    assert gaps == {"aten::copy_": pytest.approx(30e-6), "aten::argmax": pytest.approx(10e-6)}
    assert b["idle_gaps"][0][0] == "aten::copy_"


def test_roofline_launches_and_mfu_readers():
    tr = _trace()
    rec = {"trace": tr, "kernel_shapes": {"pointer_step_grouped": (2048, 50, 51, 128)},
           "decode_steps": 2, "model_flops": 495e12, "model_flops_s": 100.0,
           "memory_peak_bytes": 3 * 2**30}
    least = 254.705664e6 / 3.35e12
    assert reduce.roofline_pct(rec, "pointer_step_grouped") == pytest.approx(
        100 * 2 * least / 40e-6)
    assert reduce.roofline_pct(rec, "pointer_step_single") is None    # nothing to read
    assert reduce.launches_per_step(rec) == 2.0
    assert reduce.mfu_pct(rec) == pytest.approx(1.0)
    assert reduce.peak_gib(rec) == 3.0
    assert reduce.idle_pct({}) is None
