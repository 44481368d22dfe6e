import pytest

from portbench.harness import counts, manifest


def test_k1_at_pomo_dispatch_shape():
    # (2048, 50, 51) at D 128: 256 instances x 8 symmetries, 50 starts, depot + 50 customers
    nbytes = counts.pointer_step_bytes(2048, 50, 51, 128)
    assert nbytes == 4 * (3 * 2048 * 51 * 128 + 2048 * 50 * 128 + 2 * 2048 * 50 * 51 + 128 * 128)
    assert nbytes == pytest.approx(254.7e6, rel=1e-3)
    ops = counts.pointer_step_ops(2048, 50, 51, 128)
    assert ops == 2048 * 50 * (6 * 51 * 128 + 2 * 128 * 128)
    # bound by bytes: 0.076 ms
    assert counts.pointer_step_least_s(2048, 50, 51, 128) == pytest.approx(nbytes / 3.35e12)
    assert counts.pointer_step_least_s(2048, 50, 51, 128) == pytest.approx(76.0e-6, rel=2e-3)


def test_k2_at_am_batch_shape():
    nbytes = counts.pointer_step_bytes(4096, 1, 100, 128)
    assert nbytes == 4 * (3 * 4096 * 100 * 128 + 4096 * 128 + 2 * 4096 * 100 + 128 * 128)
    assert counts.pointer_step_least_s(4096, 1, 100, 128) == pytest.approx(nbytes / 3.35e12)


def test_operations_bind_at_wide_queries():
    # one pass at the TF32 rate binds only where W_out's 2·D² per query row
    # outweighs the bytes: far from the cells' shapes, which bytes bind
    b, l, n, d = 1, 1000, 10, 2048
    assert counts.pointer_step_least_s(b, l, n, d) == pytest.approx(
        counts.pointer_step_ops(b, l, n, d) / 495e12)


def test_forward_flops_of_both_configurations():
    bench = manifest.benchmark()
    pomo = manifest.config(bench, "pomo_cvrp50")
    am = manifest.config(bench, "am_tsp100")
    # a POMO dispatch: 2048 copies x 50 starts, about 1.35 TFLOP, 80 % in the decoder
    total = counts.am_forward_flops(pomo, 2048, 50)
    assert total == pytest.approx(1.35e12, rel=0.02)
    decoder = 100 * 2048 * 50 * (2 * 129 * 128 + 6 * 51 * 128 + 2 * 128 * 128)
    assert decoder / total == pytest.approx(0.80, abs=0.02)
    # an AM update: the sampled rollout x3 and the baseline's x1, about 2.64 TFLOP
    assert 4 * counts.am_forward_flops(am, 4096) == pytest.approx(2.64e12, rel=0.02)


def test_encoder_flops_by_hand():
    cfg = dict(embed_dim=4, feedforward_hidden=8, num_encoder_layers=1, env="tsp", num_loc=3,
               use_graph_context=False)
    b, n, d, f = 2, 3, 4, 8
    init = 2 * b * n * 2 * d
    layer = 2 * b * n * d * 3 * d + 4 * b * n * n * d + 2 * b * n * d * d + 4 * b * n * d * f
    pre = 2 * b * n * d * 3 * d
    decode = 3 * b * (2 * 2 * d * d + 6 * n * d + 2 * d * d)
    assert counts.am_forward_flops(cfg, b) == init + layer + pre + decode
