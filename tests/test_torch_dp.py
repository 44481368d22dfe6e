"""Data parallelism in the port (`rl4co_tpu_torch/parallel/mesh.py`) on the CPU:
two gloo processes against one process at the same global batch, as the JAX
package's `tests/test_distributed.py` holds its two-process run to its
one-process run.

- REINFORCE on AM (embed 16, one layer, TSP-8, global batch 16, two steps
  with the epoch end between them), with batch norm and instance norm, each
  under the rollout baseline behind its warm-up and under the mean baseline:
  both ranks hold the same parameters to the bit; the metrics of every step
  equal the one-process run's within rtol 1e-5, atol 1e-5 (the global means
  are sums of two halves; the loss is a mean of terms of about 10 that
  cancel), the parameters within `PARAM_ATOL` and 98 % of their elements
  within 1e-6 (Adam's steps on gradients that vanish but for rounding).
- The all-reduced batch norm against the JAX package's `Normalization` over
  the global batch: output, input gradient and the affine parameters'
  gradients (summed over the ranks) within 1e-5.
- The train command line with ``--dp 2 --device cpu`` (rank 0 in this
  process, rank 1 started by it): its checkpoint holds the one-process
  command line's parameters within `PARAM_ATOL`, and its logs are rank 0's
  alone.
"""

import json
import os
import socket
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import _torch_dp_child as child  # noqa: E402
from rl4co_tpu.models.nn.ops import Normalization as JaxNormalization  # noqa: E402

torch.set_num_threads(1)

# Biases that a mean-subtracting norm follows (the attention's and the FFN's
# output biases, the keys' bias) have gradients that vanish but for rounding:
# Adam turns that noise into steps of +-lr (1e-4) whose signs depend on the
# last bits, in both frameworks (the JAX package's `test_sharding.py` holds
# its parameters at 1e-3 for it). Two steps move such a parameter by at most
# 2e-4 each way; every other parameter stays within 1e-6.
PARAM_ATOL = 4e-4
CLOSE_SHARE = 0.98   # of the parameters' elements within 1e-6 (98.5 % measured)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' outputs (one spawn for the whole module)."""
    out = tmp_path_factory.mktemp("dp")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, child.__file__, str(r), "2", str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a data-parallel rank timed out")
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("norm,baseline", child.CONFIGS)
def test_two_ranks_train_as_one_process(ranks, norm, baseline):
    prefix = f"{norm}-{baseline}/"
    want = child.train_config(norm, baseline)
    got0 = {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}
    got1 = {k[len(prefix):]: v for k, v in ranks[1].items() if k.startswith(prefix)}
    assert set(got0) == set(want) == set(got1)
    close = []
    for k in want:
        np.testing.assert_array_equal(got0[k], got1[k], err_msg=k)   # replicated bitwise
        if k.startswith("param/"):
            np.testing.assert_allclose(got0[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
            close.append((np.abs(got0[k] - want[k]) <= 1e-6).ravel())
        else:
            np.testing.assert_allclose(got0[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.concatenate(close).mean() >= CLOSE_SHARE


def test_global_batch_norm_is_jax_batch_norm_over_the_global_batch(ranks):
    x, ct, scale, bias = child.norm_inputs()
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    norm = JaxNormalization("batch")

    def loss(p, x):
        return (norm.apply(p, x) * ct).sum()

    y = norm.apply(params, jnp.asarray(x))
    dp, dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(np.concatenate([r["norm/y"] for r in ranks]), np.asarray(y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["norm/dx"] for r in ranks]), np.asarray(dx),
                               atol=1e-5, rtol=1e-5)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(sum(r[f"norm/d{name}"] for r in ranks),
                                   np.asarray(dp["params"][name]), atol=1e-5, rtol=1e-5)


def test_dp_command_line_trains_the_one_process_run(tmp_path):
    from rl4co_tpu_torch.checkpoint import restore_checkpoint
    from rl4co_tpu_torch.train import main

    common = ["--model", "am", "--num-loc", "8", "--batch-size", "8", "--train-size", "16",
              "--val-size", "8", "--epochs", "1", "--device", "cpu", "--precision", "f32",
              "--baseline", "mean"]
    main([*common, "--dp", "2", "--ckpt-dir", str(tmp_path / "dp"),
          "--log-file", str(tmp_path / "dp.jsonl")])
    main([*common, "--ckpt-dir", str(tmp_path / "one")])
    got = restore_checkpoint(str(tmp_path / "dp" / "last.pt"), "cpu")["state"]["policy"]
    want = restore_checkpoint(str(tmp_path / "one" / "last.pt"), "cpu")["state"]["policy"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    records = [json.loads(line) for line in (tmp_path / "dp.jsonl").read_text().splitlines()]
    assert sum("val/reward" in r for r in records) == 1   # one epoch, logged once
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,local_world,cards,backend,card", [
    ("cuda", 2, 2, "nccl", 1), ("cuda", 2, 1, "gloo", 0),
    ("cuda:1", 2, 2, "gloo", 1), ("cuda:1", 1, 2, "nccl", 1)],
    ids=["card-each", "cards-shared", "named-card-shared", "named-card-alone"])
def test_init_distributed_picks_gloo_where_ranks_share_a_card(device, local_world, cards,
                                                              backend, card, monkeypatch):
    """NCCL refuses two ranks on one device: the last of ``local_world`` local
    ranks gets gloo when they outnumber the cards or all take the card that
    ``device`` names. The process group and the cards are stubbed."""
    from rl4co_tpu_torch.parallel import mesh as tmesh

    seen = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.setdefault("device", d))
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: seen.setdefault("backend", backend))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    last = local_world - 1
    _, dev = tmesh.init_distributed(device, rank=last, world=local_world, local_rank=last,
                                    addr="localhost", port=1)
    assert seen == {"backend": backend, "device": dev} and dev == torch.device("cuda", card)
