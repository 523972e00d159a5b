"""The port's multi-stream frame loop (super_tpu_torch/parallel/streams.py:
MultiStreamPipeline) against the JAX package's, and the port bench's
``--streams`` in its LM mode and line (the tracked mode at the bench's
own sizes is tests/test_torch_bench_streams.py).

The pipeline runs tests/test_parallel.py:test_multistream_pipeline's two
streams: two time windows of one generated tiny sequence (the generator's
seed varies only the tracked pixels), on the port's main-path config, with
the GT points.  Each stream's mean reprojection error is held to the JAX
run's within tests/test_torch_pipeline.py's band (the larger of 0.3 px and
20%: the tracked state is chaotic at f32 rounding).
"""

import sys

import numpy as np
import pytest

from torch_helpers import port_config, port_intr, slice_config

from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu.parallel.streams import MultiStreamPipeline as JaxPipeline
from super_tpu_torch import bench
from super_tpu_torch.parallel.streams import MultiStreamPipeline
from super_tpu_torch.utils import evaluation

KEYS = {"reproj_mean", "reproj_mean_worst_stream", "p50_batch_ms",
        "aggregate_fps"}


@pytest.fixture(scope="module")
def runs():
    cfg = slice_config(gram_sum_dtype="bf16")
    intr = default_intrinsics(cfg.height, cfg.width)
    seq = generate(8, cfg.height, cfg.width, intr=intr, seed=2)
    win = lambda a: np.stack([a[:4], a[4:]])  # noqa: E731
    data = dict(depths=win(seq.depths), colors=win(seq.colors),
                gt_xy=win(seq.gt_xy), gt_valid=win(seq.gt_valid))
    ref = JaxPipeline(cfg, intr)
    ref_m = ref.run(**data)
    port = MultiStreamPipeline(port_config(cfg), port_intr(intr),
                               device="cpu")
    port_m = port.run(**data)
    return ref, ref_m, port, port_m


def test_summary_keys(runs):
    _, ref_m, _, port_m = runs
    assert set(ref_m) == KEYS
    assert set(port_m) == KEYS
    assert port_m["aggregate_fps"] > 0 and port_m["p50_batch_ms"] > 0


def test_tracks_both_streams(runs):
    """tests/test_parallel.py:test_multistream_pipeline's checks on the
    port: finite, below 4 px, and the two streams' maps different."""
    _, _, port, port_m = runs
    assert np.isfinite(port_m["reproj_mean"])
    assert port_m["reproj_mean"] < 4.0, port_m
    pts = port.states.surfels.points.numpy()
    assert not np.allclose(pts[0], pts[1])


@pytest.mark.parametrize("stream", [0, 1])
def test_stream_error_within_the_jax_runs_band(runs, stream):
    ref, _, port, _ = runs
    want = evaluation.summarize(ref.errors[stream])["reproj_mean"]
    got = evaluation.summarize(port.errors[stream])["reproj_mean"]
    assert abs(got - want) <= max(0.3, 0.2 * want), (stream, got, want)


def test_summary_is_over_the_streams(runs):
    _, _, port, port_m = runs
    means = [evaluation.summarize(e)["reproj_mean"] for e in port.errors]
    assert port_m["reproj_mean"] == pytest.approx(np.mean(means), rel=1e-12)
    assert port_m["reproj_mean_worst_stream"] == max(means)
    assert port_m["aggregate_fps"] == pytest.approx(
        2e3 / port_m["p50_batch_ms"], rel=1e-12)
    assert len(port.frame_times) == 4


def test_bench_lm_mode_counts_every_stream():
    """``measure_lm`` with two streams solves each rep twice: the rate is
    all streams' solves a second (the tiny main-path config)."""
    cfg = port_config(slice_config(gram_sum_dtype="bf16"))
    hz = bench.measure_lm(cfg, 1, "cpu", streams=2)
    line = bench._line(bench.LM_METRIC, hz, 2)
    assert line["streams"] == 2 and line["value"] > 0
    assert abs(line["value"] - 2 * line["per_stream_hz"]) <= 1.5e-3


def test_bench_line_with_one_stream_is_unchanged():
    """``--streams 1`` prints the single-stream line as before."""
    hz = 17.4019
    assert bench._line(bench.METRIC, hz) == dict(
        metric=bench.METRIC, value=round(hz, 3), unit="frames/s/chip",
        vs_baseline=round(hz / 30.0, 4), streams=1,
        per_stream_hz=round(hz, 3), loop="host")
    assert bench._line(bench.METRIC, hz, 1) == bench._line(bench.METRIC, hz)


def test_bench_refuses_no_streams(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench", "--cpu", "--streams", "0"])
    with pytest.raises(SystemExit):
        bench.main()
