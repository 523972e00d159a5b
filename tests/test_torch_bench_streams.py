"""The port bench's ``--streams`` on the tracked step (python -m
super_tpu_torch.bench --streams B) on the CPU at 48 x 64: B copies of the
headline stream through parallel/sharded.py:make_batched_step, ``value``
all streams' frames a second, ``per_stream_hz`` a stream's.  One rep: the
bench's headline config at this size runs a CPU step in seconds (its
capacities are the 480 x 640 headline's), and tests/test_torch_bench.py
already runs the single stream."""

import torch_helpers  # noqa: F401  (two threads)

from super_tpu_torch import bench


def test_measure_with_two_streams():
    out = bench.measure(reps=1, device="cpu", height=48, width=64,
                        mesh_step=8, association="per_frame", streams=2)
    assert out["streams"] == 2
    assert out["value"] > 0 and out["cold_start_hz"] > 0
    assert abs(out["value"] - 2 * out["per_stream_hz"]) <= 1.5e-3
    assert abs(out["vs_baseline"] - out["per_stream_hz"] / 30.0) < 1e-4
    assert set(out["overflow"]) == {"tuple", "pair", "add_deferred", "free"}
    assert out["cold_add_deferred"] >= 0
    assert "per_iteration_hz" not in out
