"""The port's bench (python -m super_tpu_torch.bench) on the CPU at 48 x 64:
one JSON line with the root bench's keys (bench.py's last print), the
per-iteration, dense and semantic entries, the perception nets' rates and
the live path with monodepth2's depth, and no error key."""

import json
import sys

import torch_helpers  # noqa: F401  (two threads)

from super_tpu_torch import bench

ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "streams",
             "per_stream_hz")


def test_bench_prints_the_root_keys(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "bench", "--cpu", "--reps", "2", "--height", "48", "--width", "64",
        "--mesh_step_size", "8"])
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    for key in ROOT_KEYS + ("per_iteration_hz", "dense_mesh16_hz",
                            "semantic_hz"):
        assert key in out, key
    for key in ("depth_mono_hz", "depth_raft_hz", "seg_hz", "e2e_depth_hz"):
        assert out[key] > 0, key
    assert not [k for k in out if k.endswith("_error")]
    assert set(out["e2e_depth_overflow"]) == {"tuple", "pair",
                                              "add_deferred", "free"}
    assert out["unit"] == "frames/s/chip" and out["streams"] == 1
    assert out["loop"] == "host" and out["device"] == "cpu"
    for key in ("value", "per_iteration_hz", "dense_mesh16_hz",
                "semantic_hz"):
        assert out[key] > 0
    assert out["per_stream_hz"] == out["value"]
    assert abs(out["vs_baseline"] - out["value"] / 30.0) < 1e-3
    assert set(out["overflow"]) == {"tuple", "pair", "add_deferred", "free"}
    assert set(out["semantic_overflow"]) == set(out["overflow"])
