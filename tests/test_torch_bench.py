"""The port's bench (python -m super_tpu_torch.bench) on the CPU at 48 x 64:
one JSON line with the root bench's keys (bench.py's last print), the
per-iteration, dense and semantic entries, the perception nets' rates and
the live path with monodepth2's depth, the cold start, and no error key;
``--mode lm``, ``--association`` and ``--sol``, which writes no file;
the default loop, replays of the captured step (``"loop": "device"``;
on the CPU run eagerly on its buffers), and ``--host_loop``; and
track_step leaving its input state as it was, which the cold start
relies on."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (two threads)

from super_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--reps", "2", "--height", "48", "--width", "64",
        "--mesh_step_size", "8"]

ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "streams",
             "per_stream_hz")


def test_bench_prints_the_root_keys(capsys, monkeypatch):
    out = _run(capsys, monkeypatch)
    for key in ROOT_KEYS + ("per_iteration_hz", "dense_mesh16_hz",
                            "semantic_hz", "cold_start_hz",
                            "cold_add_deferred"):
        assert key in out, key
    assert out["cold_start_hz"] > 0 and out["cold_add_deferred"] >= 0
    for key in ("depth_mono_hz", "depth_raft_hz", "seg_hz", "e2e_depth_hz"):
        assert out[key] > 0, key
    assert not [k for k in out if k.endswith("_error")]
    assert set(out["e2e_depth_overflow"]) == {"tuple", "pair",
                                              "add_deferred", "free"}
    assert out["unit"] == "frames/s/chip" and out["streams"] == 1
    assert out["loop"] == "device" and out["device"] == "cpu"
    assert out["loops"] == {"value": "device", "per_iteration_hz": "device",
                            "dense_mesh16_hz": "device",
                            "semantic_hz": "device", "e2e_depth_hz": "device"}
    for key in ("value", "per_iteration_hz", "dense_mesh16_hz",
                "semantic_hz"):
        assert out[key] > 0
    assert out["per_stream_hz"] == out["value"]
    assert abs(out["vs_baseline"] - out["value"] / 30.0) < 1e-3
    assert set(out["overflow"]) == {"tuple", "pair", "add_deferred", "free"}
    assert set(out["semantic_overflow"]) == set(out["overflow"])


def _run(capsys, monkeypatch, *extra):
    monkeypatch.setattr(sys, "argv", ["bench", *TINY, *extra])
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_mode_lm(capsys, monkeypatch):
    out = _run(capsys, monkeypatch, "--mode", "lm")
    assert out["metric"] == \
        "LM frame-solves/s per chip (10 damped GN iterations)"
    assert out["value"] > 0 and out["device"] == "cpu"
    for key in ROOT_KEYS:
        assert key in out, key


def test_association_and_sol(capsys, monkeypatch):
    """--association measures the headline with that association alone
    (no sweep); --sol adds the five stages of the per-frame headline,
    each with its floor and the host ms (on the CPU, no device time), and
    writes nothing at the repository root (the root SOL.json holds the JAX
    package's TPU numbers)."""
    before = {f: os.path.getmtime(os.path.join(REPO, f))
              for f in os.listdir(REPO)}
    out = _run(capsys, monkeypatch, "--association", "per_iteration",
               "--sol")
    after = {f: os.path.getmtime(os.path.join(REPO, f))
             for f in os.listdir(REPO)}
    assert after == before
    assert out["value"] > 0 and out["cold_start_hz"] > 0
    for key in ("per_iteration_hz", "dense_mesh16_hz", "semantic_hz",
                "e2e_depth_hz"):
        assert key not in out, key
    stages = out["sol"]["stages"]
    assert set(stages) == {"prepare", "assoc", "assemble", "solve", "fuse"}
    for entry in stages.values():
        assert entry["host_ms"] > 0 and "device_ms" not in entry
        assert 0 <= entry["sol_frac"] <= 1 and entry["floor_ms"] >= 0
    assert "mfu" in stages["assemble"]
    assert out["sol"]["floors"]["step"] > 0


@pytest.mark.parametrize("workload", ["lm", "semantic", "host_loop"])
def test_track_step_leaves_its_input_state(workload, capsys, monkeypatch):
    """The cold start tracks from the frame-0 state after the warm-up run
    did: track_step must leave every tensor of its input state as it was
    (LM and autograd paths, tiny scene).  ``host_loop``: the bench's
    ``--host_loop`` line, whose cold start runs the eager step from that
    state again (the headline alone)."""
    from super_tpu_torch.config import lm_workload_config, \
        semantic_workload_config
    from super_tpu_torch.core.tracker import init_tracker, track_step

    if workload == "host_loop":
        out = _run(capsys, monkeypatch, "--host_loop", "--association",
                   "per_frame")
        assert out["loop"] == "host" and out["loops"] == {"value": "host"}
        assert out["value"] > 0 and out["cold_start_hz"] > 0
        assert out["cold_add_deferred"] >= 0
        return
    cfg = (lm_workload_config(48, 64, 8) if workload == "lm"
           else semantic_workload_config(48, 64, 8))
    intr, frame_of = bench._workload(cfg, "cpu")
    state0 = init_tracker(cfg, frame_of(0))
    copy = torch.utils._pytree.tree_map(torch.clone, state0)
    state, _ = track_step(cfg, intr, state0, frame_of(1))
    track_step(cfg, intr, state, frame_of(2))
    for a, b in zip(torch.utils._pytree.tree_leaves(state0),
                    torch.utils._pytree.tree_leaves(copy)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
