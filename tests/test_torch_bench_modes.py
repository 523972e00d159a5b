"""The port's bench with ``--mode lm`` and ``--host_loop`` on the CPU at
48 x 64 (tests/test_torch_bench.py has the default line), and track_step
leaving its input state as it was, which the cold start relies on."""

import numpy as np
import pytest
import torch

from torch_helpers import BENCH_ROOT_KEYS, bench_line

from super_tpu_torch import bench


def test_mode_lm(capsys, monkeypatch):
    out = bench_line(capsys, monkeypatch, "--mode", "lm")
    assert out["metric"] == \
        "LM frame-solves/s per chip (10 damped GN iterations)"
    assert out["value"] > 0 and out["device"] == "cpu"
    for key in BENCH_ROOT_KEYS:
        assert key in out, key


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
        out = bench_line(capsys, monkeypatch, "--host_loop", "--association",
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
