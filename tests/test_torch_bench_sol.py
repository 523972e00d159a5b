"""The port's bench with ``--association`` and ``--sol`` on the CPU at
48 x 64 (tests/test_torch_bench.py has the default line): the headline
alone with that association, the stages against their floors, and no
file written."""

import os

from torch_helpers import REPO, bench_line


def test_association_and_sol(capsys, monkeypatch):
    """--association measures the headline with that association alone
    (no sweep); --sol adds the five stages of the per-frame headline,
    each with its floor and the host ms (on the CPU, no device time), and
    writes nothing at the repository root (the root SOL.json holds the JAX
    package's TPU numbers)."""
    before = {f: os.path.getmtime(os.path.join(REPO, f))
              for f in os.listdir(REPO)}
    out = bench_line(capsys, monkeypatch, "--association", "per_iteration",
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
