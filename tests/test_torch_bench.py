"""The port's bench (python -m super_tpu_torch.bench) on the CPU at 48 x 64:
one JSON line with the root bench's keys (bench.py's last print), the
per-iteration, dense and semantic entries, the perception nets' rates and
the live path with monodepth2's depth, the cold start, and no error key;
the default loop, replays of the captured step (``"loop": "device"``;
on the CPU run eagerly on its buffers).  ``--association`` and ``--sol``
are in test_torch_bench_sol.py, ``--mode lm``, ``--host_loop`` and the
input state that the cold start relies on in test_torch_bench_modes.py
(one file each, so that the workers of a run share them out)."""

from torch_helpers import BENCH_ROOT_KEYS, bench_line


def test_bench_prints_the_root_keys(capsys, monkeypatch):
    out = bench_line(capsys, monkeypatch)
    for key in BENCH_ROOT_KEYS + ("per_iteration_hz", "dense_mesh16_hz",
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
