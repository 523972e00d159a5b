"""The harness's parts on the CPU: the clip against the port's numpy
generator, the frame source, the metric arithmetic, the roofline counts,
the benchmark's names and files, and the guard against JAX."""

import ast
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from benchmark import clip, drive, guard, roofline, spec, stats
from benchmark import trace as tr

HERE = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("variant,classes", [("clean", 0), ("clean", 2),
                                             ("occlusion", 0),
                                             ("specular", 3)])
def test_clip_matches_the_numpy_generator(variant, classes):
    from super_tpu_torch.data import synthetic

    seq = synthetic.generate(4, 32, 48, seed=5, num_classes=classes,
                             variant=variant)
    c = clip.make_clip(32, 48, 4, 0.0, seq.track0_xy, num_classes=classes,
                       variant=variant, device="cpu")
    np.testing.assert_array_equal(np.isnan(seq.depths),
                                  np.isnan(c.depths.numpy()))
    np.testing.assert_allclose(c.depths.numpy(), seq.depths, atol=1e-7)
    np.testing.assert_allclose(c.colors.numpy(), seq.colors, atol=1e-7)
    np.testing.assert_allclose(c.gt_xy.numpy(), seq.gt_xy, atol=1e-4)
    np.testing.assert_array_equal(c.gt_valid.numpy(), seq.gt_valid)
    if classes:
        np.testing.assert_array_equal(c.segs.numpy(), seq.segs)
        np.testing.assert_allclose(c.seg_confs.numpy(), seq.seg_confs,
                                   atol=1e-7)


def test_clip_start_time_and_noise_seed():
    xy = np.array([[10, 10], [20, 12]])
    a = clip.make_clip(24, 32, 3, 4.0, xy, device="cpu")
    b = clip.make_clip(24, 32, 5, 2.0, xy, device="cpu")
    # Frame 0 at time 4 holds the tracked points at their pixels.
    np.testing.assert_allclose(a.gt_xy[0].numpy(), xy, atol=1e-3)
    assert not torch.equal(a.depths[0], b.depths[0])
    n1 = clip.make_clip(24, 32, 2, 0.0, xy, variant="noise", device="cpu",
                        noise_seed=3)
    n2 = clip.make_clip(24, 32, 2, 0.0, xy, variant="noise", device="cpu",
                        noise_seed=3)
    assert torch.equal(torch.nan_to_num(n1.depths),
                       torch.nan_to_num(n2.depths))


def test_draw_is_fixed_by_seed_and_stream():
    t = spec.load_traffic("clip")
    a = drive.draw(2 ** 31 + 7, 0, t, 480, 640)
    b = drive.draw(2 ** 31 + 7, 0, t, 480, 640)
    c = drive.draw(2 ** 31 + 7, 1, t, 480, 640)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])
    assert t["start_time"][0] <= a[0] < t["start_time"][1]
    assert a[1].shape == (t["tracked_points"], 2)


def test_pingpong_order():
    assert [drive.pingpong(t, 4) for t in range(10)] == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    order = [drive.pingpong(t, 30) for t in range(116)]
    assert order[29] == 29 and order[30] == 28 and order[58] == 0
    assert order.count(0) == 2 and order.count(29) == 2


def test_frame_source_times_and_end_of_window():
    win = drive.Window(seconds=0.05, warmup=2, min_frames=6, seed=1,
                       checks=2)
    arr = np.arange(5)[:, None]
    starts = []
    src = drive._Frames(arr, lambda t: (starts.append(t),
                                        win.start(t, state=t)))
    got = []
    with pytest.raises(drive.EndOfWindow):
        for t in range(len(src)):
            got.append(int(src[t][0]))
            src[t]                       # a second fetch is no new start
            time.sleep(0.01)
    assert starts == list(range(len(starts)))
    assert got == [drive.pingpong(t, 5) for t in range(len(got))]
    assert np.all(np.diff(win.starts) > 0)
    assert win.end == len(got) and win.end >= 6
    assert win.wall_s >= 0.05
    assert len(win.frame_times()) == win.frames == win.end - 2
    # The sample: window frames only, at most ``checks``, each with the
    # state before it and after it; frame 0 always.
    assert 1 <= len(win.sample) <= 2 and min(win.sample) >= 2
    for t in win.sample:
        assert win.kept[t]["prev"] == t and win.kept[t]["after"] == t + 1
    assert win.kept[0]["after"] == 1


def test_percentile_rate_union_idle():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.rate(30, 1.5) == 20.0
    np.testing.assert_allclose(stats.intervals([0, 1, 3, 6]), [1, 2, 3])
    spans = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union(spans, 0, 10) == 5.0
    assert stats.gaps(spans, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_share(spans, 0, 10) == pytest.approx(50.0)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_stretch_readers_on_made_up_spans():
    st = tr.Stretch(lo=0.0, hi=100.0, frames=2,
                    device=[(0, 10, "k_a"), (5, 20, "k_b"),
                            (50, 60, "Memcpy DtoH (Device -> Pageable)"),
                            (90, 110, "k_a")],
                    host=[(0, 100, "bench.step"),
                          (48, 62, "cudaMemcpyAsync"),
                          (70, 80, "cudaStreamSynchronize"),
                          (30, 40, "aten::add")],
                    streams=1, states=[], config=None, intr=None,
                    context={})
    assert tr.busy_us(st) == 40.0
    assert tr.wait_us(st) == 24.0
    mods = {n: spec.load_metric(n) for n in (
        "pipeline.host_ms", "step.device_ms", "step.kernels_per_frame",
        "device.idle_share")}
    assert mods["pipeline.host_ms"].read(st) == pytest.approx(0.038)
    assert mods["step.device_ms"].read(st) == pytest.approx(0.02)
    assert mods["step.kernels_per_frame"].read(st) == 1.5
    assert mods["device.idle_share"].read(st) == pytest.approx(60.0)
    b = tr.breakdown(st)
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert dict(b["idle_gaps"])["aten::add"] == pytest.approx(30e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_roofline_against_chip_smoke_bound():
    import chip_smoke

    for nbytes, flops in [(1.75e6, 28.6e6), (97.0e6, 1.17e9),
                          (4.31e6, 133e6)]:
        ms, by = chip_smoke.bound(nbytes, flops)
        s, by2 = roofline.bound(nbytes, flops)
        assert by == by2 and s * 1e3 == pytest.approx(ms)
    # K1's work at J 384, every pair of a 4,096-pair table in use, as
    # chip_smoke counts it (the index arrays over the pairs in use).
    nbytes, flops = roofline.pairs_cg_work(384, 4096, 32)
    assert flops == 33 * (2 * 2 * 49 * 4096 + 2 * 49 * 384 + 10 * 7 * 384)
    assert nbytes == 2 * 49 * 4096 * 4 + 2 * 4096 * 4 + 49 * 384 * 4 \
        + 3 * 7 * 384 * 4 + 4
    nbytes, flops = roofline.data_gram_work(1000, 900, 10)
    assert flops == 900 * (470 + 2 * (406 + 28) + 2)


def _tiny_state():
    from super_tpu_torch.core.state import (TrackerState, empty_graph,
                                            empty_surfels, empty_track)
    from super_tpu_torch.config import lm_workload_config

    cfg = lm_workload_config(48, 64, 8)
    g = empty_graph(cfg, "cpu")
    g = g._replace(active=torch.arange(g.capacity) < 6,
                   knn_idx=torch.tensor([[1, 2, 3, 4]] * g.capacity,
                                        dtype=torch.int32))
    sf = empty_surfels(cfg, "cpu")
    act = torch.zeros(sf.capacity, dtype=torch.bool)
    act[:3] = True
    idx = sf.knn_idx.clone()
    idx[:, 0] = torch.tensor([0, 1, 2, 3])
    idx[:, 1] = torch.tensor([0, 1, 2, 3])
    idx[:, 2] = torch.tensor([2, 3, 4, 5])
    pts = sf.points.clone()
    pts[2, :3] = 0.5
    sf = sf._replace(active=act, knn_idx=idx, points=pts)
    return cfg, TrackerState(sf, g, empty_track(cfg, "cpu"),
                             torch.zeros(()))


INTR = (500.0, 500.0, 31.6, 24.2)


def test_problem_sizes_of_a_tiny_state():
    _, state = _tiny_state()
    z = roofline.problem_sizes(state, INTR, 48, 64)
    assert z["nodes"] == 6 and z["slots"] == 3 and z["tuples"] == 2
    # Anchor pairs of (0..3) and (2..5), node diagonals 0..5, ARAP pairs of
    # each active node with nodes 1..4.
    assert z["pairs"] == len({(a, b) for s in ([0, 1, 2, 3], [2, 3, 4, 5])
                              for i, a in enumerate(s) for b in s[i:]}
                             | {(i, i) for i in range(6)}
                             | {(min(i, n), max(i, n)) for i in range(6)
                                for n in (1, 2, 3, 4)})


@pytest.mark.parametrize("name,op,work", [
    ("kernel.pairs_cg.roofline", "void pairs_cg_kernel<float>(...)",
     lambda z, s: roofline.pairs_cg_work(z["nodes"], z["pairs"],
                                         s.pcg_iterations)),
    ("kernel.data_gram.roofline", "void gram_kernel<Data>(...)",
     lambda z, s: roofline.data_gram_work(z["slots"], z["rows"],
                                          z["tuples"]))])
def test_roofline_readers_count_the_stretch_problem(name, op, work):
    cfg, state = _tiny_state()
    st = tr.Stretch(lo=0.0, hi=1000.0, frames=2,
                    device=[(0, 40, op), (100, 140, op), (200, 230, "k_a"),
                            (300, 310, "void gram_kernel<Memory>(...)")],
                    host=[], streams=3, states=[state, state],
                    config=cfg, intr=INTR,
                    context={"peak": roofline.DEFAULT_PEAK})
    z = roofline.problem_sizes(state, INTR, 48, 64)
    least, by = roofline.bound(*work(z, cfg.solver))
    launches = 2 * 3 * cfg.solver.num_iterations
    value = spec.load_metric(name).read(st)
    assert value == pytest.approx(100.0 * least * launches / 80e-6)
    assert st.context["bounds"][name] == by
    # No such operation in the stretch: nothing to read.
    st = st._replace(device=[(0, 40, "k_a")], context={
        "peak": roofline.DEFAULT_PEAK})
    assert spec.load_metric(name).read(st) is None


def test_maps_compare_as_sets():
    from benchmark import compare

    n = 12
    pts = torch.arange(3 * n, dtype=torch.float64).reshape(3, n)
    idx = torch.arange(4 * n).reshape(4, n) % 5
    ref = {"points": pts, "knn_idx": idx,
           "active": torch.arange(n) < 8}
    added = torch.tensor([5, 6, 7])
    # The program puts the frame's three new surfels a slot later: the
    # same map.
    order = torch.tensor([0, 1, 2, 3, 4, 11, 5, 6, 7, 8, 9, 10])
    shifted = {"points": pts[:, order], "knn_idx": idx[:, order],
               "active": (torch.arange(n) < 5) | ((torch.arange(n) > 5)
                                                  & (torch.arange(n) < 9))}
    agree, _, unmatched, new_bad, _ = compare.match_maps(shifted, ref,
                                                         added)
    assert agree.sum() == 5 and unmatched == 0 and new_bad == 0
    # The program drops them.
    dropped = dict(ref, active=torch.arange(n) < 5)
    _, _, unmatched, new_bad, _ = compare.match_maps(dropped, ref, added)
    assert unmatched == 6 and new_bad == 3
    # The program moves one by more than OFF_UM.
    moved = dict(ref, points=pts.clone())
    moved["points"][0, 6] += 1e-3
    _, _, unmatched, new_bad, _ = compare.match_maps(moved, ref, added)
    assert unmatched == 2 and new_bad == 1


def test_benchmark_names_units_and_files():
    bench = spec.load_benchmark()
    assert spec.check_names(bench) == []
    for c in bench["configs"]:
        conf = spec.load_config(c["name"])
        assert set(conf["limits"]) >= {"prep_points_um", "track_px"}
        assert conf["source"] == c["source"]
    for w in bench["workloads"]:
        spec.load_traffic(w["traffic"])
        assert w["config"] in [c["name"] for c in bench["configs"]]
    for m in bench["per_layer"]:
        assert callable(spec.load_metric(m["name"]).read)
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in bench[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_files_are_found_by_name_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "HERE", tmp_path)
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "x.json").write_text('{"limits": {}}')
    (tmp_path / "traffic" / "y.json").write_text('{"streams": 3}')
    (tmp_path / "metrics" / "z.m.py").write_text(
        "def read(st):\n    return 7\n")
    assert spec.load_config("x") == {"limits": {}}
    assert spec.load_traffic("y") == {"streams": 3}
    assert spec.load_metric("z.m").read(None) == 7


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["super_tpu_torch", "super_tpu_torch.x",
                                    "jaxtyping", "flaxen.y"]) == []
    assert guard.forbidden_modules(["jax.numpy", "super_tpu.core.lm",
                                    "flax", "jaxlib.xla_client"]) == \
        ["flax", "jax", "jaxlib", "super_tpu"]


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in sorted((HERE / "reference").glob("*.py")) + \
            [HERE / "compare.py", HERE / "evaluation.py", HERE / "clip.py",
             HERE / "roofline.py", HERE / "stats.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("super_tpu_torch", "super_tpu",
                                               "jax", "jaxlib", "flax"), \
                    (path.name, n)


def test_no_card_means_no_result(capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "super_lm.clip", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
