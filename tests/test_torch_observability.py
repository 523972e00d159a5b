"""The port's observation of a run against the JAX package's
(tests/test_observability.py's twin): the z-buffer render, the magma
table, the logger's scalars and images, checkpoints and resume, and the
pipeline with a logger, on the tiny scene (48 x 64, mesh step 8).

The logger pair is fed the same numpy inputs (step outputs, errors,
images, keypoints, mesh), so tracking's chaotic spread cannot enter: the
port's scalars must equal the JAX logger's event file read back by
tensorboard's EventAccumulator (tags, steps, and values at the event
file's float32), and its PNGs must decode bitwise to the event file's
images.  Renders are compared bitwise; resume must equal an uninterrupted
run bitwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (two threads)
from helpers import tiny_config, tiny_scene
from torch_helpers import port_config, port_intr, port_state, to_np

from super_tpu.core.tracker import StepOutputs, init_tracker
from super_tpu.render.splat import render_zbuffer as jax_zbuffer
from super_tpu_torch.data.png import read_png
from super_tpu_torch.render.splat import render_zbuffer
from super_tpu_torch.utils import checkpoint as tckpt
from super_tpu_torch.utils.colormap import magma
from super_tpu_torch.utils.viz import TrackingLogger

H, W = 48, 64
EDGE_IDS = (1, 3, 5)


@pytest.fixture(scope="module")
def scene():
    cfg, intr, seq, frames = tiny_scene(num_frames=3)
    state = jax.jit(lambda f: init_tracker(cfg, f))(frames[0])
    return cfg, intr, seq, frames, state


def _both_renders(intr, points, colors, mask):
    want = np.asarray(jax_zbuffer(jnp.asarray(points), jnp.asarray(colors),
                                  jnp.asarray(mask), intr, H, W))
    got = render_zbuffer(torch.from_numpy(points), torch.from_numpy(colors),
                         torch.from_numpy(mask), port_intr(intr), H, W)
    return want, got.numpy()


def _map(scene, case):
    """(points, colors, mask) of a render case, float32 numpy."""
    _, _, _, _, state = scene
    sf = to_np(state.surfels)
    pts = sf.points.astype(np.float32)
    cols = sf.colors.astype(np.float32)
    mask = sf.active.copy()
    if case == "ties":
        # Every surfel twice, the copy in other colours: every covered
        # pixel holds a tie, which the last slot wins in both packages.
        return (np.concatenate([pts, pts], 1),
                np.concatenate([cols, 1 - cols], 1),
                np.concatenate([mask, mask]))
    if case == "crowded":
        # Random points in front of the camera, ~8 a covered pixel, at
        # 50 depths: collisions at unequal and equal depths.
        intr = scene[1]
        rng = np.random.default_rng(5)
        n = 8 * H * W
        z = rng.integers(1, 51, n).astype(np.float32) / 50
        u = rng.uniform(0, W, n)
        v = rng.uniform(0, H, n)
        xy = np.stack([(u - float(intr.cx)) / float(intr.fx),
                       (v - float(intr.cy)) / float(intr.fy)]) * z
        xy = xy.astype(np.float32)
        return (np.concatenate([xy, z[None]], 0),
                rng.uniform(size=(3, n)).astype(np.float32),
                rng.uniform(size=n) < 0.9)
    return pts, cols, mask


@pytest.mark.parametrize("case", ["map", "ties", "crowded"])
def test_zbuffer_matches_jax_bitwise(scene, case):
    """render_zbuffer on the frame-0 map, the map with every surfel
    doubled (ties everywhere), and crowded random points: bitwise the JAX
    package's on the CPU."""
    points, colors, mask = _map(scene, case)
    want, got = _both_renders(scene[1], points, colors, mask)
    np.testing.assert_array_equal(got, want)
    covered = (got != 0).any(axis=0).mean()
    assert covered > 0.3, covered


def test_zbuffer_tie_takes_the_last_slot(scene):
    """Seven surfels on one pixel, two of them nearest at equal depth, in
    three slot orders: the JAX package's CPU render shows the nearer one
    in the higher slot, and so does the port's (ROADMAP queue 3)."""
    intr = scene[1]
    n = 7
    pts = np.zeros((3, n), np.float32)
    pts[2] = 0.5
    pts[2, 5:] = 0.4
    cols = np.random.RandomState(0).rand(3, n).astype(np.float32)
    v, u = round(float(intr.cy)), round(float(intr.cx))
    for perm in (np.arange(n), np.arange(n)[::-1],
                 np.random.RandomState(1).permutation(n)):
        want, got = _both_renders(intr, pts[:, perm], cols[:, perm],
                                  np.ones(n, bool))
        last = max(i for i in range(n) if perm[i] >= 5)
        np.testing.assert_array_equal(want[:, v, u], cols[:, perm][:, last])
        np.testing.assert_array_equal(got, want)


def test_zbuffer_render_occlusion(scene):
    """tests/test_observability.py:test_zbuffer_render_occlusion on the
    port: of two points on one pixel the nearer wins."""
    intr = port_intr(scene[1])
    pts = torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.5, 0.4]])
    cols = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    img = render_zbuffer(pts, cols, torch.tensor([True, True]), intr, H, W)
    assert img.shape == (3, H, W)
    px = img[:, round(float(intr.cy)), round(float(intr.cx))]
    assert px[1] > px[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_magma_matches_matplotlib(dtype):
    """The port's magma table and lookup equal matplotlib's cm.magma
    bitwise at every bin edge k / 256, one ULP either side, and at
    -0.5, 1.5 and NaN."""
    import matplotlib.cm as cm

    edges = (np.arange(257) / 256).astype(dtype)
    xs = np.concatenate([edges, np.nextafter(edges, dtype(-1)),
                         np.nextafter(edges, dtype(2)),
                         np.array([-0.5, 1.5, np.nan], dtype)])
    np.testing.assert_array_equal(magma(xs), cm.magma(xs)[..., :3])


def _logger_inputs(scene):
    """The numpy inputs both loggers take: step outputs, errors of 3
    frames, the frame-0 image and depth, the map's render, keypoints, the
    ED mesh, and the confidence heat map's colours."""
    cfg, intr, seq, frames, state = scene
    from super_tpu.geometry.camera import project_points

    rng = np.random.default_rng(2)
    outs = StepOutputs(*(np.asarray(v) for v in (
        np.float32(12.5), np.float32(0.133), np.int32(3011), np.int32(48),
        np.int32(0), np.int32(2), np.int32(1), np.int32(7), np.int32(0),
        np.int32(3))))
    errors = {}
    for t in range(3):
        e = rng.uniform(0, 4, 20).astype(np.float32)
        e[rng.uniform(size=20) < 0.2] = -1.0
        errors[t] = e
    results = {t: np.concatenate([rng.uniform(0, 60, (20, 2)),
                                  np.ones((20, 1))], 1).astype(np.float32)
               for t in range(3)}
    sf, g = state.surfels, state.graph
    render = np.asarray(jax_zbuffer(sf.points, sf.colors, sf.active, intr,
                                    H, W))
    gv, gu, _, _ = project_points(g.points.T, intr, H, W)
    mesh_xy = np.stack([np.asarray(gu), np.asarray(gv)], axis=1)
    edges = np.asarray(g.edges)[np.asarray(g.edge_active)]
    confs = np.clip(np.asarray(sf.confs), 0, 1)
    return dict(outs=outs, errors=errors, results=results,
                color=seq.colors[0].transpose(2, 0, 1).astype(np.float32),
                depth=seq.depths[0].astype(np.float32), render=render,
                keypoints=results[2][:, :2], mesh_xy=mesh_xy, edges=edges,
                confs=confs, gt_xy=seq.gt_xy.astype(np.float32))


def _log(logger, inp, t=2):
    logger.log_step(t, inp["outs"], 41.0)
    logger.log_reproj(t, inp["errors"], EDGE_IDS)
    logger.log_images(t, inp["color"], depth=inp["depth"],
                      render_chw=inp["render"], keypoints_xy=inp["keypoints"],
                      mesh_points_xy=inp["mesh_xy"], mesh_edges=inp["edges"])
    logger.log_trackpts_plots(t, inp["errors"], inp["results"], inp["gt_xy"])


@pytest.fixture(scope="module")
def logs(scene, tmp_path_factory):
    """Both loggers fed the same inputs: (JAX event accumulator, port
    logdir, inputs)."""
    import matplotlib.cm as cm
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from super_tpu.utils.viz import TrackingLogger as JaxLogger

    _, intr, _, _, state = scene
    inp = _logger_inputs(scene)
    sf = state.surfels
    jdir = str(tmp_path_factory.mktemp("jax_tb"))
    jlog = JaxLogger(jdir)
    _log(jlog, inp)
    heat = np.ascontiguousarray(cm.magma(inp["confs"])[:, :3].T.astype(
        np.float32))
    heat_img = np.asarray(jax_zbuffer(sf.points, jnp.asarray(heat),
                                      sf.active, intr, H, W))
    jlog.writer.add_image("visualization/uncertainty",
                          np.clip(heat_img, 0, 1), 2)
    jlog.close()

    pdir = str(tmp_path_factory.mktemp("port_logs"))
    plog = TrackingLogger(pdir)
    _log(plog, inp)
    psf = port_state(state).surfels
    pheat = torch.from_numpy(np.ascontiguousarray(
        magma(inp["confs"]).T.astype(np.float32)))
    pheat_img = render_zbuffer(psf.points, pheat, psf.active,
                               port_intr(intr), H, W).numpy()
    plog.add_image("visualization/uncertainty", np.clip(pheat_img, 0, 1), 2)
    plog.close()
    acc = EventAccumulator(jdir, size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    return acc, pdir, inp


def test_logger_scalars_match_jax(logs):
    acc, pdir, _ = logs
    with open(os.path.join(pdir, "scalars.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    got = {(d["tag"], d["step"]): d["value"] for d in lines}
    want = {(tag, e.step): e.value for tag in acc.Tags()["scalars"]
            for e in acc.Scalars(tag)}
    assert len(got) == len(lines) == len(want) == 15
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.float32(got[key]) == np.float32(value), key


@pytest.mark.parametrize("tag", ["raw", "disparity", "render",
                                 "uncertainty"])
def test_logger_images_match_jax(logs, tag):
    from io import BytesIO

    from PIL import Image

    acc, pdir, _ = logs
    (event,) = acc.Images(f"visualization/{tag}")
    want = np.asarray(Image.open(BytesIO(event.encoded_image_string)))
    got = read_png(os.path.join(pdir, "visualization", tag, "00000002.png"))
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 3


def test_logger_plot_data(logs):
    """The JAX logger draws the three plots; the port writes their data
    under the same tags: the per-point mean and std over valid errors, the
    mean error per frame, the first 8 trajectories."""
    acc, pdir, inp = logs
    arr = np.stack([inp["errors"][k] for k in range(3)])
    valid = arr >= 0
    for tag in ("reproj_per_point", "reproj_over_time", "trajectories"):
        assert f"plots/{tag}" in acc.Tags()["images"]
    d = np.load(os.path.join(pdir, "plots", "reproj_per_point",
                             "00000002.npz"))
    for i in range(arr.shape[1]):
        col = arr[:, i][valid[:, i]]
        assert d["mean"][i] == (col.mean() if col.size else 0)
        assert d["std"][i] == (col.std() if col.size else 0)
    d = np.load(os.path.join(pdir, "plots", "reproj_over_time",
                             "00000002.npz"))
    np.testing.assert_array_equal(d["frame"], [0, 1, 2])
    np.testing.assert_array_equal(d["mean"], np.nanmean(
        np.where(valid, arr, np.nan), axis=1))
    d = np.load(os.path.join(pdir, "plots", "trajectories", "00000002.npz"))
    np.testing.assert_array_equal(d["gt_xy"], inp["gt_xy"][:, :8])
    np.testing.assert_array_equal(d["pred_xy"], np.stack(
        [inp["results"][k][:8, :2] for k in range(3)]))


def test_logger_pointcloud(tmp_path):
    log = TrackingLogger(str(tmp_path))
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    log.log_pointcloud(4, pts, pts + 0.5)
    d = np.load(tmp_path / "visualization" / "pcd" / "00000004.npz")
    np.testing.assert_array_equal(d["points"], pts)
    np.testing.assert_array_equal(d["colors"], np.clip(pts + 0.5, 0, 1))


def _same_state(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device, k
        assert torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip(tmp_path, scene):
    """A JAX init_tracker state carried into the port
    (convert.tracker_state_from_numpy) through save and restore comes back
    unchanged; latest_checkpoint finds the last step; a reference of
    another shape, dtype or field set is refused."""
    state = port_state(scene[4])
    root = str(tmp_path / "ckpt")
    tckpt.save_state(root, state, step=3)
    path = tckpt.save_state(root, state, step=12)
    assert path.endswith("step_00000012")
    assert tckpt.latest_checkpoint(root) == path
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    restored = tckpt.restore_state(path, state)
    _same_state(restored, state)
    np.testing.assert_array_equal(restored.surfels.points.numpy(),
                                  np.asarray(scene[4].surfels.points))
    sf = state.surfels
    for bad in (sf._replace(radii=sf.radii[:-1]),
                sf._replace(radii=sf.radii.double())):
        with pytest.raises(ValueError):
            tckpt.restore_state(path, state._replace(surfels=bad))
    flat = torch.load(os.path.join(path, tckpt.STATE_FILE))
    del flat["time"]
    torch.save(flat, os.path.join(path, tckpt.STATE_FILE))
    with pytest.raises(ValueError):
        tckpt.restore_state(path, state)


def test_resume_equals_uninterrupted(tmp_path, scene):
    """Track frames 1 and 2 from frame 0's state; or track frame 1, save,
    restore into a state built from frame 2, and track frame 2: the
    states and costs are bitwise equal."""
    from super_tpu_torch.core.tracker import init_tracker as tinit
    from super_tpu_torch.core.tracker import track_step

    cfg, intr, seq, frames, _ = scene
    pcfg, pintr = port_config(cfg), port_intr(intr)
    pframes = [torch_helpers.port_frame(f) for f in frames]
    s1, _ = track_step(pcfg, pintr, tinit(pcfg, pframes[0]), pframes[1])
    s2, o2 = track_step(pcfg, pintr, s1, pframes[2])
    path = tckpt.save_state(str(tmp_path), s1, step=1)
    restored = tckpt.restore_state(path, tinit(pcfg, pframes[2]))
    r2, ro2 = track_step(pcfg, pintr, restored, pframes[2])
    _same_state(r2, s2)
    assert torch.equal(ro2.lm_cost, o2.lm_cost)


class _Clock:
    """perf_counter stand-in: one second a call, and 100 more for every
    observation, so an observation inside a frame's window would show."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1.0
        return self.now


def test_pipeline_observes_outside_the_frame_time(tmp_path, monkeypatch):
    """SuPerPipeline with a logger and checkpoints on 4 frames, every 2nd
    observed: the summary equals the one without them; scalars, PNGs and
    checkpoints are where they should be."""
    from super_tpu.data.synthetic import default_intrinsics, generate
    from super_tpu_torch import pipeline as tpipe
    from super_tpu_torch.data.synthetic import default_intrinsics as tintr

    cfg = port_config(tiny_config().replace(save_sample_freq=2))
    seq = generate(4, H, W, intr=default_intrinsics(H, W), seed=1)
    clock = _Clock()
    monkeypatch.setattr(tpipe._time, "perf_counter", clock)
    observe = tpipe.SuPerPipeline._observe

    def slow_observe(self, *a):
        clock.now += 100.0
        return observe(self, *a)

    monkeypatch.setattr(tpipe.SuPerPipeline, "_observe", slow_observe)
    summaries = []
    for kw in ({}, dict(logdir=str(tmp_path / "logs"),
                        checkpoint_dir=str(tmp_path / "ck"))):
        pipe = tpipe.SuPerPipeline(cfg, tintr(H, W, device="cpu"),
                                   device="cpu", **kw)
        summaries.append(pipe.run(seq.depths, seq.colors, gt_xy=seq.gt_xy,
                                  gt_valid=seq.gt_valid))
    assert summaries[0] == summaries[1]
    assert pipe.frame_times == [1.0] * 4
    assert pipe.observe_times == [101.0, 101.0]
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {d["step"] for d in lines} == {0, 2}
    assert {d["tag"] for d in lines if d["step"] == 0} == {"reprojerr/mean",
                                                           "reprojerr/std"}
    tags = {d["tag"] for d in lines if d["step"] == 2}
    assert "optimization_record/final_cost" in tags and len(tags) == 13
    assert all(np.isfinite(d["value"]) for d in lines)
    for tag in ("raw", "disparity", "render", "uncertainty"):
        for step in (0, 2):
            img = read_png(tmp_path / "logs" / "visualization" / tag /
                           f"{step:08d}.png")
            assert img.shape == (H, W, 3)
    assert (tmp_path / "logs" / "plots" / "trajectories" /
            "00000003.npz").exists()
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000000",
                                                   "step_00000002"]
