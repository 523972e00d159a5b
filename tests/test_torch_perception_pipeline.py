"""The perception nets in the port's loop, against the JAX package (the
``sf_corr`` face and fit: test_torch_corr_flow.py):

- the live path's configuration (config.e2e_depth_workload_config) field
  by field against the root bench's ``measure_e2e_depth``;
- SuPerPipeline with monodepth2's depth (no given depths) for 3 frames at
  48 x 64, port and JAX package loading one checkpoint file;
- the semantic path with its models on the port alone (64 x 96):
  DeepLabV3+ segmentations and a seeded RAFT's flow, 3 frames with the
  per-frame flow and one with the flow of the render.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_helpers import NET_TOL, close, port_config, save_checkpoint, \
    semantic_config

from super_tpu import factory as jfactory
from super_tpu.data.synthetic import default_intrinsics, generate
from super_tpu.pipeline import SuPerPipeline
from super_tpu_torch import factory
from super_tpu_torch.config import e2e_depth_workload_config, workload_config
from super_tpu_torch.core import optimizer as topt
from super_tpu_torch.data.synthetic import default_intrinsics as tintr
from super_tpu_torch.pipeline import SuPerPipeline as TSuPerPipeline


def test_e2e_depth_workload_config_matches_bench(monkeypatch):
    """e2e_depth_workload_config(480, 640) is, field by field, the
    configuration of the root bench's e2e_depth_hz (build_workload's
    per-frame headline with monodepth2 and the flip post-processing) with
    the port's assembly_backend="pallas", and the "e2e_depth" workload of
    chip_smoke.py and profile_step.py."""
    import bench
    import super_tpu.core.preprocess as jpre
    import super_tpu.core.tracker as jtrk
    import super_tpu.data.synthetic as jsyn

    monkeypatch.setattr(jsyn, "generate", lambda n, h, w, **k:
                        types.SimpleNamespace(
                            depths=np.zeros((n, h, w), np.float32),
                            colors=np.zeros((n, h, w, 3), np.float32)))
    monkeypatch.setattr(jpre, "preprocess_frame", lambda *a, **k: None)
    monkeypatch.setattr(jtrk, "init_tracker", lambda *a, **k: None)
    cfg, _, _, _ = bench.build_workload(
        types.SimpleNamespace(height=480, width=640), 30, "per_frame")
    # measure_e2e_depth's replacement, and the port's assembly backend.
    cfg = cfg.replace(depth_model="monodepth2_stereo", post_process=True)
    want = port_config(cfg.replace(solver=dataclasses.replace(
        cfg.solver, assembly_backend="pallas")))
    got = e2e_depth_workload_config(480, 640)
    for part in ("losses", "solver", "capacity"):
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(want, part)), part
    assert got == want == workload_config("e2e_depth")


@pytest.fixture(scope="module")
def mono_runs(tmp_path_factory):
    """Both pipelines with monodepth2's depth from one checkpoint: 3 frames
    and frame 0 alone, per package."""
    h, w = 48, 64
    cfg = tiny_config(h, w, step=8).replace(depth_model="monodepth2_stereo",
                                            load_depth=False,
                                            post_process=True)
    src = factory.build_models(port_config(cfg), seed=1, device="cpu")
    d = tmp_path_factory.mktemp("mono")
    ckpt = dict(encoder_checkpoint=save_checkpoint(
        d / "encoder.pth", src.depth_model.encoder.state_dict(), height=h,
        width=w, use_stereo=True), depth_checkpoint=save_checkpoint(
        d / "depth.pth", src.depth_model.decoder.state_dict()))
    jm = jfactory.build_models(cfg, **ckpt)
    tm = factory.build_models(port_config(cfg), device="cpu", **ckpt)
    seq = generate(3, h, w, intr=default_intrinsics(h, w), seed=0)
    out = {}
    for n in (1, 3):
        ref = SuPerPipeline(cfg, default_intrinsics(h, w))
        port = TSuPerPipeline(port_config(cfg), tintr(h, w, device="cpu"),
                              device="cpu")
        out[n] = (ref, ref.run(None, seq.colors[:n], models=jm),
                  port, port.run(None, seq.colors[:n], models=tm))
    return out


def test_pipeline_frame0_from_model_depth(mono_runs):
    """Frame 0's surfels from the two nets' depths: the same surfels, their
    positions within the nets' tolerance."""
    ref, _, port, _ = mono_runs[1]
    rs, ps = ref.state.surfels, port.state.surfels
    close(rs.active, ps.active, atol=0, name="active")
    act = np.asarray(rs.active)
    assert act.sum() > 1000
    pts = np.asarray(rs.points)[:, act]
    close(pts, ps.points[:, torch.as_tensor(act.copy())],
          atol=NET_TOL * float(np.max(np.abs(pts))), name="points")


def test_pipeline_tracks_model_depth_like_jax(mono_runs):
    """Three frames of LM tracking on the nets' depths: as the port's
    tests/test_torch_pipeline.py holds two trackers of one chaotic loop,
    the surfel count within 2% and the node count equal, every active
    surfel finite."""
    ref, ref_m, port, port_m = mono_runs[3]
    assert port_m["num_surfels"] > 1000
    assert abs(port_m["num_surfels"] - ref_m["num_surfels"]) <= \
        0.02 * ref_m["num_surfels"], (port_m, ref_m)
    assert port_m["num_nodes"] == ref_m["num_nodes"]
    sf = port.state.surfels
    assert torch.isfinite(sf.points[:, sf.active]).all()
    assert len(port.frame_times) == 3


SEM_H, SEM_W = 64, 96          # RAFT's four levels need 1/8 of >= 8 rows


def _semantic_models_config(match_renderimg=False):
    cfg = port_config(semantic_config(render=False))
    cfg = cfg.replace(height=SEM_H, width=SEM_W, mesh_step_size=12,
                      seg_model="deeplabv3plus", load_seg=False,
                      capacity=dataclasses.replace(
                          cfg.capacity, surfel_capacity=2 * SEM_H * SEM_W,
                          new_surfel_capacity=SEM_H * SEM_W))
    return cfg.replace(losses=dataclasses.replace(
        cfg.losses, sf_corr=True, sf_corr_match_renderimg=match_renderimg))


@pytest.mark.parametrize("match_renderimg", [False, True])
def test_semantic_path_with_models(match_renderimg):
    """The port's semantic path with DeepLabV3+ segmentations and a seeded
    RAFT's flow (64 x 96): frame 1's corr face is nonzero and every loss
    finite; the pipeline tracks 3 frames (1 with the flow of the render)
    with finite costs and live surfels."""
    from super_tpu_torch.core.preprocess import preprocess_frame
    from super_tpu_torch.core.tracker import init_tracker as tinit

    cfg = _semantic_models_config(match_renderimg)
    models = factory.build_models(cfg, seed=2, device="cpu")
    assert models.depth_model is None
    intr = tintr(SEM_H, SEM_W, device="cpu")
    seq = generate(3, SEM_H, SEM_W, intr=default_intrinsics(SEM_H, SEM_W),
                   seed=1)
    colors = np.ascontiguousarray(seq.colors.transpose(0, 3, 1, 2))
    frames = []
    for t in range(2):
        pred = factory.predict_frame_inputs(cfg, models, colors[t])
        assert set(pred) == {"seg", "seg_conf"}
        frames.append(preprocess_frame(cfg, intr, seq.depths[t], colors[t],
                                       float(t), seg=pred["seg"],
                                       seg_conf=pred["seg_conf"],
                                       device="cpu"))
    st = tinit(cfg, frames[0])
    with torch.no_grad():
        flow = models.flow_model(frames[0].color_image[None],
                                 frames[1].color_image[None])[0]
    assert flow.shape == (2, SEM_H, SEM_W) and torch.isfinite(flow).all()
    ctx = topt.prepare_autograd(cfg, st.surfels, st.graph, frames[1],
                                flow=flow, intr=intr)
    deform = torch.zeros(st.graph.capacity + 1, 7)
    deform[:, 0] = 1.0
    total, parts = topt.autograd_total(cfg, ctx, st.graph, deform, intr)
    assert float(parts["corr"]) > 0
    assert all(torch.isfinite(v) for v in parts.values())

    pipe = TSuPerPipeline(cfg, intr, device="cpu")
    n = 2 if match_renderimg else 3
    m = pipe.run(seq.depths[:n], seq.colors[:n], models=models)
    assert m["num_surfels"] > 1000
    sf = pipe.state.surfels
    assert torch.isfinite(sf.points[:, sf.active]).all()
    assert pipe.state.surfels.seg_conf.shape[0] == 2
