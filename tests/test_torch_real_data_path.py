"""The port's entry points on a SuPer-V1 layout directory, against the
root CLI (tests/test_real_data_path.py's twin).

The tiny directory (tests/test_real_data_path.py:_write_v1_dir: rgb/
PNGs, depth/ sigmoid disparities, seg/ label PNGs and a GT bundle whose
``super_cpp`` trajectory is offset 1.5 px) is written once for the module.
``python -m super_tpu_torch.run_super --cpu`` and the root run_super.py
run on it; their metrics agree: the same frames evaluated and C++-SuPer
baseline, and the reprojection error within test_torch_pipeline.py's band
of max(0.3 px, 20%) of the JAX package's.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_real_data_path import END, START, H, W, _write_v1_dir

from super_tpu_torch import run_semantic_super, run_super
from super_tpu_torch.data import superv1 as tsuperv1
from super_tpu_torch.geometry.camera import Intrinsics
from super_tpu_torch.runtime import native_toolchain

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def v1_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1")
    _write_v1_dir(str(root), with_png_seg=True)
    return root


def _root_run_super():
    """The root run_super.py, imported by path (another run_super.py on
    sys.path would shadow it)."""
    spec = importlib.util.spec_from_file_location(
        "_repo_run_super", os.path.join(REPO, "run_super.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_args(root, out):
    return ["--data_dir", str(root), "--cpu",
            "--height", str(H), "--width", str(W), "--mesh_step_size", "10",
            "--start_id", str(START), "--end_id", str(END),
            "--num_optimize_iterations", "4",
            "--tracking_gt_file", "left_pts.npy", "--output_json", str(out)]


@pytest.fixture(scope="module")
def cli_runs(v1_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("metrics")
    assert _root_run_super().main(_cli_args(v1_dir, out / "jax.json")) == 0
    assert run_super.main(_cli_args(v1_dir, out / "port.json")) == 0
    return (json.load(open(out / "jax.json")),
            json.load(open(out / "port.json")))


def test_cli_metrics_match_root_cli(cli_runs):
    ref, port = cli_runs
    assert port["num_eval_frames"] == ref["num_eval_frames"] == END - START
    assert port["super_cpp_mean"] == ref["super_cpp_mean"]
    assert port["super_cpp_mean"] == pytest.approx(np.hypot(1.5, 1.5),
                                                   rel=1e-5)
    assert port["super_cpp_std"] == ref["super_cpp_std"]
    assert np.isfinite(port["reproj_mean"])
    tol = max(0.3, 0.2 * ref["reproj_mean"])
    assert abs(port["reproj_mean"] - ref["reproj_mean"]) <= tol, (port, ref)


def test_cli_reports_loader(cli_runs):
    """The metrics name the decoder that read the frames: the native
    loader wherever it can be built."""
    want = ("native" if native_toolchain() is None
            else tsuperv1.python_decoder())
    assert cli_runs[1]["loader"] == want


def _load_args(root):
    return SimpleNamespace(
        data_dir=str(root), rgb_dir="rgb", depth_dir="depth", seg_dir="seg",
        start_id=START, end_id=END, depth_ext=".npy", img_ext=".png",
        tracking_gt_file="left_pts.npy")


@pytest.mark.parametrize("load_seg", [False, True])
def test_load_sequence_matches_jax(v1_dir, load_seg):
    """The port's arrays against the JAX loader's: bitwise on the Python
    path (``load_seg``, the .png seg branch), the depths within float32
    rounding where the native loader ran."""
    from super_tpu.config import SuPerConfig
    from super_tpu.data.superv1 import load_sequence
    from super_tpu_torch.config import SuPerConfig as TSuPerConfig

    kw = dict(height=H, width=W, load_seg=load_seg, num_classes=2)
    _, want = load_sequence(SuPerConfig(**kw), _load_args(v1_dir))
    _, got = tsuperv1.load_sequence(TSuPerConfig(**kw), _load_args(v1_dir),
                                    device="cpu")
    assert got.loader == ("native" if not load_seg and native_toolchain()
                          is None else tsuperv1.python_decoder())
    for name in ("colors", "gt_xy", "gt_valid", "segs", "seg_confs",
                 "frame_ids"):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, name)
    np.testing.assert_allclose(got.depths, want.depths, rtol=2e-6)
    if load_seg:
        np.testing.assert_array_equal(got.depths, want.depths)
        assert set(np.unique(got.segs)) == {0, 1}


def test_intrinsics_match_jax():
    from super_tpu.geometry.camera import Intrinsics as JIntrinsics

    for name in ("superv1", "superv2"):
        want = getattr(JIntrinsics, name)()
        got = getattr(Intrinsics, name)(device="cpu")
        for f in ("fx", "fy", "cx", "cy"):
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == torch.float32
            assert np.float32(g.item()) == np.asarray(w, np.float32), (name, f)
    k = np.array([[883.0, 0, 445.06, 0], [0, 883.0, 190.24, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    assert Intrinsics.from_matrix(k, device="cpu") == \
        Intrinsics.superv1(device="cpu")


def test_run_semantic_super_synthetic(tmp_path):
    out = tmp_path / "m.json"
    assert run_semantic_super.main([
        "--synthetic", "--cpu", "--num_frames", "2", "--height", "48",
        "--width", "64", "--mesh_step_size", "8",
        "--output_json", str(out)]) == 0
    m = json.load(open(out))
    assert m["num_eval_frames"] == 2
    for k in ("reproj_mean", "num_surfels", "p50_frame_ms"):
        assert np.isfinite(m[k]), (k, m)
    assert m["num_surfels"] > 0


def test_run_semantic_super_on_seg_dir(v1_dir, tmp_path):
    """The semantic CLI on the directory's frames and label PNGs (the
    Python decoder's path, ``load_seg``)."""
    out = tmp_path / "m.json"
    assert run_semantic_super.main([
        "--data_dir", str(v1_dir), "--cpu", "--height", str(H), "--width",
        str(W), "--mesh_step_size", "10", "--start_id", str(START),
        "--end_id", str(START + 2), "--num_optimize_iterations", "3",
        "--tracking_gt_file", "left_pts.npy",
        "--output_json", str(out)]) == 0
    m = json.load(open(out))
    assert m["loader"] == tsuperv1.python_decoder()
    assert m["num_eval_frames"] == 2 and m["num_surfels"] > 0
    assert np.isfinite(m["reproj_mean"])


@pytest.mark.parametrize("cli", [run_super, run_semantic_super])
def test_cli_needs_a_card_or_cpu(cli, monkeypatch):
    """Without --cpu and with no CUDA device an entry point exits with a
    message (non-zero), before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--synthetic", "--num_frames", "2", "--height", "48",
                  "--width", "64"])
    assert e.value.code not in (0, None)
