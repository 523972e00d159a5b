"""The port's stereo training data (data/stereo.py, a numpy and PIL copy)
against the JAX package's: tests/test_stereo_data.py's checks on the
port's readers, index and batcher over miniature dataset trees, and one
seed giving both packages' batchers bitwise the same batches."""

import numpy as np
import pytest

from super_tpu.data import stereo as jstereo
from super_tpu_torch.data.stereo import (
    StereoIndex,
    build_index,
    fetch_training_index,
    iter_batches,
    read_disparity,
    read_pfm,
)


def _write_pfm(path, arr, little=True):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n" if little else b"1.0\n")
        f.write(arr[::-1].astype("<f4" if little else ">f4").tobytes())


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


@pytest.fixture()
def sceneflow_root(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "FlyingThings3D" / "frames_cleanpass"
    for scene in ("A/0001", "A/0002"):
        for side in ("left", "right"):
            d = root / scene / side
            d.mkdir(parents=True)
            for t in range(2):
                img = rng.integers(0, 255, (40, 64, 3), dtype=np.uint8)
                _write_png(d / f"{t:04d}.png", img)
        dd = tmp_path / "FlyingThings3D" / "disparity" / scene / "left"
        dd.mkdir(parents=True)
        for t in range(2):
            disp = rng.uniform(1.0, 30.0, (40, 64)).astype(np.float32)
            _write_pfm(dd / f"{t:04d}.pfm", disp)
    return str(root)


@pytest.mark.parametrize("little", [True, False])
def test_pfm_roundtrip(tmp_path, little):
    """PFM rows are stored bottom-up; the sign of the scale gives the
    byte order (negative: little-endian)."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) * 0.5
    _write_pfm(tmp_path / "x.pfm", arr, little)
    got = read_pfm(str(tmp_path / "x.pfm"))
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jstereo.read_pfm(str(tmp_path /
                                                            "x.pfm")))
    d, valid = read_disparity(str(tmp_path / "x.pfm"))
    assert valid.all()
    np.testing.assert_array_equal(d, arr)


def test_build_index_sceneflow(sceneflow_root):
    idx = build_index("sceneflow", sceneflow_root)
    assert len(idx) == 4
    assert all("/left/" in p for p in idx.left)
    assert all("/right/" in p for p in idx.right)
    assert all(p.endswith(".pfm") for p in idx.disp)
    assert not idx.sparse
    assert tuple(idx) == tuple(jstereo.build_index("sceneflow",
                                                   sceneflow_root))


def test_fetch_training_index_mixes_and_repeats(sceneflow_root):
    idx = fetch_training_index([("sceneflow", sceneflow_root, 3)])
    assert len(idx) == 12
    with pytest.raises(ValueError):
        fetch_training_index([("kitti", "/nonexistent", 1)])


def test_iter_batches_fixed_shapes(sceneflow_root):
    idx = build_index("sceneflow", sceneflow_root)
    batches = list(iter_batches(idx, batch_size=2, crop=(48, 48),
                                rng=np.random.default_rng(1), steps=3))
    assert len(batches) == 3
    for b in batches:
        assert b.img1.shape == (2, 3, 48, 48)
        assert b.img2.shape == (2, 3, 48, 48)
        assert b.flow.shape == (2, 1, 48, 48)
        assert b.valid.shape == (2, 48, 48)
        assert (b.flow[b.valid[:, None] > 0] <= 0).all()
        assert b.img1.dtype == np.float32
        assert (b.valid[:, -1, :] == 0).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_same_seed_same_batches(sceneflow_root, seed):
    """Both packages' batchers from one seed, crops inside and past the
    images, with the photometric jitter: bitwise equal batches."""
    idx = build_index("sceneflow", sceneflow_root)
    for crop in ((32, 40), (48, 48)):
        want = list(jstereo.iter_batches(
            jstereo.StereoIndex(*idx), batch_size=2, crop=crop,
            rng=np.random.default_rng(seed), steps=3))
        got = list(iter_batches(idx, batch_size=2, crop=crop,
                                rng=np.random.default_rng(seed), steps=3))
        assert len(got) == len(want) == 3
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)


def test_disp_png16(tmp_path):
    """16-bit PNG disparity / 256, zero invalid."""
    from PIL import Image

    raw = np.zeros((8, 8), np.uint16)
    raw[2, 3] = 512
    Image.fromarray(raw).save(tmp_path / "d.png")
    d, valid = read_disparity(str(tmp_path / "d.png"))
    assert d[2, 3] == pytest.approx(2.0)
    assert valid.sum() == 1


def test_disp_sintel_rgb(tmp_path):
    """Sintel's RGB packing, d = 4 R + G / 64 + B / 16384, as the JAX
    package reads it."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    rgb[0, 0] = 0
    _write_png(tmp_path / "s.png", rgb)
    d, valid = read_disparity(str(tmp_path / "s.png"))
    wd, wvalid = jstereo.read_disparity(str(tmp_path / "s.png"))
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(valid, wvalid)
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    np.testing.assert_array_equal(d, r * 4.0 + g / 64.0 + b / 16384.0)
    assert not valid[0, 0]


def test_index_add():
    a = StereoIndex(["l1"], ["r1"], ["d1"], sparse=False)
    b = StereoIndex(["l2"], ["r2"], ["d2"], sparse=True)
    c = a + b
    assert len(c) == 2 and c.sparse
