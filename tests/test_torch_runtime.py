"""The port's copy of the native frame loader (tests/test_runtime.py's
twins), the three decoders against each other, and the PNG codec of
super_tpu_torch/data/png.py against PIL.

The native tests need ``g++`` and libpng's headers; where they are
missing the tests skip, as tests/test_runtime.py's do."""

import numpy as np
import pytest
from PIL import Image

from super_tpu_torch.core.preprocess import disp_to_depth
from super_tpu_torch.data.png import read_png, write_png
from super_tpu_torch.data.superv1 import load_image
from super_tpu_torch.runtime import (
    NativeSequenceLoader,
    native_available,
    native_toolchain,
)

FILTERS = ("none", "sub", "up", "average", "paeth")
# PIL mode -> (channels, dtype) of the array it saves.
MODES = {"L": (1, np.uint8), "LA": (2, np.uint8), "RGB": (3, np.uint8),
         "RGBA": (4, np.uint8), "I;16": (1, np.uint16)}


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    h, w, n = 24, 32, 5
    disps, rgbs = [], []
    for i in range(n):
        disp = rng.uniform(0.1, 0.9, size=(h, w)).astype(np.float32)
        np.save(d / f"{i:06d}.npy", disp)
        rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(d / f"{i:06d}-left.png")
        disps.append(disp)
        rgbs.append(rgb)
    return d, h, w, n, disps, rgbs


def _need_native():
    if not native_available():
        pytest.skip(f"no native toolchain ({native_toolchain()})")


def test_native_loader_roundtrip(seq_dir):
    _need_native()
    d, h, w, n, disps, rgbs = seq_dir
    depth_paths = [str(d / f"{i:06d}.npy") for i in range(n)]
    rgb_paths = [str(d / f"{i:06d}-left.png") for i in range(n)]
    got = []
    with NativeSequenceLoader(depth_paths, rgb_paths, h, w,
                              min_depth=0.1, max_depth=80.0) as ld:
        for idx, depth, rgb in ld:
            got.append(idx)
            min_d, max_d = 1 / 80.0, 1 / 0.1
            expect = 1.0 / (min_d + (max_d - min_d) * disps[idx])
            np.testing.assert_allclose(depth, expect, rtol=1e-5)
            np.testing.assert_allclose(
                rgb, rgbs[idx].transpose(2, 0, 1) / 255.0, atol=1e-6)
    assert got == list(range(n))  # strictly in order


def test_native_loader_handles_missing_file(seq_dir):
    _need_native()
    d, h, w, n, disps, rgbs = seq_dir
    depth_paths = [str(d / f"{i:06d}.npy") for i in range(2)]
    rgb_paths = [str(d / "nope.png"), str(d / "000001-left.png")]
    with NativeSequenceLoader(depth_paths, rgb_paths, h, w) as ld:
        idxs = [i for i, _, _ in ld]
    assert idxs == [1]  # frame 0 skipped (decode failure), order preserved


def test_decoders_agree(seq_dir):
    """The native loader, PIL and the numpy codec give the same RGB bit
    for bit; the native depth is disp_to_depth's to float32 rounding."""
    _need_native()
    d, h, w, n, disps, rgbs = seq_dir
    with NativeSequenceLoader([str(d / f"{i:06d}.npy") for i in range(n)],
                              [str(d / f"{i:06d}-left.png")
                               for i in range(n)], h, w) as ld:
        for idx, depth, rgb in ld:
            path = d / f"{idx:06d}-left.png"
            pil, own = load_image(path, "pil"), load_image(path, "zlib")
            assert pil.dtype == own.dtype == np.float32
            np.testing.assert_array_equal(own, pil)
            np.testing.assert_array_equal(rgb.transpose(1, 2, 0), pil)
            _, want = disp_to_depth(disps[idx], 0.1, 80.0)
            np.testing.assert_allclose(depth, want, rtol=2e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_matches_pil_writer(tmp_path, mode):
    """PNGs that PIL writes (its own row filters) read as PIL reads them."""
    ch, dt = MODES[mode]
    rng = np.random.default_rng(len(mode))
    # A smooth ramp plus noise, so PIL's adaptive filters vary by row.
    ramp = np.add.outer(np.arange(37), np.arange(45)) * 3
    img = (ramp[..., None] * np.arange(1, ch + 1)
           + rng.integers(0, 9, (37, 45, ch))) % (np.iinfo(dt).max + 1)
    img = img.astype(dt)[..., 0] if ch == 1 else img.astype(dt)
    path = tmp_path / "a.png"
    im = Image.fromarray(img)
    assert im.mode == mode
    im.save(path)
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("filter_type", FILTERS)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_filter_roundtrip(tmp_path, filter_type, channels):
    """Every row filter, written by write_png: read_png and PIL read back
    the image written."""
    rng = np.random.default_rng(channels)
    shape = (19, 23) if channels == 1 else (19, 23, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "b.png"
    write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_16bit_roundtrip(tmp_path):
    img = np.random.default_rng(5).integers(0, 1 << 16, (11, 13),
                                            dtype=np.uint16)
    path = tmp_path / "c.png"
    write_png(path, img, filter_type="paeth")
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4), np.uint8), mode="L").convert(
        "P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(path)
