"""SuPer / Semantic-SuPer trial data on disk, read on the host into numpy
(counterpart of super_tpu/data/superv1.py).

A trial directory holds per frame the left RGB image
(``rgb/%06d-left.png``), the precomputed sigmoid disparity
(``depth/%06d.npy`` or ``.png``, turned into depth by ``disp_to_depth``),
optionally a segmentation (``seg/%06d-left.npy`` class confidences or
``.png`` labels), and the tracking-GT bundle (a pickled dict of ``gt`` /
``super_cpp`` / ``SURF`` trajectories keyed '000010', ...).

Three decoders read the frames, and ``LoadedSequence.loader`` names the one
that ran: ``"native"``, the C++ loader of super_tpu_torch/runtime (.npy
disparity with .png RGB, no segmentation), where the machine can build it;
else ``"pil"`` where PIL is installed, else ``"zlib"``, the numpy codec of
data/png.py.  RGB frames come out bitwise equal from all three; depths
agree to float32 rounding (the native loader forms ``disp_to_depth`` in
float32 constants).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from super_tpu_torch.config import SuPerConfig
from super_tpu_torch.core.preprocess import disp_to_depth
from super_tpu_torch.data.png import read_png
from super_tpu_torch.geometry.camera import Intrinsics


class LoadedSequence(NamedTuple):
    depths: np.ndarray
    colors: np.ndarray
    gt_xy: Optional[np.ndarray]
    gt_valid: Optional[np.ndarray]
    segs: Optional[np.ndarray]
    seg_confs: Optional[np.ndarray]
    frame_ids: np.ndarray
    loader: str                 # "native", "pil" or "zlib"


def load_gt(data_dir: str, gt_file: str):
    """Load the tracking GT bundle; returns ({frame_id: (P, 3)}, full dict).
    The bundle is a pickle: read only files of a trial you trust."""
    path = os.path.join(os.path.expanduser(data_dir), gt_file)
    bundle = np.array(np.load(path, allow_pickle=True)).tolist()
    gt = {int(k): np.asarray(v) for k, v in bundle["gt"].items()}
    return gt, bundle


def python_decoder() -> str:
    """The decoder of the Python path: ``"pil"`` where PIL is installed,
    else ``"zlib"``."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "zlib"
    return "pil"


def _read(path, decoder):
    """A PNG as numpy, as ``np.asarray(Image.open(path))`` gives it."""
    if decoder == "pil":
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
    return read_png(path)


def load_image(path, decoder: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1] (grey replicated, alpha dropped)."""
    if decoder == "pil":
        from PIL import Image

        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), dtype=np.float32)
        return rgb / 255.0
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit colour image")
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :1].repeat(3, -1) if img.shape[-1] <= 2 else img[..., :3]
    return np.asarray(img, dtype=np.float32) / 255.0


def _load_disp(path, ext, decoder):
    if ext == ".png":
        return np.asarray(_read(path, decoder), dtype=np.float32)
    return np.load(path).astype(np.float32)


def load_sequence(cfg: SuPerConfig, args, device="cuda") -> tuple:
    """Frames [start_id, end_id) of a SuPer-layout directory:
    (Intrinsics on ``device``, LoadedSequence).  ``args`` carries the CLI's
    data_dir, rgb_dir, depth_dir, seg_dir, start_id, end_id, depth_ext,
    img_ext and tracking_gt_file."""
    from super_tpu_torch.runtime import NativeSequenceLoader, native_available

    data_dir = os.path.expanduser(args.data_dir)
    pairs = []
    for fid in range(args.start_id, args.end_id):
        name = f"{fid:06d}"
        rgb_path = os.path.join(data_dir, args.rgb_dir,
                                f"{name}-left{args.img_ext}")
        dep_path = os.path.join(data_dir, args.depth_dir,
                                f"{name}{args.depth_ext}")
        if os.path.exists(rgb_path) and os.path.exists(dep_path):
            pairs.append((fid, dep_path, rgb_path))

    depths, colors, segs, seg_confs, ids = [], [], [], [], []
    if pairs and args.depth_ext == ".npy" and args.img_ext == ".png" \
            and not cfg.load_seg and native_available():
        with NativeSequenceLoader(
                [p[1] for p in pairs], [p[2] for p in pairs], cfg.height,
                cfg.width, min_depth=cfg.min_depth,
                max_depth=cfg.max_depth) as ld:
            for i, depth, rgb in ld:
                depths.append(depth)
                colors.append(rgb.transpose(1, 2, 0))
                ids.append(pairs[i][0])
        if len(ids) != len(pairs):
            lost = sorted({p[0] for p in pairs} - set(ids))
            raise RuntimeError(f"native loader could not decode frames {lost} "
                               f"under {data_dir}")
        return _finish(cfg, args, data_dir, depths, colors, segs, seg_confs,
                       ids, "native", device)

    decoder = python_decoder()
    for fid, dep_path, rgb_path in pairs:
        name = f"{fid:06d}"
        colors.append(load_image(rgb_path, decoder))
        disp = _load_disp(dep_path, args.depth_ext, decoder)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        depths.append(np.asarray(depth).squeeze())
        ids.append(fid)
        if cfg.load_seg:
            base = os.path.join(data_dir, args.seg_dir, f"{name}-left")
            if os.path.exists(base + ".npy"):
                # Per-class confidences; the label is their argmax.
                conf = np.load(base + ".npy").astype(np.float32)  # (C, H, W)
                seg_confs.append(conf)
                segs.append(conf.argmax(0).astype(np.int32))
            elif os.path.exists(base + ".png"):
                # Integer labels; the confidences are one-hot.
                lab = _read(base + ".png", decoder)
                if lab.ndim == 3:
                    lab = lab[..., 0]
                lab = lab.astype(np.int32)
                conf = np.zeros((cfg.num_classes,) + lab.shape, np.float32)
                np.put_along_axis(conf, lab[None], 1.0, axis=0)
                seg_confs.append(conf)
                segs.append(lab)
    return _finish(cfg, args, data_dir, depths, colors, segs, seg_confs, ids,
                   decoder, device)


def _finish(cfg, args, data_dir, depths, colors, segs, seg_confs, ids,
            loader, device):
    if not depths:
        raise FileNotFoundError(f"no frames found under {data_dir}")

    gt_xy = gt_valid = None
    if args.tracking_gt_file:
        gt, _ = load_gt(data_dir, args.tracking_gt_file)
        num_track = next(iter(gt.values())).shape[0]
        gt_xy = np.zeros((len(ids), num_track, 2), dtype=np.float32)
        gt_valid = np.zeros((len(ids), num_track), dtype=bool)
        for i, fid in enumerate(ids):
            if fid in gt:
                gt_xy[i] = gt[fid][:, 0:2]
                gt_valid[i] = gt[fid][:, 2] == 1

    intr = (Intrinsics.superv1(device) if cfg.data == "superv1"
            else Intrinsics.superv2(device))
    return intr, LoadedSequence(
        depths=np.stack(depths),
        colors=np.stack(colors),
        gt_xy=gt_xy,
        gt_valid=gt_valid,
        segs=np.stack(segs) if segs else None,
        seg_confs=np.stack(seg_confs) if seg_confs else None,
        frame_ids=np.asarray(ids),
        loader=loader,
    )
