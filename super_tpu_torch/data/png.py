"""A small PNG codec on the standard library's zlib and numpy.

Reads and writes 8- and 16-bit, non-interlaced grey, grey + alpha, RGB
and RGBA images with any of the five row filters, which covers what the
SuPer trials and their segmentations hold.  The frame loader uses it where
PIL is absent (data/superv1.py); palette and interlaced images raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + n


def _unfilter_rows(raw, bpp):
    """Undo the none, sub and up filters of (H, 1 + S) rows, a row at a
    time (each needs only the row above)."""
    h, w = raw.shape[0], (raw.shape[1] - 1) // bpp
    out = np.zeros((h + 1, raw.shape[1] - 1), np.uint8)  # row 0: above row 1
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 1:
            line = np.cumsum(line.reshape(w, bpp), axis=0,
                             dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            line = line + out[y]
        out[y + 1] = line
    return out[1:]


def _unfilter_diagonals(raw, bpp):
    """Undo any of the five filters of (H, 1 + S) rows.  A pixel needs its
    left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal (y + x = d) are independent: they are unfiltered together,
    d by d, in a skewed copy where each diagonal is contiguous."""
    h = raw.shape[0]
    x = raw[:, 1:].reshape(h, -1, bpp).astype(np.int16)
    w = x.shape[1]
    n = h + w - 1
    xs = np.zeros((n, h, bpp), np.int16)         # xs[d, y] = x[y, d - y]
    for y in range(h):
        xs[y:y + w, y] = x[y]
    s = np.zeros((n + 2, h + 1, bpp), np.int16)  # s[d + 2, y + 1] = out[y, d - y]
    kind = [np.broadcast_to((raw[:, :1] == k), (h, bpp)) for k in (1, 2, 3, 4)]
    for d in range(n):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a = s[d + 1, lo + 1:hi + 1]              # left
        b = s[d + 1, lo:hi]                      # up
        c = s[d, lo:hi]                          # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([k[lo:hi] for k in kind],
                         [a, b, (a + b) >> 1, paeth], 0)
        s[d + 2, lo + 1:hi + 1] = (xs[d, lo:hi] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = s[y + 2:y + 2 + w, y + 1]
    return out.reshape(h, -1)


def read_png(path) -> np.ndarray:
    """The image as uint8 (or uint16) (H, W) for grey, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, "
                         f"want {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: filter type {raw[:, 0].max()}")
    if raw[:, 0].max(initial=0) <= 2:
        img = _unfilter_rows(raw, bpp)
    else:
        img = _unfilter_diagonals(raw, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _filter_rows(img: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row of the (H, stride) byte image with ``ftype``."""
    x = img.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, image, filter_type: str = "up") -> None:
    """Write a uint8 or uint16 (H, W) grey or (H, W, C) image, C in 1..4
    (grey, grey + alpha, RGB, RGBA), every row with ``filter_type`` (one
    of none, sub, up, average, paeth)."""
    img = np.asarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"dtype {img.dtype}: want uint8 or uint16")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    ftype = _FILTERS.index(filter_type)
    body = np.concatenate([np.full((h, 1), ftype, np.uint8),
                           _filter_rows(rows, ch * img.dtype.itemsize,
                                        ftype)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body.tobytes()))
                + chunk(b"IEND", b""))
