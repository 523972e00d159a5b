"""ctypes bindings of the native frame loader (a copy of the JAX package's
super_tpu/runtime/loader.py).

A C++ thread pool (frame_loader.cpp) decodes .npy disparity and .png RGB
frames ahead of the tracker, in order.  The library is built with ``g++``
and libpng at first use into ``build/runtime/`` at the root of the
checkout, named by a hash of the source and the build script
(kernels/build.py's scheme), so an edited source never loads a stale
library.

Nothing here falls back silently: :func:`native_available` is False only
where the machine lacks the toolchain (``g++`` or libpng's ``png.h``,
:func:`native_toolchain` says which), and a build that fails where the
toolchain exists raises.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from super_tpu_torch.kernels.build import (
    BUILD_DIR,
    compile_library,
    hashed_library,
)

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "frame_loader.cpp"
_SCRIPT = _DIR / "build.sh"
RUNTIME_DIR = BUILD_DIR.parent / "runtime"

_lib = None


def library_path() -> Path:
    return hashed_library(RUNTIME_DIR, "libsuper_runtime",
                          _SOURCE.read_bytes(), _SCRIPT.read_bytes())


def native_toolchain() -> Optional[str]:
    """None where the loader can be built here, else what is missing."""
    if shutil.which("g++") is None:
        return "no g++"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", "/dev/null"],
                           input="#include <png.h>\n", capture_output=True,
                           text=True)
    if probe.returncode != 0:
        return "no png.h (libpng headers)"
    return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        compile_library(["sh", str(_SCRIPT)], path)
    lib = ctypes.CDLL(str(path))
    lib.sr_open_sequence.restype = ctypes.c_void_p
    lib.sr_open_sequence.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    lib.sr_next.restype = ctypes.c_int
    lib.sr_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float)]
    lib.sr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """True once the library is built and loaded; False where the machine
    lacks the toolchain (then a library built elsewhere is not loaded
    either).  Raises if the build fails."""
    if _lib is None and native_toolchain() is not None:
        return False
    _load()
    return True


class NativeSequenceLoader:
    """In-order prefetching loader over (depth .npy, rgb .png) file pairs.

    Usage:
      with NativeSequenceLoader(depth_paths, rgb_paths, h, w) as ld:
          for idx, depth, rgb in ld:   # depth (H, W); rgb (3, H, W) in [0,1]
              ...

    A frame that fails to decode is skipped (its index never comes out).
    """

    def __init__(self, depth_paths: List[Optional[str]],
                 rgb_paths: List[Optional[str]], height: int, width: int,
                 workers: int = 3, min_depth: float = 0.1,
                 max_depth: float = 80.0, disp_to_depth: bool = True,
                 lookahead: int = 8):
        lib = _load()
        self._lib = lib
        self._n = len(depth_paths)
        self._h, self._w = height, width
        enc = lambda p: p.encode() if p else None  # noqa: E731
        self._dp = (ctypes.c_char_p * self._n)(*[enc(p) for p in depth_paths])
        self._rp = (ctypes.c_char_p * self._n)(*[enc(p) for p in rgb_paths])
        self._handle = lib.sr_open_sequence(
            self._dp, self._rp, self._n, height, width, workers,
            min_depth, max_depth, 1 if disp_to_depth else 0, lookahead)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        depth = np.empty((self._h, self._w), dtype=np.float32)
        rgb = np.empty((3, self._h, self._w), dtype=np.float32)
        while True:
            idx = self._lib.sr_next(
                self._handle,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if idx == -1:
                return
            if idx == -2:
                continue  # decode failure: the caller sees the index missing
            yield idx, depth.copy(), rgb.copy()

    def close(self):
        if self._handle:
            self._lib.sr_close(self._handle)
            self._handle = None
