"""Build and load the port's CUDA kernels.

Each ``super_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, which ``ctypes``
loads.  Nothing is built at import: the first launch builds its library, and
:func:`build` starts several compilers at once.  Libraries go to ``build/``
at the root of the checkout, named by a hash of the source and the flags, so
an edited source never loads a stale binary.  Each compiler writes a file of
its own process's name and renames it into place when it succeeds, so
processes that build the same library at once never load a partial one
(:func:`compile_library` does the same for the host runtime's ``g++``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def hashed_library(directory: Path, stem: str, *inputs: bytes) -> Path:
    """``directory/<stem>-<hash>.so``, the hash over ``inputs`` (the
    sources and the flags that build the library)."""
    tag = hashlib.sha256(b"".join(inputs)).hexdigest()
    return directory / f"{stem}-{tag[:16]}.so"


def library_path(name: str) -> Path:
    return hashed_library(BUILD_DIR, name, (CSRC / f"{name}.cu").read_bytes(),
                          " ".join(NVCC_FLAGS).encode())


def _start(cmd, out: Path):
    """Start ``cmd`` with the output path of this process appended."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([*cmd, str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(proc, tmp: Path, out: Path):
    """(exit code, compiler output); the library renamed into place when
    the compiler succeeded."""
    log, _ = proc.communicate()
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc.returncode, log


def compile_library(cmd, out: Path) -> str:
    """Run ``cmd + [output path]`` to build ``out`` (see the module
    docstring); returns the compiler's output, raises if it fails."""
    rc, log = _finish(*_start(cmd, out), out)
    if rc != 0:
        raise RuntimeError(f"build of {out.name} failed (exit {rc}):\n{log}")
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, all at once.

    Returns each compiled kernel's compiler output (``-Xptxas -v`` reports
    registers and shared memory); raises if any compile fails.
    """
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu"), "-o"]
        procs[name] = (*_start(cmd, out), out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        rc, logs[name] = _finish(proc, tmp, out)
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
