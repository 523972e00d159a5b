"""Pair-sparse block-Jacobi PCG: kernel K1 and its plain version.

Replaces super_tpu/pallas_kernels/pcg.py (``_pairs_cg_kernel`` behind
``pairs_cg_pallas``).  The CUDA source, with its bound and design, is
super_tpu_torch/csrc/pairs_cg.cu: one thread block runs every iteration with
the vectors in shared memory, pair lists built once per solve, no float
atomics.

:func:`pairs_cg` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

# Shared memory one thread block may use on Hopper (bytes).
_SMEM_MAX = 232448


def pairs_cg_plain(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u, x0_fm=None,
                   *, iterations: int = 32):
    """The recurrence of the JAX package's ``_pairs_cg_ref`` on (8, J)
    node-major vectors (row 7 zero); returns the (7, J) solution."""
    j = b_fm.shape[1]
    dev, f32 = b_fm.device, torch.float32

    def pad8(v):
        out = torch.zeros((8, j), dtype=f32, device=dev)
        if v is not None:
            out[:7] = v
        return out

    def band_mv(band, v):
        acc = band[0:8] * v
        for d in range(1, 8):
            acc = acc + band[8 * d:8 * d + 8] * torch.roll(v, -d, dims=0)
        return acc

    n1, n2 = n1.long(), n2.long()
    valid1 = (n1 >= 0) & (n1 < j)
    valid2 = (n2 >= 0) & (n2 < j)
    c1 = torch.where(valid1, n1, 0)
    c2 = torch.where(valid2, n2, 0)
    s1 = torch.where(valid1, n1, j)
    s2 = torch.where(valid2, n2, j)

    def gather(p, c, valid):
        return torch.where(valid[None, :], p[:, c], 0.0)

    def scatter(t, s):
        return torch.zeros((8, j + 1), dtype=f32, device=dev).index_add_(
            1, s, t)[:, :j]

    def matvec(p):
        ap = scatter(band_mv(blk_pad, gather(p, c2, valid2)), s1)
        return ap + scatter(band_mv(blkt_pad, gather(p, c1, valid1)),
                            s2) + u * p

    b8 = pad8(b_fm)
    x = pad8(x0_fm)
    r = b8 - matvec(x)
    z = band_mv(minv_pad, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iterations):
        ap = matvec(p)
        pap = torch.sum(p * ap)
        alpha = torch.where(torch.abs(pap) > 1e-30, rz / pap, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = band_mv(minv_pad, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x[:7]


def pairs_cg(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u, x0_fm=None, *,
             iterations: int = 32):
    """Block-Jacobi PCG on the pair-sparse system (kernel K1).

    blk_pad, blkt_pad: (64, P) f32 band tables of the pair blocks and their
    transposes; n1, n2: (P,) int32 node ids (outside [0, J): sink);
    minv_pad: (64, J) f32 band table of the block-Jacobi inverse; b_fm,
    x0_fm: (7, J) f32; u: () f32 damping.  Returns the (7, J) solution.
    """
    if b_fm.device.type == "cpu":
        return pairs_cg_plain(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                              x0_fm, iterations=iterations)
    if b_fm.device.type != "cuda":
        raise ValueError(f"pairs_cg: unsupported device {b_fm.device}")
    j = b_fm.shape[1]
    p = blk_pad.shape[1]
    dev = b_fm.device
    if x0_fm is None:
        x0_fm = torch.zeros_like(b_fm)
    u = torch.as_tensor(u, dtype=torch.float32, device=dev).reshape(())
    floats = dict(blk_pad=(blk_pad, (64, p)), blkt_pad=(blkt_pad, (64, p)),
                  minv_pad=(minv_pad, (64, j)), b_fm=(b_fm, (7, j)),
                  x0_fm=(x0_fm, (7, j)), u=(u, ()))
    for name, (t, shape) in floats.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != dev:
            raise ValueError(f"pairs_cg: {name} must be f32 {shape} on {dev},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("n1", n1), ("n2", n2)):
        if tuple(t.shape) != (p,) or t.dtype != torch.int32 or \
                t.device != dev:
            raise ValueError(f"pairs_cg: {name} must be int32 ({p},) on {dev}")

    from super_tpu_torch.kernels.build import load

    lib = load("pairs_cg")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pairs_cg_smem_bytes.argtypes = [ci, ci]
    lib.pairs_cg_smem_bytes.restype = ctypes.c_longlong
    smem = lib.pairs_cg_smem_bytes(j, p)
    if smem > _SMEM_MAX:
        raise ValueError(f"pairs_cg: J={j}, P={p} needs {smem} B of shared "
                         f"memory (> {_SMEM_MAX}); the chunked solver for "
                         "dense graphs is not ported")
    lib.pairs_cg_launch.argtypes = [vp] * 10 + [ci] * 3 + [vp]
    lib.pairs_cg_launch.restype = ci
    args = [t.contiguous() for t in (blk_pad, blkt_pad, n1, n2, minv_pad,
                                     b_fm, x0_fm, u)]
    x = torch.empty((7, j), dtype=torch.float32, device=dev)
    # Scratch and the contiguous copies may be freed on return while the
    # kernel still runs: the caching allocator hands their memory only to
    # work queued after it on this stream.
    scratch = torch.empty((2, 7, p), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pairs_cg_launch(*(t.data_ptr() for t in args), x.data_ptr(),
                             scratch.data_ptr(), j, p, iterations, stream)
    if rc != 0:
        raise RuntimeError(f"pairs_cg launch failed: cudaError {rc}")
    pairs_cg.launches += 1
    return x


pairs_cg.launches = 0
