"""The CG solves of the LM step: kernels K1, K1b and K3 and their plain
versions.

Replaces super_tpu/pallas_kernels/pcg.py:

- K1, ``_pairs_cg_kernel`` behind ``pairs_cg_pallas``: block-Jacobi PCG on
  the pair-sparse normal equations (csrc/pairs_cg.cu);
- K1b, ``_pairs_cg_kernel_chunked``, which ``pairs_cg_pallas`` takes for
  dense ED graphs: the same recurrence with the pair blocks rounded to bf16
  (the same source, instantiated for bf16 blocks);
- K3, ``_pcg_kernel`` behind ``pcg_pallas``: plain CG on a dense,
  block-preconditioned matrix (csrc/dense_cg.cu).

Each CUDA source states its bound and design.  :func:`pairs_cg` picks K1 or
K1b by the JAX package's own test on the shapes (:func:`uses_chunked`).  A
wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Shared memory one thread block may use on Hopper (bytes).
_SMEM_MAX = 232448
# K1 and K1b take J and P below this (csrc/pairs_cg.cu: 32-bit entry codes).
_PAIR_LIMIT = 1 << 24
# Pair tables whose two (jp, P) f32 one-hot matrices would pass this many
# bytes take K1b, as in the JAX package (pcg.py:_PAIRS_PERSISTENT_OH_MAX);
# tests may lower it.
_PAIRS_PERSISTENT_OH_MAX = 24 * 1024 * 1024


def uses_chunked(j: int, p: int) -> bool:
    """Whether a pair system of J nodes and P pairs takes K1b: the JAX
    package's test ``2 * jp * P * 4 > _PAIRS_PERSISTENT_OH_MAX`` with J
    rounded up to a multiple of 128."""
    jp = -(-j // 128) * 128
    return 2 * jp * p * 4 > _PAIRS_PERSISTENT_OH_MAX


def _check_pair_args(name, blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                     x0_fm):
    """Device, type and shape checks of K1's and K1b's arguments; returns
    the damping as a () f32 tensor on the device."""
    j = b_fm.shape[1]
    p = blk_pad.shape[1]
    dev = b_fm.device
    u = torch.as_tensor(u, dtype=torch.float32, device=dev).reshape(())
    floats = dict(blk_pad=(blk_pad, (64, p)), blkt_pad=(blkt_pad, (64, p)),
                  minv_pad=(minv_pad, (64, j)), b_fm=(b_fm, (7, j)),
                  x0_fm=(x0_fm, (7, j)), u=(u, ()))
    for arg, (t, shape) in floats.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != dev:
            raise ValueError(f"{name}: {arg} must be f32 {shape} on {dev},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    for arg, t in (("n1", n1), ("n2", n2)):
        if tuple(t.shape) != (p,) or t.dtype != torch.int32 or \
                t.device != dev:
            raise ValueError(f"{name}: {arg} must be int32 ({p},) on {dev}")
    return u


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


@functools.cache
def _pair_lib():
    """csrc/pairs_cg.cu's library, built on first use, its C signatures
    declared once."""
    from super_tpu_torch.kernels.build import load

    lib = load("pairs_cg")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, args, res in (
            (lib.pairs_cg_blocks, [], ci),
            (lib.pairs_cg_capacity, [ci, ci, ci], ci),
            (lib.pairs_cg_float_scratch, [ci], cll),
            (lib.pairs_cg_int_scratch, [ci, ci], cll),
            (lib.pairs_cg_launch, [vp] * 11 + [ci] * 4 + [vp], ci)):
        fn.argtypes, fn.restype = args, res
    return lib


@functools.cache
def _pair_sizes(chunked: bool, j: int, p: int):
    """(capacity, float scratch, int scratch, CTAs) of K1 (``chunked``
    false) or K1b at J nodes and P pairs, asked of the library once."""
    lib = _pair_lib()
    return (lib.pairs_cg_capacity(j, p, int(chunked)),
            lib.pairs_cg_float_scratch(j), lib.pairs_cg_int_scratch(j, p),
            lib.pairs_cg_blocks())


def pair_cg_capacity(chunked: bool, j: int, p: int) -> int:
    """List entries (pair blocks) one CTA of K1 (``chunked`` false) or K1b
    keeps in shared memory at J nodes and P pairs; the rest it reads from
    global memory.  Negative where the CTAs' node state would not fit."""
    return _pair_sizes(chunked, j, p)[0]


def _launch_pair_cg(kernel, chunked, blk_pad, blkt_pad, n1, n2, minv_pad,
                    b_fm, u, x0_fm, iterations, with_entries=False):
    """Check the arguments of K1 (``chunked`` false) or K1b and launch it
    from csrc/pairs_cg.cu on the current stream, one CTA per SM; counts the
    launch on ``kernel``.  Both take the f32 band tables; K1b rounds the
    pair blocks to bf16 in the kernel.  With ``with_entries`` also returns
    each CTA's count of list entries (a device tensor)."""
    name = kernel.__name__
    j = b_fm.shape[1]
    p = blk_pad.shape[1]
    dev = b_fm.device
    if x0_fm is None:
        x0_fm = torch.zeros_like(b_fm)
    u = _check_pair_args(name, blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                         x0_fm)
    if not (0 < j < _PAIR_LIMIT and p < _PAIR_LIMIT):
        raise ValueError(f"{name}: needs 0 < J and J, P < {_PAIR_LIMIT}, got "
                         f"J={j}, P={p}")
    capacity, n_float, n_int, ctas = _pair_sizes(chunked, j, p)
    if capacity < 0:
        raise ValueError(f"{name}: J={j}, P={p}: the node state of "
                         f"(2 P + J) / SMs nodes passes a CTA's shared memory")
    args = [t.contiguous() for t in (blk_pad, blkt_pad, n1, n2, minv_pad,
                                     b_fm, x0_fm, u)]
    x = torch.empty((7, j), dtype=torch.float32, device=dev)
    # Scratch and the contiguous copies may be freed on return while the
    # kernel still runs: the caching allocator hands their memory only to
    # work queued after it on this stream.
    f_scratch = torch.empty((n_float,), dtype=torch.float32, device=dev)
    i_scratch = torch.empty((n_int,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _pair_lib().pairs_cg_launch(
        *(t.data_ptr() for t in args), x.data_ptr(), f_scratch.data_ptr(),
        i_scratch.data_ptr(), j, p, iterations, int(chunked), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    kernel.launches += 1
    if with_entries:
        return x, i_scratch[n_int - ctas:]
    return x


def pair_cg_entries(chunked: bool, blk_pad, blkt_pad, n1, n2, minv_pad, b_fm,
                    u, x0_fm=None, *, iterations: int = 32):
    """Launch K1 (``chunked`` false) or K1b once on CUDA tensors, as
    :func:`pairs_cg` does; returns the solution and each CTA's count of
    list entries, one int32 per SM."""
    kernel = pairs_cg_chunked if chunked else pairs_cg
    return _launch_pair_cg(kernel, chunked, blk_pad, blkt_pad, n1, n2,
                           minv_pad, b_fm, u, x0_fm, iterations,
                           with_entries=True)


def pairs_cg(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u, x0_fm=None, *,
             iterations: int = 32):
    """Block-Jacobi PCG on the pair-sparse system: kernel K1, or K1b where
    :func:`uses_chunked` says so.

    blk_pad, blkt_pad: (64, P) f32 band tables of the pair blocks and their
    transposes; n1, n2: (P,) int32 node ids (outside [0, J): sink);
    minv_pad: (64, J) f32 band table of the block-Jacobi inverse; b_fm,
    x0_fm: (7, J) f32; u: () f32 damping.  Returns the (7, J) solution.
    """
    if uses_chunked(b_fm.shape[1], blk_pad.shape[1]):
        return pairs_cg_chunked(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                                x0_fm, iterations=iterations)
    if b_fm.device.type == "cpu":
        return pairs_cg_plain(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                              x0_fm, iterations=iterations)
    if b_fm.device.type != "cuda":
        raise ValueError(f"pairs_cg: unsupported device {b_fm.device}")
    return _launch_pair_cg(pairs_cg, False, blk_pad, blkt_pad, n1, n2,
                           minv_pad, b_fm, u, x0_fm, iterations)


pairs_cg.launches = 0


def _bf16(t):
    """Round to bf16 and back: the pair blocks as K1b reads them."""
    return t.to(torch.bfloat16).to(torch.float32)


def pairs_cg_chunked_plain(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                           x0_fm=None, *, iterations: int = 32):
    """K1b's arithmetic: the band tables of the pair blocks rounded to bf16
    (as ``pairs_cg_pallas`` rounds them for ``_pairs_cg_kernel_chunked``),
    then :func:`pairs_cg_plain`'s f32 recurrence."""
    return pairs_cg_plain(_bf16(blk_pad), _bf16(blkt_pad), n1, n2, minv_pad,
                          b_fm, u, x0_fm, iterations=iterations)


def pairs_cg_chunked(blk_pad, blkt_pad, n1, n2, minv_pad, b_fm, u,
                     x0_fm=None, *, iterations: int = 32):
    """Kernel K1b: :func:`pairs_cg` for dense ED graphs, same arguments.

    The kernel rounds the f32 band tables of the pair blocks to bf16 and
    computes in f32.  Raises for J or P of 2^24 or more, or 2 P + J past
    what the CTAs' shared memory holds (~160,000 on 132 SMs).
    """
    if b_fm.device.type == "cpu":
        return pairs_cg_chunked_plain(blk_pad, blkt_pad, n1, n2, minv_pad,
                                      b_fm, u, x0_fm, iterations=iterations)
    if b_fm.device.type != "cuda":
        raise ValueError(f"pairs_cg_chunked: unsupported device {b_fm.device}")
    return _launch_pair_cg(pairs_cg_chunked, True, blk_pad, blkt_pad, n1, n2,
                           minv_pad, b_fm, u, x0_fm, iterations)


pairs_cg_chunked.launches = 0

# pcg_pallas pads the dense system to a multiple of its row block (256).
_DENSE_PAD = 256


def dense_cg_plain(a, b, *, iterations: int = 32):
    """The JAX package's ``_pcg_ref``: CG from x0 = 0 on symmetric ``a``
    with the 1e-30 guards; ``p @ a`` is ``a p`` for symmetric ``a``."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rz = torch.sum(r * r)
    for _ in range(iterations):
        ap = p @ a
        pap = torch.sum(p * ap)
        alpha = torch.where(torch.abs(pap) > 1e-30, rz / pap, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.sum(r * r)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, 0.0)
        p = r + beta * p
        rz = rz_new
    return x


@functools.cache
def _dense_lib():
    """csrc/dense_cg.cu's library, built on first use, its C signatures
    declared once."""
    from super_tpu_torch.kernels.build import load

    lib = load("dense_cg")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args, res in (
            (lib.dense_cg_blocks, [], ci),
            (lib.dense_cg_smem_bytes, [ci], ctypes.c_longlong),
            (lib.dense_cg_chunk_capacity, [ci], ci),
            (lib.dense_cg_launch, [vp] * 5 + [ci] * 3 + [vp], ci)):
        fn.argtypes, fn.restype = args, res
    return lib


@functools.cache
def _dense_sizes(n: int):
    """(shared memory bytes before any chunk, chunk capacity, CTAs) of K3
    at dim n, asked of the library once."""
    lib = _dense_lib()
    return (lib.dense_cg_smem_bytes(n), lib.dense_cg_chunk_capacity(n),
            lib.dense_cg_blocks())


def dense_cg_capacity(n: int) -> int:
    """Chunks (16 bytes of a row) one CTA of K3 keeps in shared memory at
    dim n; its rows' other nonzero chunks are read on every iteration."""
    return _dense_sizes(n)[1]


def _launch_dense_cg(a, b, iterations, with_stats=False):
    """Check K3's arguments and launch it from csrc/dense_cg.cu on the
    current stream, one CTA per SM, at the system's own dim; counts the
    launch on :func:`dense_cg`.  With ``with_stats`` also returns each
    CTA's (chunks kept in shared memory, rows on the overflow route), an
    (SMs, 2) int32 device tensor."""
    n = a.shape[0]
    if tuple(a.shape) != (n, n) or tuple(b.shape) != (n,) or \
            a.dtype != torch.float32 or b.dtype != torch.float32 or \
            b.device != a.device:
        raise ValueError(f"dense_cg: needs f32 (dim, dim) and (dim,) on one "
                         f"device, got {a.dtype} {tuple(a.shape)}, {b.dtype} "
                         f"{tuple(b.shape)} on {a.device}, {b.device}")
    smem, _, ctas = _dense_sizes(n)
    if smem > _SMEM_MAX:
        raise ValueError(f"dense_cg: dim {n} needs {smem} B of shared memory "
                         f"for p, r and its rows (> {_SMEM_MAX})")
    a, b = a.contiguous(), b.contiguous()
    x = torch.empty((n,), dtype=torch.float32, device=a.device)
    # Freed on return while the kernel may still run: safe, see pairs_cg.
    ap_scratch = torch.empty((2 * n,), dtype=torch.float32, device=a.device)
    stats = torch.empty((ctas, 2), dtype=torch.int32, device=a.device)
    aligned = n % 4 == 0 and a.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = _dense_lib().dense_cg_launch(a.data_ptr(), b.data_ptr(),
                                      x.data_ptr(), ap_scratch.data_ptr(),
                                      stats.data_ptr(), n, iterations,
                                      int(aligned), stream)
    if rc != 0:
        raise RuntimeError(f"dense_cg launch failed: cudaError {rc}")
    dense_cg.launches += 1
    if with_stats:
        return x, stats
    return x


def dense_cg_stats(a, b, *, iterations: int = 32):
    """Launch K3 once on CUDA tensors, as :func:`dense_cg` does; returns the
    solution and each CTA's (chunks kept, rows on the overflow route)."""
    return _launch_dense_cg(a, b, iterations, with_stats=True)


def dense_cg(a, b, *, iterations: int = 32):
    """Plain CG on ``a x = b`` (kernel K3): a (dim, dim) f32 symmetric, b
    (dim,) f32; returns x (dim,) after ``iterations`` steps from 0.

    ``pcg_pallas`` zero-pads the system to a multiple of 256; the iterates
    stay exactly zero in the padded coordinates, so the kernel takes the
    system at its own dim, any dim up to ~28,000 (p, r and the per-row
    state of a CTA in shared memory).  On the CPU the plain version solves
    the padded system, so that it rounds as the JAX package's does.
    """
    if a.device.type == "cpu":
        dim = a.shape[0]
        pad = -dim % _DENSE_PAD
        return dense_cg_plain(torch.nn.functional.pad(a, (0, pad, 0, pad)),
                              torch.nn.functional.pad(b, (0, pad)),
                              iterations=iterations)[:dim]
    if a.device.type != "cuda":
        raise ValueError(f"dense_cg: unsupported device {a.device}")
    return _launch_dense_cg(a, b, iterations)


dense_cg.launches = 0
