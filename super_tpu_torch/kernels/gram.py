"""Tuple-Gram reduction of the JTJ assembly: kernel K2 in its two forms, and
their plain versions.

Replaces super_tpu/pallas_kernels/gram.py (``_gram_kernel`` behind
``tuple_gram_pallas``).  One CUDA template, super_tpu_torch/csrc/tuple_gram.cu
(its bound and design are stated there), with two row sources:

- :func:`tuple_gram`: the gradient rows and residuals from memory, the TPU
  kernel's own function;
- :func:`data_gram`: the data term's rows computed in the kernel from the LM
  context and the frozen association, so that they never reach device
  memory (the JAX package's ``frozen_chunk_partial_fm``); the form the LM
  step runs.

Each takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

D = 28
# The kernel stages at most 256 rows, in G-blocks of at least 8.
_BLOCK_MIN, _BLOCK_MAX = 8, 256


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of csrc/tuple_gram.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, args, res in (
            (lib.tuple_gram_scratch_floats, [ci], ctypes.c_longlong),
            (lib.tuple_gram_launch, [vp] * 6 + [ci] * 3 + [vp], ci),
            (lib.data_gram_launch,
             [vp] * 14 + [ctypes.c_float] + [ci] * 6 + [vp], ci)):
        fn.argtypes, fn.restype = args, res
    return lib


@functools.cache
def _lib():
    """csrc/tuple_gram.cu's library, built on first use, its C signatures
    declared once."""
    from super_tpu_torch.kernels.build import load

    return declare(load("tuple_gram"))


@functools.cache
def _scratch_floats(data: bool) -> int:
    """Scratch of one launch (two tuple parts and a cost per CTA), asked of
    the library once per instance."""
    return _lib().tuple_gram_scratch_floats(int(data))


def _check_blocks(name, np_cap, block_tuple, block, tuple_cap):
    nb = np_cap // block if block > 0 else -1
    if not (_BLOCK_MIN <= block <= _BLOCK_MAX) or np_cap % block != 0 or \
            tuple_cap <= 0 or tuple(block_tuple.shape) != (nb,) or \
            block_tuple.dtype != torch.int32:
        raise ValueError(
            f"{name}: needs {_BLOCK_MIN} <= block <= {_BLOCK_MAX} dividing "
            f"Np = {np_cap}, tuple_cap > 0 and an int32 block_tuple of "
            f"Np / block entries; got block {block}, tuple_cap {tuple_cap}, "
            f"block_tuple {block_tuple.dtype} {tuple(block_tuple.shape)}")
    return nb


def _run(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def tuple_gram_plain(h, r, block_tuple, *, tuple_cap: int, block: int):
    """Per-block Grams h^T [h | r], summed per tuple by the sorted
    block->tuple map: (gram (T, 28, 28), jtr_t (T, 28))."""
    np_cap = h.shape[0]
    nb = np_cap // block
    hb = h.reshape(nb, block, D)
    ext = torch.cat([hb, r.reshape(nb, block, 1)], dim=-1)
    grams = torch.bmm(hb.transpose(1, 2), ext)           # (B, 28, 29)
    out = h.new_zeros((tuple_cap, D, D + 1)).index_add_(
        0, block_tuple.long(), grams)
    return out[:, :, :D], out[:, :, D]


def tuple_gram(h, r, block_tuple, *, tuple_cap: int, block: int):
    """Per-tuple Gram accumulation (kernel K2, rows from memory).

    h: (Np, 28) f32 gradient rows in tuple-sorted padded order; r: (Np,)
    f32; block_tuple: (Np // block,) int32, sorted, ids in [0, tuple_cap);
    every tuple run is a multiple of ``block`` rows.  Returns (gram (T, 28,
    28), jtr_t (T, 28)).
    """
    if h.device.type == "cpu":
        return tuple_gram_plain(h, r, block_tuple, tuple_cap=tuple_cap,
                                block=block)
    if h.device.type != "cuda":
        raise ValueError(f"tuple_gram: unsupported device {h.device}")
    np_cap = h.shape[0]
    nb = _check_blocks("tuple_gram", np_cap, block_tuple, block, tuple_cap)
    if h.shape != (np_cap, D) or r.shape != (np_cap,) or \
            h.dtype != torch.float32 or r.dtype != torch.float32:
        raise ValueError(f"tuple_gram: needs f32 h (Np, 28) and r (Np,), got "
                         f"{h.dtype} {tuple(h.shape)}, {r.dtype} "
                         f"{tuple(r.shape)}")
    if not (r.device == h.device == block_tuple.device):
        raise ValueError("tuple_gram: tensors on different devices")
    h, r = h.contiguous(), r.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()      # the kernel reads h in 16-byte words
    block_tuple = block_tuple.contiguous()
    # Scratch and the contiguous copies may be freed on return while the
    # kernel still runs: the caching allocator hands their memory only to
    # work queued after it on this stream.
    dev = h.device
    gram = torch.empty((tuple_cap, D, D), dtype=torch.float32, device=dev)
    jtr = torch.empty((tuple_cap, D), dtype=torch.float32, device=dev)
    scratch = torch.empty((_scratch_floats(False),), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _run("tuple_gram", _lib().tuple_gram_launch(
        h.data_ptr(), r.data_ptr(), block_tuple.data_ptr(), gram.data_ptr(),
        jtr.data_ptr(), scratch.data_ptr(), nb, block, tuple_cap, stream))
    tuple_gram.launches += 1
    return gram, jtr


tuple_gram.launches = 0


def data_gram_plain(ctx, beta, weight: float, assoc, *, block: int):
    """:func:`data_gram` in plain PyTorch: the data term's rows and
    residuals (``core/losses.py:data_rows``), their per-tuple Grams, and
    the sum of squared residuals."""
    # core/losses.py imports this module.
    from super_tpu_torch.core.losses import data_rows

    h, r = data_rows(ctx, beta, weight, assoc)
    layout = ctx.layout
    gram, jtr_t = tuple_gram_plain(h, r, layout.block_tuple,
                                   tuple_cap=layout.tuple_nodes.shape[0],
                                   block=block)
    return gram, jtr_t, torch.sum(r * r)


def data_gram(ctx, beta, weight: float, assoc, *, block: int):
    """The data term's per-tuple Grams with its rows computed in the kernel
    (kernel K2, rows from the data term): (gram (T, 28, 28), jtr_t (T, 28),
    cost ()), the function of :func:`data_gram_plain`.

    Reads the LM context's ``sf_points`` (3, Np), ``sf_knn_w`` (4, Np),
    ``sf_mask`` (Np,), ``tuple_knn`` (12, T) and its layout's
    ``tuple_nodes`` (T, 4) and ``block_tuple`` (Np // block,); the frozen
    association's ``o``, ``n`` (3, Np) and ``mask`` (Np,); beta (J, 7).
    The blocks of the sink tuple T - 1 are skipped: the layout masks their
    slots (``assembly.build_tuple_layout``).
    """
    layout = ctx.layout
    tensors = dict(sf_points=ctx.sf_points, sf_knn_w=ctx.sf_knn_w,
                   sf_mask=ctx.sf_mask, tuple_knn=ctx.tuple_knn,
                   tuple_nodes=layout.tuple_nodes,
                   block_tuple=layout.block_tuple, o=assoc.o, n=assoc.n,
                   amask=assoc.mask, beta=beta)
    dev = beta.device
    if dev.type == "cpu":
        return data_gram_plain(ctx, beta, weight, assoc, block=block)
    if dev.type != "cuda":
        raise ValueError(f"data_gram: unsupported device {dev}")
    np_cap = ctx.sf_mask.shape[0]
    t_cap = layout.tuple_nodes.shape[0]
    j_cap = beta.shape[0]
    nb = _check_blocks("data_gram", np_cap, layout.block_tuple, block, t_cap)
    want = dict(sf_points=((3, np_cap), torch.float32),
                sf_knn_w=((4, np_cap), torch.float32),
                sf_mask=((np_cap,), torch.bool),
                tuple_knn=((12, t_cap), torch.float32),
                tuple_nodes=((t_cap, 4), torch.int32),
                block_tuple=((nb,), torch.int32),
                o=((3, np_cap), torch.float32), n=((3, np_cap), torch.float32),
                amask=((np_cap,), torch.bool),
                beta=((j_cap, 7), torch.float32))
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"data_gram: {name} must be {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    # tuple_nodes goes by its strides: the layout's is a transposed view,
    # which a copy would cost a launch a trip.
    args = [t if name == "tuple_nodes" else t.contiguous()
            for name, t in tensors.items()]
    # Freed on return while the kernel may still run: safe, see tuple_gram.
    gram = torch.empty((t_cap, D, D), dtype=torch.float32, device=dev)
    jtr = torch.empty((t_cap, D), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    scratch = torch.empty((_scratch_floats(True),), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _run("data_gram", _lib().data_gram_launch(
        *(t.data_ptr() for t in args), gram.data_ptr(), jtr.data_ptr(),
        cost.data_ptr(), scratch.data_ptr(), float(weight), nb, block, t_cap,
        j_cap, *layout.tuple_nodes.stride(), stream))
    data_gram.launches += 1
    return gram, jtr, cost


data_gram.launches = 0
