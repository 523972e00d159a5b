"""Tuple-Gram reduction of the JTJ assembly: kernel K2 and its plain version.

Replaces super_tpu/pallas_kernels/gram.py (``_gram_kernel`` behind
``tuple_gram_pallas``).  The CUDA source, with its bound and design, is
super_tpu_torch/csrc/tuple_gram.cu: two passes, per-span partial Grams then a
per-tuple sum in a fixed order, no float atomics.

:func:`tuple_gram` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

D = 28


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
    """Per-tuple Gram accumulation (kernel K2).

    h: (Np, 28) f32 gradient rows in tuple-sorted padded order; r: (Np,)
    f32; block_tuple: (Np // block,) int32, sorted; every tuple run is a
    multiple of ``block`` rows.  Returns (gram (T, 28, 28), jtr_t (T, 28)).
    """
    if h.device.type == "cpu":
        return tuple_gram_plain(h, r, block_tuple, tuple_cap=tuple_cap,
                                block=block)
    if h.device.type != "cuda":
        raise ValueError(f"tuple_gram: unsupported device {h.device}")
    np_cap = h.shape[0]
    if h.shape != (np_cap, D) or np_cap % block != 0 or tuple_cap <= 0:
        raise ValueError(f"tuple_gram: bad shapes h {tuple(h.shape)}, "
                         f"block {block}, tuple_cap {tuple_cap}")
    nb = np_cap // block
    if r.shape != (np_cap,) or block_tuple.shape != (nb,):
        raise ValueError("tuple_gram: r / block_tuple shape mismatch")
    if h.dtype != torch.float32 or r.dtype != torch.float32 or \
            block_tuple.dtype != torch.int32:
        raise ValueError("tuple_gram: needs f32 h, r and int32 block_tuple")
    if not (r.device == h.device == block_tuple.device):
        raise ValueError("tuple_gram: tensors on different devices")
    h, r = h.contiguous(), r.contiguous()
    block_tuple = block_tuple.contiguous()

    from super_tpu_torch.kernels.build import load

    lib = load("tuple_gram")
    vp = ctypes.c_void_p
    lib.tuple_gram_launch.argtypes = [vp] * 6 + [ctypes.c_int] * 3 + [vp]
    lib.tuple_gram_launch.restype = ctypes.c_int
    # Scratch and the contiguous copies may be freed on return while the
    # kernel still runs: the caching allocator hands their memory only to
    # work queued after it on this stream.
    partial = torch.empty((nb * D * (D + 1),), dtype=torch.float32,
                          device=h.device)
    gram = torch.empty((tuple_cap, D, D), dtype=torch.float32,
                       device=h.device)
    jtr = torch.empty((tuple_cap, D), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = lib.tuple_gram_launch(h.data_ptr(), r.data_ptr(),
                               block_tuple.data_ptr(), partial.data_ptr(),
                               gram.data_ptr(), jtr.data_ptr(), nb, block,
                               tuple_cap, stream)
    if rc != 0:
        raise RuntimeError(f"tuple_gram launch failed: cudaError {rc}")
    tuple_gram.launches += 1
    return gram, jtr


tuple_gram.launches = 0
