"""The binary-search probe tier: each window's lower bound in its bucket's
slice of the sorted lo array, then its payload row.

Port of the binary-search branch of ``close_kmers_tpu/core/engine.py::
probe_windows`` (lines 603-628), which the JAX package left to XLA.  On a
CUDA tensor :func:`probe_search` launches the hand-written kernel
``csrc/probe_search.cu`` (one thread a window); on a CPU tensor it runs
:func:`probe_search_plain`, the same search in plain torch, n_steps
rounds of a few tensor operations.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int32] + [ctypes.c_void_p] * 2
             + [ctypes.c_int64] + [ctypes.c_int32] * 2
             + [ctypes.c_void_p] * 7)


def probe_search_plain(hi, lo, valid, bucket_pair, lo_arr, payload, n: int,
                       n_steps: int):
    """Windows ``hi``/``lo`` i32 and ``valid`` bool (any one shape)
    against ``bucket_pair`` [H, 2] (start, end), the bucket-sorted
    ``lo_arr`` [n+1] and ``payload`` [n+1, 4] (fi, oi, avg_off, wt-bits;
    row n the miss row).  Returns (found, fi, oi, avg_off, wt, idx) shaped
    like ``hi``; a miss takes payload row n and idx = n.

    A branchless lower bound (engine.py:604-625): after n_steps halvings
    left == right == the insertion point of lo in lo_arr[start:end); int32
    throughout, and the clamp to n keeps every read inside the table.  An
    invalid window searches bucket 0 for lo = -2, which matches
    nothing."""
    hi_c = torch.where(valid, hi, 0)
    lo_c = torch.where(valid, lo, -2)
    pair = bucket_pair[hi_c.long()]
    left, end = pair[..., 0], pair[..., 1]
    right = end
    for _ in range(n_steps):
        cont = left < right
        mid = (left + right) >> 1
        go_right = cont & (lo_arr[mid.clamp(max=n).long()] < lo_c)
        left, right = (torch.where(go_right, mid + 1, left),
                       torch.where(cont & ~go_right, mid, right))
    idx = left.clamp(max=n)
    found = valid & (left < end) & (lo_arr[idx.long()] == lo_c)
    idx = torch.where(found, idx, n)
    row = payload[idx.long()]
    return (found, row[..., 0], row[..., 1], row[..., 2],
            row[..., 3].contiguous().view(torch.float32), idx)


def _check(hi, lo, valid, bucket_pair, lo_arr, payload, n: int,
           n_steps: int) -> torch.device:
    """Input checks; returns the one device of the tensors."""
    ints = (hi, lo, bucket_pair, lo_arr, payload)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("hi, lo, bucket_pair, lo_arr and payload must be "
                        "int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if lo.shape != hi.shape or valid.shape != hi.shape:
        raise ValueError("hi, lo and valid must have one shape")
    if bucket_pair.dim() != 2 or bucket_pair.shape[1] != 2:
        raise ValueError("bucket_pair must be [H, 2]")
    if lo_arr.shape != (n + 1,) or payload.shape != (n + 1, 4):
        raise ValueError(f"lo_arr must be [{n + 1}] and payload "
                         f"[{n + 1}, 4] for n = {n}")
    if n_steps < 0:
        raise ValueError(f"n_steps = {n_steps} < 0")
    devs = {t.device for t in (*ints, valid)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous()
                                      for t in (*ints, valid)):
        raise ValueError("the probe_search kernel needs contiguous tensors")
    return dev


def probe_search(hi, lo, valid, bucket_pair, lo_arr, payload, n: int,
                 n_steps: int):
    """:func:`probe_search_plain`'s contract; launches the CUDA kernel when
    the tensors lie on the card.  Raises on a bad device, dtype or shape.
    The kernel stops a window's search once left == right, which changes
    nothing, and never runs past ``n_steps``; a valid window whose hi lies
    outside bucket_pair misses there, where the plain version raises."""
    dev = _check(hi, lo, valid, bucket_pair, lo_arr, payload, n, n_steps)
    if dev.type == "cpu":
        return probe_search_plain(hi, lo, valid, bucket_pair, lo_arr,
                                  payload, n, n_steps)
    out = search_outputs(hi.shape, dev)
    _launch(hi, lo, valid, bucket_pair, lo_arr, payload, n, n_steps, out)
    probe_search.launches += 1
    return out


def search_outputs(shape, dev):
    """Empty (found, fi, oi, avg_off, wt, idx) planes of ``shape`` on
    ``dev``."""
    return (torch.empty(shape, dtype=torch.bool, device=dev),
            *(torch.empty(shape, dtype=torch.int32, device=dev)
              for _ in range(3)),
            torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _launch(hi, lo, valid, bucket_pair, lo_arr, payload, n: int,
            n_steps: int, out) -> None:
    """``ck_probe_search`` into the preallocated ``out`` (the planes of
    :func:`search_outputs`); no checks, no count."""
    dev = hi.device
    fn = _build.kernel("ck_probe_search", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                bucket_pair.data_ptr(), bucket_pair.shape[0],
                lo_arr.data_ptr(), payload.data_ptr(), hi.numel(), n,
                n_steps, *(t.data_ptr() for t in out),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_probe_search")


probe_search.launches = 0
