"""The binary-search probe tier: each window's lower bound in its bucket's
slice of the sorted lo array, then its payload row.

Port of the binary-search branch of ``close_kmers_tpu/core/engine.py::
probe_windows`` (lines 603-628), which the JAX package left to XLA.  On a
CUDA tensor :func:`probe_search` launches the hand-written kernel
``csrc/probe_search.cu``, which reads each window's bucket from its
search row (:func:`search_rows`: the bucket's start, end and twelve keys
or pivots, 32 B, built from bucket_pair and lo beside them); on a CPU
tensor it runs :func:`probe_search_plain`, the same search in plain
torch, n_steps rounds of a few tensor operations.  :func:`launch_exp` runs the
kernel file's experiments (chip_smoke.py's decomposition of the search),
which no serving path calls.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int32] + [ctypes.c_void_p] * 2
             + [ctypes.c_int64] + [ctypes.c_int32] * 2
             + [ctypes.c_void_p] * 7)
_EXP_ARGTYPES = ([ctypes.c_int32] + [ctypes.c_void_p] * 4 + [ctypes.c_int32]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                 + [ctypes.c_int32] * 2 + [ctypes.c_void_p] * 7)
# a search row (csrc/probe_search.cu), 32 B: start, end (bit 31 set where
# the slots are 32-bit), then NARROW_SLOTS 16-bit keys or, where a key
# of the row lies outside [0, 2^16), WIDE_SLOTS 32-bit ones
ROW_W = 8
NARROW_SLOTS = 12
WIDE_SLOTS = 6
# ck_probe_search_exp's variants, by name
EXP_VARIANTS = {"pair_payload": 0, "first_t128": 1, "first_t256": 2,
                "first_t512": 3, "first_x2": 4, "first_x3": 5,
                "first_x4": 6, "quarter_w1": 7, "quarter_w2": 8,
                "quarter_w4": 9, "quarter_p1": 10, "quarter_p3": 11}


def midpoint(left, right):
    """The halving step's midpoint of int32 ``left`` <= ``right`` (tensors
    or ints below 2^31): left + ((right - left) >> 1), which never leaves
    int32.  It differs on purpose from the reference's (left + right) >> 1
    (``close_kmers_tpu/core/engine.py:615``): that sum wraps to a negative
    mid once a bucket starts at or above 2^30, and the search then reads
    another bucket's keys.  Where the sum does not wrap the two are
    equal, so the port's probe equals the JAX binary tier bit for bit
    below 2^30 keys."""
    return left + ((right - left) >> 1)


def probe_search_plain(hi, lo, valid, bucket_pair, lo_arr, payload, n: int,
                       n_steps: int):
    """Windows ``hi``/``lo`` i32 and ``valid`` bool (any one shape)
    against ``bucket_pair`` [H, 2] (start, end), the bucket-sorted
    ``lo_arr`` [n+1] and ``payload`` [n+1, 4] (fi, oi, avg_off, wt-bits;
    row n the miss row).  Returns (found, fi, oi, avg_off, wt, idx) shaped
    like ``hi``; a miss takes payload row n and idx = n.

    A branchless lower bound (engine.py:604-625): after n_steps halvings
    left == right == the insertion point of lo in lo_arr[start:end); int32
    throughout (:func:`midpoint` keeps it so past 2^30 keys), and the clamp
    to n keeps every read inside the table.  An invalid window searches
    bucket 0 for lo = -2, which matches nothing."""
    hi_c = torch.where(valid, hi, 0)
    lo_c = torch.where(valid, lo, -2)
    pair = bucket_pair[hi_c.long()]
    left, end = pair[..., 0], pair[..., 1]
    right = end
    for _ in range(n_steps):
        cont = left < right
        mid = midpoint(left, right)
        go_right = cont & (lo_arr[mid.clamp(max=n).long()] < lo_c)
        left, right = (torch.where(go_right, mid + 1, left),
                       torch.where(cont & ~go_right, mid, right))
    idx = left.clamp(max=n)
    found = valid & (left < end) & (lo_arr[idx.long()] == lo_c)
    idx = torch.where(found, idx, n)
    row = payload[idx.long()]
    return (found, row[..., 0], row[..., 1], row[..., 2],
            row[..., 3].contiguous().view(torch.float32), idx)


def _row_keys(start, size, lo_arr, n: int, slots: int):
    """The keys a row of ``slots`` slots holds for buckets (start, size):
    the bucket's keys where it holds up to ``slots``, else the pivots at
    offsets (j + 1) * s - 1 for s = size // (slots + 1) + 1; as (keys, the
    slots that hold one)."""
    j = torch.arange(slots, dtype=torch.int32, device=start.device)
    s = torch.where(size <= slots, 1, size // (slots + 1) + 1)
    off = torch.where((size <= slots)[:, None], j[None, :],
                      (j[None, :] + 1) * s[:, None] - 1)
    inside = off < size[:, None]
    pos = (start[:, None].long() + off).clamp(0, n)
    return torch.where(inside, lo_arr[pos], 0), inside


def search_rows(bucket_pair, lo_arr, n: int):
    """The kernel's search rows, [H, ROW_W] int32 on bucket_pair's device,
    an index of the tables as a B-tree's root nodes are: row h = (start,
    end, then the slots of bucket h: its keys where it holds up to as many
    as the slots, else pivots that cut it into one segment more).  The
    slots are NARROW_SLOTS 16-bit keys (two an int, the first in the low
    half) where every key the row would hold lies in [0, 2^16), as every
    lo code does (< 8000); else WIDE_SLOTS 32-bit keys and bit 31 of end
    set.  Slots past the bucket's keys or pivots hold 0 and are never
    read.  32 B a bucket, one sector, which the kernel reads in one round
    instead of the bucket pair."""
    start, end = bucket_pair[:, 0], bucket_pair[:, 1]
    size = end - start
    keys, inside = _row_keys(start, size, lo_arr, n, NARROW_SLOTS)
    narrow = ((keys >= 0) & (keys < 1 << 16) | ~inside).all(dim=1)
    pair16 = keys[:, 0::2].long() + (keys[:, 1::2].long() << 16)
    packed = torch.where(pair16 >= 1 << 31, pair16 - (1 << 32),
                         pair16).to(torch.int32)
    wide, _ = _row_keys(start, size, lo_arr, n, WIDE_SLOTS)
    slots = torch.where(narrow[:, None], packed, wide)
    flag = torch.where(narrow, 0, torch.iinfo(torch.int32).min).to(
        torch.int32)
    return torch.cat([start[:, None], (end | flag)[:, None], slots],
                     dim=1).contiguous()


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
    if not 0 <= n < 2 ** 31 - 1:
        raise ValueError(f"n = {n} outside [0, 2^31 - 1)")
    if not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"n_steps = {n_steps} outside [0, 2^31)")
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
                 n_steps: int, rows=None):
    """:func:`probe_search_plain`'s contract; launches the CUDA kernel when
    the tensors lie on the card, on ``rows``, the tables'
    :func:`search_rows` (built for the call when None; a caller that
    probes one table many times keeps them, as ``DeviceDB.search_rows``
    does).  Raises on a bad device, dtype or shape, and on n outside [0,
    2^31 - 1).  Where a bucket converges within ``n_steps`` halvings the
    kernel computes the lower bound they end at; elsewhere it runs them,
    stopping once left == right, which changes nothing.  A valid window
    whose hi lies outside bucket_pair misses there, where the plain
    version raises."""
    dev = _check(hi, lo, valid, bucket_pair, lo_arr, payload, n, n_steps)
    if dev.type == "cpu":
        return probe_search_plain(hi, lo, valid, bucket_pair, lo_arr,
                                  payload, n, n_steps)
    if rows is None:
        rows = search_rows(bucket_pair, lo_arr, n)
    if (rows.dtype != torch.int32 or rows.device != dev
            or rows.shape != (bucket_pair.shape[0], ROW_W)
            or not rows.is_contiguous()):
        raise ValueError(f"rows must be the contiguous int32 [H, {ROW_W}] "
                         f"search rows of bucket_pair, on {dev}")
    out = search_outputs(hi.shape, dev)
    _launch(hi, lo, valid, bucket_pair, lo_arr, payload, n, n_steps, out,
            rows)
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
            n_steps: int, out, rows) -> None:
    """``ck_probe_search`` into the preallocated ``out`` (the planes of
    :func:`search_outputs`) on ``rows``, bucket_pair's search rows (the
    kernel reads the bucket bounds there); no checks, no count."""
    dev = hi.device
    fn = _build.kernel("ck_probe_search", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                rows.data_ptr(), rows.shape[0],
                lo_arr.data_ptr(), payload.data_ptr(), hi.numel(), n,
                n_steps, *(t.data_ptr() for t in out),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_probe_search")


def launch_exp(variant: str, hi, lo, valid, bucket_pair, lo_arr, payload,
               known, n: int, n_steps: int, out) -> None:
    """Experiment ``variant`` (:data:`EXP_VARIANTS`) of
    ``ck_probe_search_exp`` on card tensors into ``out``; ``known``
    (int32, like ``hi``) holds each window's result row for
    ``pair_payload`` and is read by no other variant.  Counts no launch:
    no serving path runs it."""
    if payload.data_ptr() % 16:
        raise ValueError("the experiments need a 16-B aligned payload")
    dev = hi.device
    fn = _build.kernel("ck_probe_search_exp", _EXP_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(EXP_VARIANTS[variant], hi.data_ptr(), lo.data_ptr(),
                valid.data_ptr(), bucket_pair.data_ptr(),
                bucket_pair.shape[0], lo_arr.data_ptr(), payload.data_ptr(),
                known.data_ptr(), hi.numel(), n, n_steps,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"ck_probe_search_exp ({variant})")


probe_search.launches = 0
