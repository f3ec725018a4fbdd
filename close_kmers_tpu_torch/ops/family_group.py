"""Family rollup of one batch, row by row: 1/degree weights, sort by
family, grouping and per-row compaction.

Port of the row-local part of ``close_kmers_tpu/core/device_family.py::
rollup_from_fams`` (the weights, the stable ``lax.sort`` along the row,
the grouping ``lax.scan`` and the per-row left-pack; XLA code on the TPU,
no Pallas kernel).  :func:`family_group` takes the [B, W, D] family rows
and returns, per row, the group count and the first ``cap`` groups in
ascending family order.  A group's weight is a chain of f32 adds in
(window, family-list) order, bit-identical to the reference.

On a CPU tensor it runs :func:`family_group_plain`: :func:`sort_fams`
(the reference's key, weight and stable-sort steps) then
:func:`group_sorted_plain` (its scan as a torch loop over the sorted
columns).  On a CUDA tensor it launches ``csrc/family_group.cu``, by the
row width W*D alone: up to :data:`SMEM_MAX_COLS` the whole step is one
kernel (``ck_family_group``, the row sorted in registers and shared
memory); wider rows take :func:`sort_fams` on the card and the sorted
walk ``ck_family_group_sorted``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

PAD_KEY = 1 << 30   # rollup_from_fams' BIG: the key of pad / miss slots
SMEM_MAX_COLS = 8192   # csrc/family_group.cu kMaxCols: widest fused row

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int32] * 4 \
    + [ctypes.c_void_p] * 6
_SORTED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 3 \
    + [ctypes.c_void_p] * 6


def weight_constants(d: int) -> np.ndarray:
    """float32(1) / float32(k) for k = 1..d: the 1/degree weights, made on
    the host (never a device divide), as the reference makes them."""
    return np.float32(1.0) / np.arange(1, d + 1, dtype=np.float32)


def sort_fams(fams):
    """[B, W, D] family rows -> each row's (family key, 1/degree weight,
    flat window*D + list position) planes [B, W*D], stably sorted by
    key, pads (key PAD_KEY, weight 0) last."""
    B, W, D = fams.shape
    deg = (fams >= 0).sum(dim=-1)
    w = torch.zeros(deg.shape, dtype=torch.float32, device=fams.device)
    # scalars, so no copy to the device and no sync
    for k, c in enumerate(weight_constants(D), start=1):
        w = torch.where(deg == k, float(c), w)
    fam_flat = fams.reshape(B, W * D)
    ok = fam_flat >= 0
    key = torch.where(ok, fam_flat, PAD_KEY)
    wt_flat = torch.where(
        ok, w[:, :, None].expand(B, W, D).reshape(B, W * D), 0.0)
    # row-local stable sort by family id: pads sink, and each family
    # group keeps (window, family-list) order, the host's visit order
    skey, perm = torch.sort(key, dim=1, stable=True)
    return skey, torch.gather(wt_flat, 1, perm), perm.to(torch.int32)


def group_sorted_plain(skey, swt, spos, cap: int):
    """``skey``/``spos`` i32 and ``swt`` f32, [B, M], each row sorted by
    key.  Returns (n_groups [B], fam, count, weighted, first [B, cap]),
    zero past each row's groups."""
    B, M = skey.shape
    dev = skey.device
    i32 = dict(dtype=torch.int32, device=dev)
    # one spare column takes the writes of groups past the cap
    fam, cnt, first = (torch.zeros((B, cap + 1), **i32) for _ in range(3))
    ws = torch.zeros((B, cap + 1), dtype=torch.float32, device=dev)
    n = torch.zeros(B, **i32)
    cur, c, f0 = (torch.zeros(B, **i32) for _ in range(3))
    s = torch.zeros(B, dtype=torch.float32, device=dev)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    where = torch.where

    def emit(mask):
        slot = where(mask & (n < cap), n, cap).long()[:, None]
        for out, v in ((fam, cur), (cnt, c), (ws, s), (first, f0)):
            out.scatter_(1, slot, v[:, None])
        return n + mask.to(torch.int32)

    # the sorted rows' valid prefixes end at the longest one
    n_cols = int((skey < PAD_KEY).sum(dim=1).max()) if B * M else 0
    for t in range(n_cols):
        f, wv = skey[:, t], swt[:, t]
        valid = f < PAD_KEY
        is_new = valid & (~have | (f != cur))
        same = valid & have & (f == cur)
        n = emit(is_new & have)
        cur = where(is_new, f, cur)
        c = where(is_new, 1, where(same, c + 1, c))
        s = where(is_new, wv, where(same, s + wv, s))
        f0 = where(is_new, spos[:, t], f0)
        have = have | valid
    n = emit(have)
    return (n, fam[:, :cap].contiguous(), cnt[:, :cap].contiguous(),
            ws[:, :cap].contiguous(), first[:, :cap].contiguous())


def family_group_plain(fams, cap: int):
    """``fams`` i32 [B, W, D] (-1 = pad or miss).  Returns (n_groups [B],
    fam, count, weighted, first [B, cap]), zero past each row's groups."""
    return group_sorted_plain(*sort_fams(fams), cap)


def route(m: int) -> str:
    """The kernel a CUDA row of ``m`` = W*D slots takes: ``"fused"`` (one
    kernel) up to SMEM_MAX_COLS, ``"sorted"`` past it."""
    return "fused" if m <= SMEM_MAX_COLS else "sorted"


@functools.lru_cache(maxsize=64)
def _weights(d: int, dev: torch.device) -> torch.Tensor:
    """The host's weight constants on ``dev``, copied there once."""
    return torch.from_numpy(weight_constants(d)).to(dev)


def _outputs(B: int, cap: int, dev):
    n = torch.empty(B, dtype=torch.int32, device=dev)
    fam, cnt, first = (torch.empty((B, cap), dtype=torch.int32, device=dev)
                       for _ in range(3))
    ws = torch.empty((B, cap), dtype=torch.float32, device=dev)
    return n, fam, cnt, ws, first


def _launch(fams, wts, cap: int, out) -> None:
    """``ck_family_group`` into the preallocated ``out`` (the five
    planes of :func:`_outputs`); no checks, no count."""
    B, W, D = fams.shape
    fn = _build.kernel("ck_family_group", _ARGTYPES)
    with torch.cuda.device(fams.device):
        rc = fn(fams.data_ptr(), wts.data_ptr(), B, W, D, cap,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(fams.device).cuda_stream)
    _build.check(rc, "ck_family_group")


def _launch_sorted(skey, swt, spos, cap: int, out) -> None:
    """``ck_family_group_sorted`` on sorted planes into ``out``."""
    B, M = skey.shape
    fn = _build.kernel("ck_family_group_sorted", _SORTED_ARGTYPES)
    with torch.cuda.device(skey.device):
        rc = fn(skey.data_ptr(), swt.data_ptr(), spos.data_ptr(), B, M, cap,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(skey.device).cuda_stream)
    _build.check(rc, "ck_family_group_sorted")


def family_group(fams, cap: int):
    """:func:`family_group_plain`'s contract; on the card it launches
    the kernel of :func:`route`.  Raises on a bad device, dtype, shape or
    layout."""
    if fams.dtype != torch.int32:
        raise TypeError("fams must be int32")
    if fams.dim() != 3 or fams.shape[2] < 1:
        raise ValueError(f"fams must be [B, W, D >= 1], not "
                         f"{tuple(fams.shape)}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, not {cap}")
    dev = fams.device
    if dev.type == "cpu":
        return family_group_plain(fams, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not fams.is_contiguous():
        raise ValueError("family_group needs a contiguous tensor")
    B, W, D = fams.shape
    out = _outputs(B, cap, dev)
    if route(W * D) == "fused":
        _launch(fams, _weights(D, dev), cap, out)
    else:
        _launch_sorted(*sort_fams(fams), cap, out)
    family_group.launches += 1
    return out


family_group.launches = 0
