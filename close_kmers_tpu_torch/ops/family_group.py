"""Family grouping and per-row compaction of the family rollup.

Port of the grouping ``lax.scan`` and the per-row left-pack of
``close_kmers_tpu/core/device_family.py::rollup_from_fams`` (XLA code on
the TPU, no Pallas kernel).  On a CUDA tensor :func:`family_group`
launches the hand-written kernel ``csrc/family_group.cu`` (one thread per
row); on a CPU tensor it runs :func:`family_group_plain`, the same scan
as a torch loop over the sorted columns.

Both take each row's (key, weight, position) planes stably sorted by key
(pads = :data:`PAD_KEY` last) and return, per row, the group count and
the first ``cap`` groups in ascending family order.  A group's weight is
a chain of f32 adds in sorted order, bit-identical to the reference.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PAD_KEY = 1 << 30   # rollup_from_fams' BIG: the key of pad / miss slots

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 3 \
    + [ctypes.c_void_p] * 6


def family_group_plain(skey, swt, spos, cap: int):
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


def family_group(skey, swt, spos, cap: int):
    """:func:`family_group_plain`'s contract; launches the CUDA kernel
    when the tensors lie on the card.  Raises on a bad device, dtype,
    shape or layout."""
    if skey.dtype != torch.int32 or spos.dtype != torch.int32:
        raise TypeError("skey and spos must be int32")
    if swt.dtype != torch.float32:
        raise TypeError("swt must be float32")
    if skey.dim() != 2 or swt.shape != skey.shape \
            or spos.shape != skey.shape:
        raise ValueError("skey, swt and spos must share one [B, M] shape")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, not {cap}")
    devs = {t.device for t in (skey, swt, spos)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return family_group_plain(skey, swt, spos, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (skey, swt, spos)):
        raise ValueError("family_group needs contiguous tensors")
    B, M = skey.shape
    n = torch.empty(B, dtype=torch.int32, device=dev)
    fam, cnt, first = (torch.empty((B, cap), dtype=torch.int32, device=dev)
                       for _ in range(3))
    ws = torch.empty((B, cap), dtype=torch.float32, device=dev)
    fn = _build.kernel("ck_family_group", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(skey.data_ptr(), swt.data_ptr(), spos.data_ptr(), B, M, cap,
                n.data_ptr(), fam.data_ptr(), cnt.data_ptr(), ws.data_ptr(),
                first.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_family_group")
    family_group.launches += 1
    return n, fam, cnt, ws, first


family_group.launches = 0
