"""The payload-wide probe's row fetch, match and select.

Port of ``close_kmers_tpu/ops/pallas_select.py::select_wide_rows`` plus
the row gather before it and the miss masking after it
(``core/engine.py`` ``probe_windows`` payload-wide branch,
``_finish_select``).  On a CUDA tensor :func:`probe_select` launches the
hand-written kernel ``csrc/probe_select.cu``; on a CPU tensor it runs
:func:`probe_select_plain`, the same gather + masked sums in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int32] * 4
             + [ctypes.c_void_p] * 7)


def probe_select_plain(hi, lo, valid, payload_wide, wd: int, n: int):
    """Flat ``hi``/``lo`` i32 and ``valid`` bool over N windows against
    ``payload_wide`` [H, row_w] i32 rows [start | lo | fi | oi | avg_off
    | wt-bits planes of width wd].  Returns (found, fi, oi, avg_off, wt,
    idx) of length N, with the miss values fi = oi = -1, avg_off = 0,
    wt = 0.0, idx = n.  Invalid windows probe row 0 with lo = -2, which
    matches nothing (engine.py probe_windows)."""
    ok = valid & (hi >= 0) & (hi < payload_wide.shape[0])
    hi_c = torch.where(ok, hi, 0)
    lo_c = torch.where(ok, lo, -2)
    row = payload_wide[hi_c.long()]
    match = row[:, 1:1 + wd] == lo_c[:, None]
    m = match.to(torch.int32)

    def pick(p):
        return (row[:, 1 + p * wd:1 + (p + 1) * wd] * m).sum(
            dim=1, dtype=torch.int32)

    found = ok & match.any(dim=1)
    pos = m.argmax(dim=1).to(torch.int32)   # first match; keys are unique
    fi = torch.where(found, pick(1), -1)
    oi = torch.where(found, pick(2), -1)
    wt = pick(4).view(torch.float32)
    idx = torch.where(found, row[:, 0] + pos, n)
    return found, fi, oi, pick(3), wt, idx


def probe_select(hi, lo, valid, payload_wide, wd: int, n: int):
    """:func:`probe_select_plain`'s contract; launches the CUDA kernel
    when the tensors lie on the card.  Raises on a bad device, dtype,
    shape or layout."""
    N = hi.shape[0]
    H, row_w = payload_wide.shape
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError("hi and lo must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if payload_wide.dtype != torch.int32:
        raise TypeError("payload_wide must be int32")
    if hi.dim() != 1 or lo.shape != (N,) or valid.shape != (N,):
        raise ValueError("hi, lo and valid must be flat and of one length")
    if not (0 < wd and 1 + 5 * wd <= row_w):
        raise ValueError(f"wd={wd} does not fit rows of width {row_w}")
    devs = {t.device for t in (hi, lo, valid, payload_wide)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return probe_select_plain(hi, lo, valid, payload_wide, wd, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (hi, lo, valid, payload_wide)):
        raise ValueError("probe_select needs contiguous tensors")
    found = torch.empty(N, dtype=torch.bool, device=dev)
    fi, oi, avg_off, idx = (torch.empty(N, dtype=torch.int32, device=dev)
                            for _ in range(4))
    wt = torch.empty(N, dtype=torch.float32, device=dev)
    fn = _build.kernel("ck_probe_select", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                payload_wide.data_ptr(), N, H, row_w, wd, n,
                found.data_ptr(), fi.data_ptr(), oi.data_ptr(),
                avg_off.data_ptr(), wt.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_probe_select")
    probe_select.launches += 1
    return found, fi, oi, avg_off, wt, idx


probe_select.launches = 0
