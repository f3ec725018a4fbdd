"""Wide-row probes: row fetch, match and select, two forms.

* :func:`probe_select`, the payload-wide probe: port of
  ``close_kmers_tpu/ops/pallas_select.py::select_wide_rows`` plus the row
  gather before it and the miss masking after it (``core/engine.py``
  ``probe_windows`` payload-wide branch, ``_finish_select``).
* :func:`famwide_select`, the folded family probe: port of the
  single-gather ``famwide`` branch of ``core/device_family.py::
  _score_family_jit``, which XLA ran on the TPU (no Pallas kernel).

On a CUDA tensor each launches its entry of the hand-written kernel
``csrc/probe_select.cu`` (both a quarter-warp per window, two windows in
flight each); on a CPU tensor it runs its ``*_plain`` version, the same
gather + masked sums in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int32] * 4
             + [ctypes.c_void_p] * 7)
_FW_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                + [ctypes.c_int32] * 5 + [ctypes.c_void_p] * 5)


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


def _check(hi, lo, valid, rows, wd: int, need_w: int) -> torch.device:
    """Shared input checks; returns the one device of the tensors."""
    N = hi.shape[0]
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError("hi and lo must be int32")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise TypeError("the row table must be a 2-d int32 tensor")
    if hi.dim() != 1 or lo.shape != (N,) or valid.shape != (N,):
        raise ValueError("hi, lo and valid must be flat and of one length")
    if not (0 < wd and need_w <= rows.shape[1]):
        raise ValueError(f"wd={wd} does not fit rows of width "
                         f"{rows.shape[1]}")
    devs = {t.device for t in (hi, lo, valid, rows)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(
            t.is_contiguous() for t in (hi, lo, valid, rows)):
        raise ValueError("the probe kernels need contiguous tensors")
    return dev


def probe_select(hi, lo, valid, payload_wide, wd: int, n: int):
    """:func:`probe_select_plain`'s contract; launches the CUDA kernel
    when the tensors lie on the card.  Raises on a bad device, dtype,
    shape or layout."""
    dev = _check(hi, lo, valid, payload_wide, wd, 1 + 5 * wd)
    if dev.type == "cpu":
        return probe_select_plain(hi, lo, valid, payload_wide, wd, n)
    out = probe_outputs(hi.shape[0], dev)
    _launch_probe(hi, lo, valid, payload_wide, wd, n, out)
    probe_select.launches += 1
    return out


def probe_outputs(n: int, dev):
    """Empty (found, fi, oi, avg_off, wt, idx) planes of ``n`` windows on
    ``dev``."""
    return (torch.empty(n, dtype=torch.bool, device=dev),
            *(torch.empty(n, dtype=torch.int32, device=dev)
              for _ in range(3)),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


def _launch_probe(hi, lo, valid, payload_wide, wd: int, n: int,
                  out) -> None:
    """``ck_probe_select`` into the preallocated ``out`` (the planes of
    :func:`probe_outputs`); no checks, no count."""
    dev = hi.device
    H, row_w = payload_wide.shape
    fn = _build.kernel("ck_probe_select", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                payload_wide.data_ptr(), hi.shape[0], H, row_w, wd, n,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_probe_select")


probe_select.launches = 0


def famwide_select_plain(hi, lo, valid, famwide, wd: int, d: int,
                         lo_bits: int):
    """Flat ``hi``/``lo`` i32 and ``valid`` bool over N windows against
    ``famwide`` [H, row_w] i32 rows [(fi << lo_bits | lo) | wt-bits |
    fam_0 .. fam_{d-1} planes of width wd].  A slot matches when its low
    ``lo_bits`` equal the window's.  Returns (found, fi, wt, fams [N,
    d]), with the miss values fi = -1, wt = 0.0, fams = -1.  Invalid
    windows probe row 0 with lo = -2, which matches nothing."""
    mask = (1 << lo_bits) - 1
    ok = valid & (hi >= 0) & (hi < famwide.shape[0])
    hi_c = torch.where(ok, hi, 0)
    lo_c = torch.where(ok, lo, -2)
    row = famwide[hi_c.long()]
    match = (row[:, :wd] & mask) == (lo_c & mask)[:, None]
    m = match.to(torch.int32)

    def pick(p):
        return (row[:, p * wd:(p + 1) * wd] * m).sum(dim=1,
                                                    dtype=torch.int32)

    found = ok & match.any(dim=1)
    fi = torch.where(found, pick(0) >> lo_bits, -1)
    wt = torch.where(found, pick(1), 0).view(torch.float32)
    fams = torch.stack([torch.where(found, pick(2 + p), -1)
                        for p in range(d)], dim=1)
    return found, fi, wt, fams


def famwide_select(hi, lo, valid, famwide, wd: int, d: int, lo_bits: int):
    """:func:`famwide_select_plain`'s contract; launches the CUDA kernel
    when the tensors lie on the card.  Raises on a bad device, dtype,
    shape or layout."""
    if not (0 < d and 0 < lo_bits < 31):
        raise ValueError(f"bad famwide geometry d={d}, lo_bits={lo_bits}")
    dev = _check(hi, lo, valid, famwide, wd, (2 + d) * wd)
    if dev.type == "cpu":
        return famwide_select_plain(hi, lo, valid, famwide, wd, d, lo_bits)
    out = famwide_outputs(hi.shape[0], d, dev)
    _launch_famwide(hi, lo, valid, famwide, wd, d, lo_bits, out)
    famwide_select.launches += 1
    return out


def famwide_outputs(n: int, d: int, dev):
    """Empty (found, fi, wt, fams [n, d]) planes on ``dev``."""
    return (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty((n, d), dtype=torch.int32, device=dev))


def _launch_famwide(hi, lo, valid, famwide, wd: int, d: int, lo_bits: int,
                    out) -> None:
    """``ck_famwide_select`` into the preallocated ``out`` (the planes of
    :func:`famwide_outputs`); no checks, no count."""
    dev = hi.device
    H, row_w = famwide.shape
    fn = _build.kernel("ck_famwide_select", _FW_ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
                famwide.data_ptr(), hi.shape[0], H, row_w, wd, d, lo_bits,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_famwide_select")


famwide_select.launches = 0
