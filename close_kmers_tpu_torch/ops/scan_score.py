"""The gather_hits run/gap/two-hit scoring state machine (kguts.cc:734-877).

Port of ``close_kmers_tpu/ops/pallas_scan.py::scan_score_pallas`` with
the chained-tile arguments of ``core/device_score.py::_scan_score_core``
(``init``, ``pos0``, ``final_flush``, ``want_emit``).  On CUDA tensors
:func:`scan_score` launches the hand-written kernel
``csrc/scan_score.cu`` (one thread per sequence); on CPU tensors it runs
:func:`scan_score_plain`, the batched masked-select loop of the
reference written in torch.

Outputs keep the reference's layout: ``emit`` [B, W+1] bool and the call
fields (start, end, count, fi, weighted) [B, W+1], whose last column is
the end-of-sequence flush, plus the final 13-field state.
"""

from __future__ import annotations

import ctypes

import torch

from ..host import params
from . import _build

K = params.K

# Field order of the kernel's packed state arrays (csrc/scan_score.cu).
INT_FIELDS = ("num_hits", "current", "first_pos", "prev_fi", "prev_pos",
              "prev_av", "prev2_fi", "prev2_pos", "cnt", "last_match")
FLOAT_FIELDS = ("prev_wt", "prev2_wt", "wsum")

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int32] * 2
             + [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 5
             + [ctypes.c_void_p] * 9)


def neutral_scan_state(B: int, device) -> dict:
    """The gather_hits state at sequence start (the all-zero 13-field
    carry) for B rows on ``device``."""
    s = {k: torch.zeros(B, dtype=torch.int32, device=device)
         for k in INT_FIELDS}
    s.update({k: torch.zeros(B, dtype=torch.float32, device=device)
              for k in FLOAT_FIELDS})
    return s


def scan_score_plain(found, fi, av, wt, min_hits, min_weighted_hits,
                     max_gap, order_constraint, init=None, pos0=None,
                     want_emit=True, final_flush=None):
    """``found`` bool, ``fi``/``av`` i32, ``wt`` f32, all [B, W].
    Returns (emit, [start, end, count, fi, weighted], state), or
    (None, None, state) when ``want_emit`` is false."""
    B, W = found.shape
    dev = found.device
    s = dict(init) if init is not None else neutral_scan_state(B, dev)
    zf = torch.zeros(B, dtype=torch.float32, device=dev)
    base = (torch.zeros(B, dtype=torch.int32, device=dev) if pos0 is None
            else pos0.to(torch.int32))
    min_wt = float(min_weighted_hits)
    where = torch.where

    def flush_fields(s):
        emit = (s["num_hits"] > 0) & (s["cnt"] >= min_hits) \
            & (s["wsum"] >= min_wt)
        return emit, (s["first_pos"], s["last_match"] + (K - 1), s["cnt"],
                      s["current"], s["wsum"])

    def apply_flush(s, fire):
        reseed = (fire & (s["num_hits"] >= 2)
                  & (s["prev2_fi"] != s["current"])
                  & (s["prev2_fi"] == s["prev_fi"]))
        clear = fire & ~reseed
        return dict(
            s,
            current=where(reseed, s["prev_fi"], s["current"]),
            num_hits=where(reseed, 2, where(clear, 0, s["num_hits"])),
            cnt=where(reseed, 2, where(clear, 0, s["cnt"])),
            wsum=where(reseed, s["prev2_wt"] + s["prev_wt"],
                       where(clear, zf, s["wsum"])),
            first_pos=where(reseed, s["prev2_pos"], s["first_pos"]),
            last_match=where(reseed, s["prev_pos"], s["last_match"]))

    ys = []
    for t in range(W):
        h, f, a, w = found[:, t], fi[:, t], av[:, t], wt[:, t]
        posb = base + t
        # gap handling (kguts.cc:821-831)
        gap = h & (s["num_hits"] > 0) & (s["prev_pos"] + max_gap < posb)
        gf_flush = gap & (s["num_hits"] >= min_hits)
        gf_reset = gap & ~gf_flush
        emit_a, call_a = flush_fields(s)
        emit_a = emit_a & gf_flush
        s = apply_flush(s, gf_flush)
        s = dict(s, num_hits=where(gf_reset, 0, s["num_hits"]),
                 cnt=where(gf_reset, 0, s["cnt"]),
                 wsum=where(gf_reset, zf, s["wsum"]))
        # current_fI seeding (kguts.cc:833-836)
        was0 = s["num_hits"] == 0
        cur = where(h & was0, f, s["current"])
        # admission (kguts.cc:838-842): signed drift in [0, 20]
        if order_constraint:
            drift = (posb - s["prev_pos"]) - (s["prev_av"] - a)
            admit = h & (was0 | ((f == s["prev_fi"]) & (drift >= 0)
                                 & (drift <= 20)))
        else:
            admit = h
        # append (kguts.cc:844-851)
        am = admit & (f == cur)
        s = dict(
            s, current=cur,
            num_hits=where(admit, s["num_hits"] + 1, s["num_hits"]),
            first_pos=where(admit & was0, posb, s["first_pos"]),
            cnt=where(am, s["cnt"] + 1, s["cnt"]),
            wsum=where(am, s["wsum"] + w, s["wsum"]),
            last_match=where(am, posb, s["last_match"]),
            prev2_fi=where(admit, s["prev_fi"], s["prev2_fi"]),
            prev2_pos=where(admit, s["prev_pos"], s["prev2_pos"]),
            prev2_wt=where(admit, s["prev_wt"], s["prev2_wt"]),
            prev_fi=where(admit, f, s["prev_fi"]),
            prev_pos=where(admit, posb, s["prev_pos"]),
            prev_av=where(admit, a, s["prev_av"]),
            prev_wt=where(admit, w, s["prev_wt"]))
        # two-in-a-row flush (kguts.cc:852-856)
        tir = (admit & (s["num_hits"] > 1) & (cur != f)
               & (s["prev2_fi"] == f))
        emit_b, call_b = flush_fields(s)
        emit_b = emit_b & tir
        s = apply_flush(s, tir)
        if want_emit:
            ys.append((emit_a | emit_b,) + tuple(
                where(emit_a, x, y) for x, y in zip(call_a, call_b)))
    if not want_emit:
        return None, None, s

    # end-of-sequence flush (kguts.cc:873-875)
    emit_f, call_f = flush_fields(s)
    emit_f = emit_f & (s["num_hits"] >= min_hits)
    if final_flush is not None:
        emit_f = emit_f & final_flush
    cols = [torch.stack([y[j] for y in ys] + [last], dim=1)
            for j, last in enumerate((emit_f,) + call_f)]
    return cols[0], cols[1:], s


def _check_inputs(found, fi, av, wt, init, pos0, final_flush):
    B, W = found.shape
    if found.dtype != torch.bool:
        raise TypeError("found must be bool")
    if fi.dtype != torch.int32 or av.dtype != torch.int32:
        raise TypeError("fi and av must be int32")
    if wt.dtype != torch.float32:
        raise TypeError("wt must be float32")
    if fi.shape != (B, W) or av.shape != (B, W) or wt.shape != (B, W):
        raise ValueError("found, fi, av and wt must share one [B, W] shape")
    tensors = [found, fi, av, wt]
    if init is not None:
        for k in INT_FIELDS + FLOAT_FIELDS:
            want = torch.int32 if k in INT_FIELDS else torch.float32
            if init[k].dtype != want or init[k].shape != (B,):
                raise ValueError(f"init[{k!r}] must be {want} of shape [B]")
            tensors.append(init[k])
    if pos0 is not None:
        if pos0.shape != (B,) or pos0.dtype != torch.int32:
            raise ValueError("pos0 must be int32 of shape [B]")
        tensors.append(pos0)
    if final_flush is not None:
        if final_flush.shape != (B,) or final_flush.dtype != torch.bool:
            raise ValueError("final_flush must be bool of shape [B]")
        tensors.append(final_flush)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    return devs.pop()


def scan_score(found, fi, av, wt, min_hits, min_weighted_hits, max_gap,
               order_constraint, init=None, pos0=None, want_emit=True,
               final_flush=None):
    """:func:`scan_score_plain`'s contract; launches the CUDA kernel
    when the tensors lie on the card.  Raises on a bad device, dtype or
    shape."""
    dev = _check_inputs(found, fi, av, wt, init, pos0, final_flush)
    if dev.type == "cpu":
        return scan_score_plain(found, fi, av, wt, min_hits,
                                min_weighted_hits, max_gap, order_constraint,
                                init, pos0, want_emit, final_flush)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    B, W = found.shape
    # [W, B] inputs: neighbouring threads (sequences) read neighbouring
    # addresses at every step
    ins = [x.t().contiguous() for x in (found, fi, av, wt)]
    init_i = init_f = None
    if init is not None:
        init_i = torch.stack([init[k] for k in INT_FIELDS]).contiguous()
        init_f = torch.stack([init[k] for k in FLOAT_FIELDS]).contiguous()
    pos0 = pos0.contiguous() if pos0 is not None else None
    final_flush = final_flush.contiguous() if final_flush is not None \
        else None
    outs = [None] * 6
    if want_emit:
        outs = [torch.empty((W + 1, B), dtype=dt, device=dev)
                for dt in (torch.bool,) + (torch.int32,) * 4
                + (torch.float32,)]
    out_i = torch.empty((len(INT_FIELDS), B), dtype=torch.int32, device=dev)
    out_f = torch.empty((len(FLOAT_FIELDS), B), dtype=torch.float32,
                        device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.kernel("ck_scan_score", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(*(x.data_ptr() for x in ins), B, W, ptr(init_i),
                ptr(init_f), ptr(pos0), ptr(final_flush), int(min_hits),
                int(min_weighted_hits), int(max_gap), int(order_constraint),
                int(bool(want_emit)), *(ptr(o) for o in outs),
                out_i.data_ptr(), out_f.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_scan_score")
    scan_score.launches += 1
    state = {k: out_i[j] for j, k in enumerate(INT_FIELDS)}
    state.update({k: out_f[j] for j, k in enumerate(FLOAT_FIELDS)})
    if not want_emit:
        return None, None, state
    emit, *fields = (o.t().contiguous() for o in outs)
    return emit, fields, state


scan_score.launches = 0
