"""Probe-gather experiments on the card: the floors under the probe's
random row reads, and the probe layouts, selections and sorts they bear
on.  Port of ``scripts/gather_exp.py``, every experiment of its ``main``
under its name.

    python -m close_kmers_tpu_torch.scripts.gather_exp [exp ...]

Experiments (default: xla111 xla128 xla32 xla8 dma_gather), in the JAX
script's order, each with what it asks of this card:

  xla8 xla32 xla111 xla128  the plain gather ``table[idx]`` at row width
                            8 / 32 / 111 / 128 int32: what a row costs
  width1 (width1_bitmap)    a one-int gather from a 3.2M table, then one
                            bit of a packed bitmap: does a presence test
                            cost less than the probe's row?
  probe_planes192           the payload-wide selection on rows whose six
                            planes start on 32-int boundaries: does
                            alignment cut the selection?
  gsort15m                  the family global pack's stable argsort of
                            14.96M flags: what the compaction sort costs
  probe111 probe128         the payload-wide probe (gather + match + four
                            masked sums) on rows of 111 and 128 ints
  probe_fused64/128         fused rows [start | fi<<13|lo | wt]: one
                            gather for fi and wt, 64 or 128 ints wide
  probe128b                 the selection as one [N, 5, W] masked reduce
  probepal                  the probe_select kernel on 128-int rows (the
                            JAX script's Pallas select_wide_rows)
  deepcmp                   a PATRIC-density DB (20M keys over 64,000 hi
                            buckets) probed through the sub_blocks tier
                            and through the binary search, whose outputs
                            must be equal
  scale_bin scale_csr       at EXP_SCALE_KEYS keys (208M) over 3.2M
  slice128 slice256         buckets: the binary search, a CSR slice probe
  scale_wide scale_fused    (pair + one Ws-wide slice + payload), the
  scale_pay                 slices alone, lo_wide rows + payload, fused
                            rows, the narrow payload gather alone
  pf0 pf1 pf2 pf3           the probe stage's extras on [B, W] inputs:
                            valid masking, the found/where finish, [B, W]
                            outputs
  pf0f pf0p                 pf0 on flat inputs, and on W padded to 384
  pfcross (sel_on_pfdata)   probe128's code on pf0f's arrays
  sortflat_bad/_good        the call-compaction argsort at 2,498,560 and
                            2,498,568 flags (the v5e's size cliff)
  rowsort_bad/_odd          the family rollup's 3-operand row sort at
                            rows of 912 and 917
  probe2g                   two narrow gathers: a 32-int lo row, then an
                            8-int payload row
  dma_gather                the hand-written row gather, cp.async rings
                            (the JAX script's ``pallas``), width 128
  xsort xargsort xsortpair  a sort, an argsort and a key + payload sort
                            of 2.49M int32
  xla128s xla128u           the width-128 gather with sorted ids, then
                            the same ids unsorted
  xsort3 (xsort6)           a sort of a key and 2 payloads, then of 6
                            operands: the unsort step of a sorted probe
  vgather                   gathers from a tile held in shared memory
  hbmstream                 a sequential stream of the table (GB/s)
  dmaflush                  32,768 scattered 4 KB block writes, then
                            the same by one index_copy_

The XLA experiments are plain torch, their arithmetic and shapes kept
(the 128-int pads, the cliff sizes); probepal launches the probe_select
kernel, on rows whose lo slots are distinct, as a DB's are (the kernel
selects the one match, where the JAX script's random rows repeat lo
values and its masked sums add every match).  Each body is a function
of tensors that returns the JAX body's check value (:data:`BODIES`).

Sizes: EXP_ROWS table rows (3.2M), EXP_IDX probes per call (2.49M),
EXP_DEEP_KEYS / EXP_DEEP_SPAN for deepcmp, EXP_SCALE_KEYS for the scale
experiments.  Each line is one call's time from CUDA events, (t(K_HI
calls) - t(K_LO calls)) / (K_HI - K_LO) back to back, after two warm-up
calls, with ns per probe over EXP_IDX, as the JAX script prints it.
Tables and ids are made on the card from a seeded ``torch.Generator``;
deepcmp's DB is built on the host (``DeviceDB.from_db`` lays out numpy
tables).  Needs a CUDA card.
"""

from __future__ import annotations

import functools
import math
import os
import sys
import time

import numpy as np
import torch

from .. import params
from ..core.engine import (FUSED_SENTINEL, JAX_TIER_FLAGS, DeviceDB,
                           _lane_pad, probe_windows, stable_true_first)
from ..db.signature_db import SignatureDB
from ..ops import gather_exp as gx
from ..ops.probe_select import probe_select
from ..utils.device import gpu_name_and_power_limit, resolve_device

N_ROWS = int(os.environ.get("EXP_ROWS", 3_200_000))    # table rows
N_IDX = int(os.environ.get("EXP_IDX", 2_490_000))      # probes per call
EXP_DEEP_KEYS = int(os.environ.get("EXP_DEEP_KEYS", 20_000_000))
EXP_DEEP_SPAN = int(os.environ.get("EXP_DEEP_SPAN", 64_000))
EXP_SCALE_KEYS = int(os.environ.get("EXP_SCALE_KEYS", 208_000_000))
K_HI = 10
K_LO = 4

SCALE_EXPERIMENTS = ("scale_bin", "scale_csr", "slice128", "slice256",
                     "scale_wide", "scale_fused", "scale_pay")
EXPERIMENTS = ("xla8", "xla32", "xla111", "xla128", "width1",
               "width1_bitmap", "probe_planes192", "gsort15m", "probe111",
               "probe128", "probe_fused64", "probe_fused128", "probe128b",
               "probepal", "deepcmp", *SCALE_EXPERIMENTS, "pf0", "pf1",
               "pf2", "pf3", "pf0f", "pf0p", "pfcross", "sortflat_bad",
               "sortflat_good", "rowsort_bad", "rowsort_odd", "probe2g",
               "dma_gather", "xsort", "xargsort", "xsortpair", "xla128s",
               "xla128u", "xsort3", "xsort6", "vgather", "hbmstream",
               "dmaflush")
DEFAULT = ("xla111", "xla128", "xla32", "xla8", "dma_gather")
# the experiments a default chip_smoke.py run leaves to --gather-exp
FLAGGED = SCALE_EXPERIMENTS + ("gsort15m",)
VGATHER_CHUNK = 2048
HBM_BLK = 2048
FLUSH_DMAS, FLUSH_RPD, FLUSH_PER_PROG = 32768, 8, 256  # 4 KB per copy
WD = 22          # the query DB's deepest bucket: the probes' plane width
PW = 32          # probe_planes192's plane stride
FUSED_MASK = 0x1FFF
PF_B = 8192      # the pf and sort experiments' batch rows
SCALE_H = 3_200_000
SCALE_WS = 256


def measure(name: str, fn) -> float:
    """Seconds per call of ``fn`` (which returns a scalar tensor) on the
    card, from CUDA events over K_LO and K_HI back-to-back calls,
    differenced; prints the JAX script's line."""
    def run(k):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            c = fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3, float(c)

    t0 = time.time()
    run(2)
    print(f"  [{name}: warm {time.time() - t0:.1f}s]", flush=True)
    t_lo, _ = run(K_LO)
    t_hi, v = run(K_HI)
    per = (t_hi - t_lo) / (K_HI - K_LO)
    print(f"{name:12s} {per * 1000:8.2f} ms/call  {per / N_IDX * 1e9:6.2f} "
          f"ns/row (check {v:.3g})", flush=True)
    return per


def isum(x) -> torch.Tensor:
    """The JAX bodies' ``x.sum().astype(float32)`` of an int or bool
    array: the int32 (wrapping) sum, as f32."""
    return x.sum(dtype=torch.int32).to(torch.float32)


def sum4(rows):
    """The JAX experiments' check value of gathered rows: the int32
    (wrapping) sum of their first four columns, as f32."""
    return isum(rows[:, :4])


def flush_by_index_copy(dst, buf, rows_per_dma: int):
    """dmaflush's function as one PyTorch call: ``index_copy_`` of the
    blocks (``buf``'s slots repeated for every program, made beforehand)
    into their destination blocks.  Returns the call, which returns its
    output as dmaflush lays it out."""
    blocks = buf.reshape(dst.shape[1], -1).repeat(dst.shape[0], 1)
    flat = dst.reshape(-1).long()
    out = torch.empty_like(blocks)
    return lambda: out.index_copy_(0, flat, blocks).view(-1, buf.shape[1])


def xla_gather(table, idx):
    """The plain gather experiment (the JAX script's ``xla_gather``)."""
    return sum4(table[idx.long()])


def _first(match):
    """``jnp.argmax(match, axis=-1)`` as int32: the first True (0 when
    none)."""
    return match.to(torch.int32).argmax(dim=-1).to(torch.int32)


def _picks(row, m, base: int, stride: int, wd: int, planes):
    """The masked int32 sums of ``planes`` of ``row``, plane p at columns
    base + p * stride .. + wd, under the match mask ``m``."""
    return [(row[:, base + p * stride:base + p * stride + wd] * m).sum(
        dim=-1, dtype=torch.int32) for p in planes]


def probe_select_body(wd: int, table, idx, lo_q):
    """probe111 / probe128 / sel_on_pfdata (the JAX ``probe_select``):
    gather the payload-wide rows, match lo, four masked sums, the
    matched row."""
    row = table[idx.long()]
    left = row[:, 0]
    match = row[:, 1:1 + wd] == lo_q[:, None]
    found = match.any(dim=-1)
    fi, oi, av, wtb = _picks(row, match.to(torch.int32), 1 + wd, wd, wd,
                             range(4))
    idx2 = torch.where(found, left + _first(match), 0)
    return (isum(torch.where(found, fi, -1)) + isum(torch.where(found, oi, -1))
            + isum(av) + wtb.view(torch.float32).sum() + isum(idx2))


def probe_two_gather(wd: int, lo_tab, pay_tab, idx, lo_q):
    """probe2g: a narrow lo row locates the match, a second gather reads
    its 4-int payload row."""
    row = lo_tab[idx.long()]
    left = row[:, 0]
    match = row[:, 1:1 + wd] == lo_q[:, None]
    found = match.any(dim=-1)
    ridx = torch.where(found, left + _first(match), pay_tab.shape[0] - 1)
    pay = pay_tab[ridx.long()]
    return (isum(torch.where(found, pay[:, 0], -1))
            + pay[:, 3].contiguous().view(torch.float32).sum()
            + isum(pay[:, 2]))


def width1_body(table, idx):
    """width1: one int a probe from a [N_ROWS] table."""
    return isum(table[idx.long()])


def width1_bitmap_body(table, idx):
    """width1_bitmap: one bit a probe from a packed bitmap (32 buckets an
    int32, word idx >> 5, bit idx & 31)."""
    w = table[(idx >> 5).long()]
    return isum((w >> (idx & 31)) & 1)


def planes192_body(table, idx, lo_q):
    """probe_planes192: the selection on rows of six 32-int planes
    [start | lo | fi | oi | avg_off | wt], each plane WD wide."""
    row = table[idx.long()]
    left = row[:, 0]
    match = row[:, PW:PW + WD] == lo_q[:, None]
    found = match.any(dim=-1)
    fif, oif, avf, wtb = _picks(row, match.to(torch.int32), 2 * PW, PW, WD,
                                range(4))
    return (isum(torch.where(found, fif, -1)) + isum(oif) + isum(avf)
            + wtb.view(torch.float32).sum() + isum(left + _first(match)))


def compact_sort_body(take: int, emit, vals):
    """gsort15m / sortflat_*: the stable argsort that puts the ``emit``
    flags first, its first ``take`` entries' values summed."""
    return isum(vals[stable_true_first(emit)[:take]])


def fused_body(wd: int, table, idx, lo_q):
    """probe_fused64/128: rows [start | (fi << 13 | lo) x wd | wt x wd]:
    fi and wt from one gather."""
    row = table[idx.long()]
    left = row[:, 0]
    packed = row[:, 1:1 + wd]
    match = (packed & FUSED_MASK) == lo_q[:, None]
    found = match.any(dim=-1)
    m = match.to(torch.int32)
    fi = torch.where(found, (packed * m).sum(dim=-1, dtype=torch.int32) >> 13,
                     -1)
    wt = (row[:, 1 + wd:1 + 2 * wd] * m).sum(
        dim=-1, dtype=torch.int32).view(torch.float32)
    idx2 = torch.where(found, left + _first(match), 0)
    return (isum(fi) + torch.where(found, wt, 0.0).sum() + isum(idx2))


def probe128b_body(table, idx, lo_q):
    """probe128b: the selection as one [N, 5, WD] masked reduce."""
    row = table[idx.long()]
    left = row[:, 0]
    planes = row[:, 1:1 + 5 * WD].reshape(-1, 5, WD)
    match = planes[:, 0, :] == lo_q[:, None]
    found = match.any(dim=-1)
    picks = (planes * match.to(torch.int32)[:, None, :]).sum(
        dim=-1, dtype=torch.int32)
    idx2 = torch.where(found, left + _first(match), 0)
    return (isum(torch.where(found, picks[:, 1], -1))
            + isum(torch.where(found, picks[:, 2], -1)) + isum(picks[:, 3])
            + picks[:, 4].contiguous().view(torch.float32).sum()
            + isum(idx2))


def probepal_body(table, idx, lo_q):
    """probepal: the probe_select kernel (the CUDA port of the Pallas
    select_wide_rows) on payload-wide rows of WD-wide planes, each window
    reading row ``idx``; the JAX body's check value of its six planes."""
    valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    found, fi, oi, av, wt, ix = probe_select(idx, lo_q, valid, table, WD,
                                             table.shape[0])
    return (isum(fi) + isum(oi) + isum(av) + wt.sum()
            + isum(torch.where(found, ix, 0)))


def slice_body(ws: int, lo_pad, starts):
    """slice128 / slice256: a ``ws``-wide slice of the flat lo array at
    each start (``lax.dynamic_slice``, its start clamped into the
    array), the first four columns summed."""
    return isum(_slices(lo_pad, starts, ws)[:, :4])


def _slices(lo_pad, starts, ws: int):
    """[N, ws] slices of ``lo_pad`` at ``starts``, each start clamped into
    [0, len - ws] (``lax.dynamic_slice``): rows of its unfolded view."""
    s = starts.clamp(0, lo_pad.shape[0] - ws).long()
    return lo_pad.unfold(0, ws, 1)[s]


def csr_body(ws: int, pair, lo_pad, payload, hi_q, lo_q):
    """scale_csr: the bucket pair, one ``ws``-wide slice of the flat lo
    array from its start, the match within the bucket, the payload row."""
    pr = pair[hi_q.long()]
    start, end = pr[:, 0], pr[:, 1]
    sl = _slices(lo_pad, start, ws)
    j = torch.arange(ws, dtype=torch.int32, device=sl.device)
    match = (sl == lo_q[:, None]) & (j[None, :] < (end - start)[:, None])
    found = match.any(dim=-1)
    ridx = torch.where(found, start + _first(match), payload.shape[0] - 1)
    pay = payload[ridx.long()]
    return (isum(found) + isum(pay[:, 0])
            + pay[:, 3].contiguous().view(torch.float32).sum())


def bin_body(n_steps: int, n: int, pair, lo_pad, payload, hi_q, lo_q):
    """scale_bin: ``n_steps`` halvings over the bucket's slice of the
    flat lo array (the reference's midpoint (left + right) >> 1: no
    bucket here starts near 2^30), then the payload row."""
    pr = pair[hi_q.long()]
    left, end = pr[:, 0], pr[:, 1]
    right = end
    for _ in range(n_steps):
        cont = left < right
        mid = (left + right) >> 1
        v = lo_pad[mid.clamp(max=n).long()]
        go_right = cont & (v < lo_q)
        left, right = (torch.where(go_right, mid + 1, left),
                       torch.where(cont & ~go_right, mid, right))
    idxr = left.clamp(max=n)
    found = (left < end) & (lo_pad[idxr.long()] == lo_q)
    pay = payload[torch.where(found, idxr, n).long()]
    return (isum(found) + isum(pay[:, 0])
            + pay[:, 3].contiguous().view(torch.float32).sum())


def wide_body(max_b: int, lw, payload, hi_q, lo_q):
    """scale_wide: lo_wide rows [start | lo x max_b], then the payload
    row."""
    row = lw[hi_q.long()]
    left = row[:, 0]
    match = row[:, 1:1 + max_b] == lo_q[:, None]
    found = match.any(dim=-1)
    ridx = torch.where(found, left + _first(match), payload.shape[0] - 1)
    pay = payload[ridx.long()]
    return (isum(found) + isum(pay[:, 0])
            + pay[:, 3].contiguous().view(torch.float32).sum())


def scale_fused_body(max_b: int, n: int, fw, hi_q, lo_q):
    """scale_fused: fused rows [start | (fi << 13 | lo) x max_b | wt x
    max_b], no payload gather."""
    row = fw[hi_q.long()]
    left = row[:, 0]
    packed = row[:, 1:1 + max_b]
    match = (packed & FUSED_MASK) == lo_q[:, None]
    found = match.any(dim=-1)
    m = match.to(torch.int32)
    fi = torch.where(found, (packed * m).sum(dim=-1, dtype=torch.int32) >> 13,
                     -1)
    wt = (row[:, 1 + max_b:1 + 2 * max_b] * m).sum(
        dim=-1, dtype=torch.int32).view(torch.float32)
    idx2 = torch.where(found, left + _first(match), n)
    return (isum(found) + isum(fi) + torch.where(found, wt, 0.0).sum()
            + isum(idx2))


def pf_body(level: int, n_rows: int, table, hi, lo, valid):
    """pf0-pf3: the flat gather + selection on [B, W] inputs (pf0),
    with valid masking (pf1), the found/where finish (pf2), outputs
    shaped [B, W] before the sums (pf3); ``n_rows`` is the miss idx."""
    if level >= 1:
        hi = torch.where(valid, hi, 0)
        lo = torch.where(valid, lo, -2)
    row = table[hi.reshape(-1).long()]
    left = row[:, 0]
    match = row[:, 1:1 + WD] == lo.reshape(-1)[:, None]
    foundf = match.any(dim=-1)
    fif, oif, avf, wtb = _picks(row, match.to(torch.int32), 1 + WD, WD, WD,
                                range(4))
    idxf = left + _first(match)
    if level >= 2:
        sh = hi.shape if level >= 3 else (-1,)
        found = valid.reshape(sh) & foundf.reshape(sh)
        fi = torch.where(found, fif.reshape(sh), -1)
        oi = torch.where(found, oif.reshape(sh), -1)
        wt = wtb.reshape(sh).view(torch.float32)
        ix = torch.where(found, idxf.reshape(sh), n_rows)
        return (isum(fi) + isum(oi) + isum(avf.reshape(sh)) + wt.sum()
                + isum(ix))
    return (isum(torch.where(foundf, fif, -1)) + isum(oif) + isum(avf)
            + wtb.view(torch.float32).sum() + isum(idxf))


def rowsort_body(key, wt, pos):
    """rowsort_*: the stable row-local sort of (key, wt, pos) by key."""
    sk, perm = torch.sort(key, dim=1, stable=True)
    return (isum(sk[:, :4]) + wt.gather(1, perm)[:, :4].sum()
            + isum(pos.gather(1, perm)[:, :4]))


def _sort_by(k, *vals):
    """``lax.sort((k, *vals), num_keys=1)``: stable by k."""
    ks, perm = torch.sort(k, stable=True)
    return (ks, *(v[perm] for v in vals))


def xsort_body(v):
    return isum(torch.sort(v)[0][::65536])


def xargsort_body(v):
    return isum(torch.argsort(v, stable=True)[::65536])


def xsortpair_body(k, v):
    ks, vs = _sort_by(k, v)
    return isum(ks[::65536]) + isum(vs[::65536])


def xsort3_body(k, v1, v2):
    ks, v1s, v2s = _sort_by(k, v1, v2)
    return isum(ks[::65536]) + isum(v1s[::65536]) + isum(v2s[::65536])


def xsort6_body(k, v1, v2):
    """The six operands (k, v1, v2, v2, v1, k) sorted by the first."""
    outs = _sort_by(k, v1, v2, v2, v1, k)
    total = isum(outs[0][::65536])
    for o in outs[1:]:
        total = total + isum(o[::65536])
    return total


# measured name -> the body, with the JAX body's arguments after c
BODIES = {
    "width1": width1_body, "width1_bitmap": width1_bitmap_body,
    "probe_planes192": planes192_body,
    "gsort15m": functools.partial(compact_sort_body, 2 * 16384),
    "probe111": functools.partial(probe_select_body, WD),
    "probe128": functools.partial(probe_select_body, WD),
    "probe_fused64": functools.partial(fused_body, WD),
    "probe_fused128": functools.partial(fused_body, WD),
    "probe128b": probe128b_body, "probepal": probepal_body,
    "slice128": functools.partial(slice_body, 128),
    "slice256": functools.partial(slice_body, 256),
    "scale_csr": functools.partial(csr_body, SCALE_WS),
    "scale_pay": xla_gather,
    "pf0f": functools.partial(pf_body, 0, None),
    "pf0p": functools.partial(pf_body, 0, None),
    "sel_on_pfdata": functools.partial(probe_select_body, WD),
    "sortflat_bad": functools.partial(compact_sort_body, PF_B * 4),
    "sortflat_good": functools.partial(compact_sort_body, PF_B * 4),
    "rowsort_bad": rowsort_body, "rowsort_odd": rowsort_body,
    "probe2g": functools.partial(probe_two_gather, WD),
    "xsort": xsort_body, "xargsort": xargsort_body,
    "xsortpair": xsortpair_body, "xsort3": xsort3_body,
    "xsort6": xsort6_body,
}


def probe_sum(ddb: DeviceDB, hi, lo, valid):
    """deepcmp's check value of one probe: the int32 sums of fi and
    found plus the f32 sum of wt."""
    found, fi, _oi, _av, wt, _idx = probe_windows(ddb, hi, lo, valid)
    return (fi.sum(dtype=torch.int32).float() + wt.sum()
            + found.sum(dtype=torch.int32).float())


def deep_db(n_keys: int = EXP_DEEP_KEYS, hi_span: int = EXP_DEEP_SPAN,
            seed: int = 0) -> SignatureDB:
    """deepcmp's DB (the JAX script's, from a numpy seed): ``n_keys``
    random (hi, lo) codes over ``hi_span`` hi buckets (~312 keys per
    bucket at the defaults, PATRIC density), 4,096 functions."""
    rng = np.random.default_rng(seed)
    his = rng.integers(0, hi_span, size=n_keys, dtype=np.int64)
    los = rng.integers(0, params.LO_CARD, size=n_keys, dtype=np.int64)
    # np.unique by a sort: NumPy 2.3's np.unique takes ~40 s on these 20M
    # int64 codes (its hash-based path), np.sort ~0.3 s
    codes = np.sort(his * params.LO_CARD + los)
    keys = codes[np.concatenate(([True], codes[1:] != codes[:-1]))]
    return SignatureDB(
        keys,
        rng.integers(0, 4096, size=len(keys)).astype(np.int32),
        rng.integers(-1, 64, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
        functions=[f"function {i}" for i in range(4096)])


def deepcmp(db: SignatureDB, device, gen: torch.Generator,
            hi_span: int = EXP_DEEP_SPAN) -> dict:
    """Probe N_IDX random in-span (hi, lo) windows through the sub_blocks
    tier (``deep_sub``, the JAX package's auto pick for this DB, forced by
    its flags) and the binary search (``deep_bin``, ``from_db(sub=False)``);
    raises unless all six output planes are equal.  Returns seconds per
    call by name."""
    print(f"deep DB: {len(db):,} keys, max bucket {db.max_bucket}",
          flush=True)
    q_hi = torch.randint(0, hi_span, (1, N_IDX), generator=gen,
                         device=device, dtype=torch.int32)
    q_lo = torch.randint(0, params.LO_CARD, (1, N_IDX), generator=gen,
                         device=device, dtype=torch.int32)
    valid = torch.ones((1, N_IDX), dtype=torch.bool, device=device)
    outs, per = {}, {}
    for name, kw in (("deep_sub", JAX_TIER_FLAGS["sub_blocks"]),
                     ("deep_bin", dict(sub=False))):
        d = DeviceDB.from_db(db, device, **kw)
        blocks = None if d.sub_blocks is None else tuple(d.sub_blocks.shape)
        print(f"  [{name}: tier {d.tier}, sub_blocks={blocks} "
              f"n_steps={d.n_steps}]", flush=True)
        outs[name] = [x.cpu() for x in probe_windows(d, q_hi, q_lo, valid)]
        per[name] = measure(name, lambda: probe_sum(d, q_hi, q_lo, valid))
        del d
    for a, b in zip(outs["deep_sub"], outs["deep_bin"]):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise RuntimeError("deep_sub and deep_bin probes differ")
    print(f"  deep_sub == deep_bin on {N_IDX:,} windows "
          f"({int(outs['deep_sub'][0].sum()):,} found)", flush=True)
    return per


def distinct_lo_rows(gen, n_rows: int, width: int, wd: int, device):
    """A [n_rows, width] table of random ints in [0, 100) whose columns
    1..wd (the lo plane) hold distinct values in each row, as a DB's
    payload-wide rows do: (base + j * step) % 100 with a random base and
    a random step prime to 100."""
    tbl = torch.randint(0, 100, (n_rows, width), generator=gen,
                        device=device, dtype=torch.int32)
    steps = torch.tensor([s for s in range(1, 100) if math.gcd(s, 100) == 1],
                         dtype=torch.int32, device=device)
    base = torch.randint(0, 100, (n_rows, 1), generator=gen, device=device,
                         dtype=torch.int32)
    step = steps[torch.randint(0, len(steps), (n_rows, 1), generator=gen,
                               device=device)]
    j = torch.arange(wd, dtype=torch.int32, device=device)
    tbl[:, 1:1 + wd] = (base + j[None, :] * step) % 100
    return tbl


def scale_tables(n_keys: int, gen, device) -> dict:
    """The scale experiments' DB as the JAX script synthesizes it
    (gather_exp.py:541-569), made on the card: Poisson(n_keys / H) keys
    in each of H = 3.2M buckets, random lo codes sorted within a bucket,
    the bucket pairs, the flat lo array padded by SCALE_WS slots of -9, a
    [n + 1, 4] payload of 7s, N_IDX random (hi, lo) probes and slice
    starts."""
    H = SCALE_H

    def randint(high, size):
        return torch.randint(0, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    cnt = torch.poisson(torch.full((H,), n_keys / H, device=device),
                        generator=gen).to(torch.int64)
    n = int(cnt.sum())
    max_b = int(cnt.max())
    bucket_start = torch.zeros(H + 1, dtype=torch.int64, device=device)
    torch.cumsum(cnt, 0, out=bucket_start[1:])
    seg = torch.repeat_interleave(torch.arange(H, device=device), cnt)
    los = randint(params.LO_CARD, (n,))
    los = (torch.sort(seg * params.LO_CARD + los)[0] % params.LO_CARD).to(
        torch.int32)
    rank = torch.arange(n, device=device) - bucket_start[:-1][seg]
    pair = torch.stack([bucket_start[:-1], bucket_start[1:]], 1).to(
        torch.int32)
    lo_pad = torch.cat([los, torch.full((SCALE_WS,), -9, dtype=torch.int32,
                                        device=device)])
    payload = torch.full((n + 1, 4), 7, dtype=torch.int32, device=device)
    return dict(n=n, max_b=max_b, cnt=cnt, seg=seg, rank=rank, los=los,
                bucket_start=bucket_start, pair=pair, lo_pad=lo_pad,
                payload=payload, q_hi=randint(H, (N_IDX,)),
                q_lo=randint(params.LO_CARD, (N_IDX,)),
                starts=randint(n - SCALE_WS, (N_IDX,)))


def scale_wide_table(t: dict) -> torch.Tensor:
    """lo_wide rows over the scale DB: [H, lane_pad(1 + max_b)], start
    then the bucket's lo codes, 2^30 in the empty slots."""
    row_w = _lane_pad(1 + t["max_b"])
    lw = torch.full((SCALE_H, row_w), 2 ** 30, dtype=torch.int32,
                    device=t["los"].device)
    lw[:, 0] = t["bucket_start"][:-1].to(torch.int32)
    lw.view(-1)[t["seg"] * row_w + 1 + t["rank"]] = t["los"]
    return lw


def scale_fused_table(t: dict, gen) -> torch.Tensor:
    """Fused rows over the scale DB: [H, lane_pad(1 + 2 max_b)], start,
    (fi << 13 | lo) x max_b, wt bits x max_b (fi random below 2,000, wt
    uniform in [0.1, 4)), FUSED_SENTINEL in the empty slots."""
    max_b, dev = t["max_b"], t["los"].device
    row_w = _lane_pad(1 + 2 * max_b)
    fw = torch.full((SCALE_H, row_w), FUSED_SENTINEL, dtype=torch.int32,
                    device=dev)
    fw[:, 0] = t["bucket_start"][:-1].to(torch.int32)
    n = t["n"]
    fis = torch.randint(0, 2000, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    wts = (torch.rand(n, generator=gen, device=dev) * 3.9 + 0.1).view(
        torch.int32)
    base = t["seg"] * row_w + 1 + t["rank"]
    flat = fw.view(-1)
    flat[base] = (fis << 13) | t["los"]
    flat[base + max_b] = wts
    return fw


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the experiments time the card: use a CUDA device")
    return device


def run(which, device, seed: int = 0, deep: SignatureDB | None = None
        ) -> dict:
    """The experiments named in ``which`` on ``device`` (a card), in the
    JAX script's order; prints their lines and returns seconds per call
    by name.  ``deep``: deepcmp's DB, when the caller has built it."""
    which = set(which)
    unknown = which - set(EXPERIMENTS)
    if unknown:
        raise ValueError(
            f"unknown experiments {sorted(unknown)}; this port runs "
            f"{', '.join(EXPERIMENTS)}")
    device = _card(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(high, size):
        return torch.randint(0, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    def rand(size):
        return torch.rand(size, generator=gen, device=device)

    per = {}

    def timed(name, body, *args):
        per[name] = measure(name, lambda: body(*args))

    idx = randint(N_ROWS, (N_IDX,))
    print(f"table {N_ROWS:,} rows, {N_IDX:,} probes", flush=True)
    for name, width in (("xla8", 8), ("xla32", 32), ("xla111", 111),
                        ("xla128", 128)):
        if name in which:
            tbl = randint(100, (N_ROWS, width))
            timed(name, xla_gather, tbl, idx)
            del tbl

    if "width1" in which:
        timed("width1", width1_body, randint(2, (N_ROWS,)), idx)
    if "width1_bitmap" in which or "width1" in which:
        timed("width1_bitmap", width1_bitmap_body,
              randint(2 ** 31, (N_ROWS // 32 + 1,)), idx)

    if "probe_planes192" in which:
        tbl = torch.full((N_ROWS, 6 * PW), -9, dtype=torch.int32,
                         device=device)
        tbl[:, 0] = randint(100, (N_ROWS,))
        for p in range(5):
            tbl[:, PW * (p + 1):PW * (p + 1) + WD] = randint(100,
                                                             (N_ROWS, WD))
        timed("probe_planes192", planes192_body, tbl, idx,
              randint(100, (N_IDX,)))
        del tbl

    if "gsort15m" in which:
        n15 = 16384 * (304 * 3 + 1)
        timed("gsort15m", BODIES["gsort15m"], rand(n15) < 0.002,
              randint(100, (n15,)))

    lo_q = randint(100, (N_IDX,))
    for name, width in (("probe111", 1 + 5 * WD), ("probe128", 128)):
        if name in which:
            tbl = randint(100, (N_ROWS, width))
            timed(name, BODIES[name], tbl, idx, lo_q)
            del tbl

    for name, width in (("probe_fused64", 64), ("probe_fused128", 128)):
        if name in which:
            tbl = torch.full((N_ROWS, width), (1 << 30) | FUSED_MASK,
                             dtype=torch.int32, device=device)
            tbl[:, 0] = randint(100, (N_ROWS,))
            tbl[:, 1:1 + WD] = (randint(2000, (N_ROWS, WD)) << 13) \
                | randint(100, (N_ROWS, WD))
            tbl[:, 1 + WD:1 + 2 * WD] = randint(2 ** 20, (N_ROWS, WD))
            timed(name, BODIES[name], tbl, idx, lo_q)
            del tbl

    if "probe128b" in which:
        tbl = randint(100, (N_ROWS, 128))
        timed("probe128b", probe128b_body, tbl, idx, lo_q)
        del tbl

    if "probepal" in which:
        tbl = distinct_lo_rows(gen, N_ROWS, 128, WD, device)
        timed("probepal", probepal_body, tbl, idx, lo_q)
        del tbl

    if "deepcmp" in which:
        per.update(deepcmp(deep if deep is not None else deep_db(), device,
                           gen))

    if which & set(SCALE_EXPERIMENTS):
        per.update(run_scale(which, gen, device))

    if which & {"pf0", "pf1", "pf2", "pf3"}:
        W = -(-N_IDX // PF_B)
        tbl = randint(100, (N_ROWS, 128))
        hi2, lo2 = randint(N_ROWS, (PF_B, W)), randint(100, (PF_B, W))
        val2 = rand((PF_B, W)) < 0.97
        for lvl in range(4):
            if f"pf{lvl}" in which:
                timed(f"pf{lvl}", pf_body, lvl, N_ROWS, tbl, hi2, lo2, val2)
        del tbl

    for name, shp in (("pf0f", (PF_B * 304,)), ("pf0p", (PF_B, 384))):
        if name in which:
            tbl = randint(100, (N_ROWS, 128))
            timed(name, BODIES[name], tbl, randint(N_ROWS, shp),
                  randint(100, shp), rand(shp) < 0.97)
            del tbl

    if "pfcross" in which:
        tbl = randint(100, (N_ROWS, 128))
        timed("sel_on_pfdata", BODIES["sel_on_pfdata"], tbl,
              randint(N_ROWS, (PF_B * 304,)), randint(100, (PF_B * 304,)))
        del tbl

    for name, n in (("sortflat_bad", 2_498_560), ("sortflat_good",
                                                  2_498_568)):
        if name in which:
            timed(name, BODIES[name], rand(n) < 0.01, randint(100, (n,)))
    for name, wd in (("rowsort_bad", 912), ("rowsort_odd", 917)):
        if name in which:
            timed(name, rowsort_body, randint(2 ** 30, (PF_B, wd)),
                  rand((PF_B, wd)), randint(wd, (PF_B, wd)))

    if "probe2g" in which:
        timed("probe2g", BODIES["probe2g"], randint(100, (N_ROWS, 32)),
              randint(100, (N_ROWS, 8)), idx, lo_q)

    if "dma_gather" in which:
        tbl = randint(100, (N_ROWS, 128))
        gx.dma_gather(tbl, idx)           # checks the ids once
        per["dma_gather"] = measure(
            "dma_gather", lambda: sum4(gx._launch_dma_gather(tbl, idx)))
        del tbl

    if which & {"xsort", "xargsort", "xsortpair"}:
        vals = randint(256, (N_IDX,))
        for name in ("xsort", "xargsort"):
            if name in which:
                timed(name, BODIES[name], vals)
        if "xsortpair" in which:
            timed("xsortpair", xsortpair_body, vals, randint(99, (N_IDX,)))

    if "xla128s" in which or "xla128u" in which:
        # sorted ids: does the card coalesce adjacent-row reads?
        tbl = randint(100, (N_ROWS, 128))
        sidx = torch.sort(idx)[0]
        for name, ids in (("xla128s", sidx), ("xla128u", idx)):
            if name in which:
                timed(name, xla_gather, tbl, ids)
        del tbl, sidx

    if "xsort3" in which or "xsort6" in which:
        a = randint(N_ROWS, (N_IDX,))
        b, d = randint(99, (N_IDX,)), randint(99, (N_IDX,))
        # xsort3 runs xsort6 after it, as in the JAX script
        for name in ("xsort3", "xsort6"):
            if name in which or "xsort3" in which:
                timed(name, BODIES[name], a, b, d)

    if "vgather" in which:
        rows = gx.VGATHER_TILE_ROWS
        tile = randint(100, (rows, 128))
        vidx = randint(rows, (N_IDX // VGATHER_CHUNK * VGATHER_CHUNK,))
        gx.vgather(tile, vidx, VGATHER_CHUNK)
        per["vgather"] = measure("vgather", lambda: gx._launch_vgather(
            tile, vidx, VGATHER_CHUNK)[::16].sum())
        print(f"  -> tile {rows} x 128 int32 in shared memory, "
              f"{vidx.numel():,} ids in chunks of {VGATHER_CHUNK}",
              flush=True)

    if "hbmstream" in which:
        nr = N_ROWS // HBM_BLK * HBM_BLK
        tbl = randint(3, (nr, 128))
        gb = nr * 128 * 4 / 1e9
        per["hbmstream"] = measure(
            "hbmstream", lambda: gx.hbmstream(tbl, HBM_BLK).sum())
        print(f"  -> {gb / per['hbmstream']:.0f} GB/s sequential",
              flush=True)
        del tbl

    if "dmaflush" in which:
        perm = torch.randperm(FLUSH_DMAS, generator=gen, device=device)
        dst = perm.to(torch.int32).reshape(-1, FLUSH_PER_PROG)
        buf = randint(100, (FLUSH_PER_PROG * FLUSH_RPD, 128))
        gx.dmaflush(dst, buf, FLUSH_RPD)
        p = per["dmaflush"] = measure("dmaflush", lambda: sum4(
            gx._launch_dmaflush(dst, buf, FLUSH_RPD)[::4096]))
        print(f"  -> {p / FLUSH_DMAS * 1e9:.0f} ns/DMA "
              f"({FLUSH_DMAS * FLUSH_RPD * 128 * 4 / 1e9 / p:.0f} GB/s)",
              flush=True)
        # the one PyTorch call that computes it
        copy = flush_by_index_copy(dst, buf, FLUSH_RPD)
        if not torch.equal(copy(), gx.dmaflush(dst, buf, FLUSH_RPD)):
            raise AssertionError("index_copy_ differs from dmaflush")
        per["dmaflush_index_copy"] = measure(
            "dmaflush_index_copy", lambda: sum4(copy()[::4096]))
    return per


def run_scale(which, gen, device) -> dict:
    """The scale experiments named in ``which`` at EXP_SCALE_KEYS keys
    (the JAX script's single-chip 200M-key regime: buckets of ~65 keys),
    each table made on the card and freed after its experiment."""
    t = scale_tables(EXP_SCALE_KEYS, gen, device)
    n, max_b = t["n"], t["max_b"]
    print(f"scale DB: {n:,} keys, max bucket {max_b}", flush=True)
    per = {}

    def timed(name, body, *args):
        per[name] = measure(name, lambda: body(*args))

    for ws in (128, 256):
        if f"slice{ws}" in which:
            timed(f"slice{ws}", BODIES[f"slice{ws}"], t["lo_pad"],
                  t["starts"])
    probe = (t["payload"], t["q_hi"], t["q_lo"])
    if "scale_csr" in which:
        timed("scale_csr", BODIES["scale_csr"], t["pair"], t["lo_pad"],
              *probe)
    if "scale_wide" in which:
        lw = scale_wide_table(t)
        timed("scale_wide", wide_body, max_b, lw, *probe)
        del lw
    if "scale_fused" in which:
        fw = scale_fused_table(t, gen)
        timed("scale_fused", scale_fused_body, max_b, n, fw, t["q_hi"],
              t["q_lo"])
        del fw
    if "scale_pay" in which:
        ridx = torch.randint(0, n, (N_IDX,), generator=gen, device=device,
                             dtype=torch.int32)
        timed("scale_pay", xla_gather, t["payload"], ridx)
    if "scale_bin" in which:
        n_steps = max(1, math.ceil(math.log2(max_b + 1)))
        timed("scale_bin", bin_body, n_steps, n, t["pair"], t["lo_pad"],
              *probe)
    return per


def main(argv=None) -> int:
    which = list(sys.argv[1:] if argv is None else argv) or list(DEFAULT)
    if not torch.cuda.is_available():
        print("no CUDA card: the experiments time the card",
              file=sys.stderr)
        return 1
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    run(which, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
