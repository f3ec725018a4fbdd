"""Probe-gather experiments on the card: the floors under the probe's
random row reads.  Port of ``scripts/gather_exp.py``.

    python -m close_kmers_tpu_torch.scripts.gather_exp [exp ...]

Experiments (default: xla111 xla128 xla32 xla8 dma_gather):

  xla8 xla32 xla111 xla128  the plain gather ``table[idx]`` at row width
                            8 / 32 / 111 / 128 int32
  dma_gather                the hand-written row gather, cp.async rings
                            (the JAX script's ``pallas``), width 128
  xla128s xla128u           the width-128 gather with sorted ids, then
                            the same ids unsorted
  vgather                   gathers from a tile held in shared memory
  hbmstream                 a sequential stream of the table (GB/s)
  dmaflush                  32,768 scattered 4 KB block writes, then
                            the same by one index_copy_
  deepcmp                   a PATRIC-density DB (20M keys over 64,000 hi
                            buckets) probed through the sub_blocks tier
                            and through the binary search, whose outputs
                            must be equal

Sizes: EXP_ROWS table rows (3.2M), EXP_IDX probes per call (2.49M),
EXP_DEEP_KEYS / EXP_DEEP_SPAN for deepcmp.  Each line is one call's
time from CUDA events, (t(K_HI calls) - t(K_LO calls)) / (K_HI - K_LO)
back to back, after two warm-up calls.  Tables and ids are made on the
card from a seeded ``torch.Generator``; deepcmp's DB is built on the
host (``DeviceDB.from_db`` lays out numpy tables).  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import params
from ..core.engine import JAX_TIER_FLAGS, DeviceDB, probe_windows
from ..db.signature_db import SignatureDB
from ..ops import gather_exp as gx
from ..utils.device import gpu_name_and_power_limit, resolve_device

N_ROWS = int(os.environ.get("EXP_ROWS", 3_200_000))    # table rows
N_IDX = int(os.environ.get("EXP_IDX", 2_490_000))      # probes per call
EXP_DEEP_KEYS = int(os.environ.get("EXP_DEEP_KEYS", 20_000_000))
EXP_DEEP_SPAN = int(os.environ.get("EXP_DEEP_SPAN", 64_000))
K_HI = 10
K_LO = 4

EXPERIMENTS = ("xla8", "xla32", "xla111", "xla128", "dma_gather",
               "xla128s", "xla128u", "vgather", "hbmstream", "dmaflush",
               "deepcmp")
DEFAULT = ("xla111", "xla128", "xla32", "xla8", "dma_gather")
VGATHER_CHUNK = 2048
HBM_BLK = 2048
FLUSH_DMAS, FLUSH_RPD, FLUSH_PER_PROG = 32768, 8, 256  # 4 KB per copy


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


def sum4(rows):
    """The JAX experiments' check value of gathered rows: the int32
    (wrapping) sum of their first four columns, as f32."""
    return rows[:, :4].sum(dtype=torch.int32).float()


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
            f"unknown or unported experiments {sorted(unknown)}; this port "
            f"runs {', '.join(EXPERIMENTS)}")
    device = _card(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(high, size):
        return torch.randint(0, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    per = {}
    idx = randint(N_ROWS, (N_IDX,))
    print(f"table {N_ROWS:,} rows, {N_IDX:,} probes", flush=True)
    for name, width in (("xla8", 8), ("xla32", 32), ("xla111", 111),
                        ("xla128", 128)):
        if name in which:
            tbl = randint(100, (N_ROWS, width))
            per[name] = measure(name, lambda: xla_gather(tbl, idx))
            del tbl

    if "dma_gather" in which:
        tbl = randint(100, (N_ROWS, 128))
        gx.dma_gather(tbl, idx)           # checks the ids once
        per["dma_gather"] = measure(
            "dma_gather", lambda: sum4(gx._launch_dma_gather(tbl, idx)))
        del tbl

    if "xla128s" in which or "xla128u" in which:
        # sorted ids: does the card coalesce adjacent-row reads?
        tbl = randint(100, (N_ROWS, 128))
        sidx = torch.sort(idx)[0]
        for name, ids in (("xla128s", sidx), ("xla128u", idx)):
            if name in which:
                per[name] = measure(name, lambda: xla_gather(tbl, ids))
        del tbl, sidx

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

    if "deepcmp" in which:
        per.update(deepcmp(deep if deep is not None else deep_db(), device,
                           gen))
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
