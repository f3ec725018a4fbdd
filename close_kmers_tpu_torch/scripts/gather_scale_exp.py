"""Gather cost against table size on the card: does a gather's per-row
cost follow the table (cache and memory locality) or the index stream
alone?  Port of ``scripts/gather_scale_exp.py``.

    python -m close_kmers_tpu_torch.scripts.gather_scale_exp

It decides whether a presence prefilter can pay on sparse windows (a
genome's windows hit ~8% of the time): test every window against a
bitmap, compact the survivors, and run the payload row gather on the
few.  Measured at N = 10M indices into H = 3.2M buckets, each a
function of tensors that returns the JAX closure's check value:

  bitmap    one bit of a [H / 32] int32 bitmap (400 KB) a window
  small     one int of a [H] table (12.8 MB) a window
  payload   a [H, 112] row (1.4 GB, the probe's layout) a window
  compact   the stable argsort that puts the 8% survivors first
  filtered  compact, then the payload row of each survivor

Times from CUDA events, (t(k_hi calls) - t(k_lo calls)) / (k_hi - k_lo),
after two warm-up calls (this script's own copy of the JAX script's
``routed_exp.measure``).  It ends with the JAX script's ``GATHER_SCALE``
line and its verdict: the prefilter PAYS when filtered + bitmap is less
than payload.  Tables and ids are made on the card from a seeded
``torch.Generator``.  Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

import torch

from ..core.engine import stable_true_first
from ..utils.device import gpu_name_and_power_limit, resolve_device

N = 10_000_000
H = 3_200_000
WIDTH = 112
DENSITY = 0.08


def measure(name: str, fn, k_hi: int, k_lo: int) -> float:
    """Seconds per call of ``fn`` (which returns a scalar tensor) on the
    card, from CUDA events over ``k_lo`` and ``k_hi`` back-to-back calls,
    differenced; prints the JAX script's lines."""
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
    t_lo, _ = run(k_lo)
    t_hi, v = run(k_hi)
    per = (t_hi - t_lo) / (k_hi - k_lo)
    print(f"  {name}: {per * 1e3:.2f} ms/call (check {v:.6g})", flush=True)
    return per


def _f32(x) -> torch.Tensor:
    return x.sum(dtype=torch.int32).to(torch.float32)


def s_bitmap(idx, bitmap):
    """Bit idx & 31 of word idx >> 5, summed."""
    w = bitmap[(idx >> 5).long()]
    return _f32((w >> (idx & 31)) & 1)


def s_small(idx, small):
    return _f32(small[idx.long()])


def s_wide(idx, wide):
    return _f32(wide[idx.long()])


def s_compact(idx, mask, n8: int):
    """The first ``n8`` of the stable argsort that puts ``mask`` first:
    their ids summed."""
    return _f32(idx[stable_true_first(mask)[:n8]])


def s_filtered(idx, mask, wide, n8: int):
    """compact, then the payload row of each survivor, summed."""
    surv = idx[stable_true_first(mask)[:n8]]
    return _f32(wide[surv.long()])


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the experiments time the card: use a CUDA device")
    return device


def run(device, seed: int = 0) -> dict:
    """The five measurements on ``device`` (a card); prints their lines,
    the per-row costs, the verdict and the GATHER_SCALE line, and returns
    the numbers by name (seconds per call, ns per row, the verdict)."""
    device = _card(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(low, high, size):
        return torch.randint(low, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    idx = randint(0, H, (N,))
    bitmap = randint(-2 ** 31, 2 ** 31 - 1, (H // 32,))
    small = randint(0, 100, (H,))
    wide = randint(0, 100, (H, WIDTH))
    mask8 = torch.rand(N, generator=gen, device=device) < DENSITY
    n8 = int(N * DENSITY)

    t_bm = measure("bitmap 400KB", lambda: s_bitmap(idx, bitmap), 24, 8)
    t_sm = measure("small 12.8MB 1-col", lambda: s_small(idx, small), 24, 8)
    t_w = measure("payload 1.4GB 112-col", lambda: s_wide(idx, wide), 12, 4)
    t_c = measure("compact (argsort 8%)",
                  lambda: s_compact(idx, mask8, n8), 12, 4)
    t_f = measure("filter+compact+gather8%",
                  lambda: s_filtered(idx, mask8, wide, n8), 12, 4)
    pays = t_f + t_bm < t_w
    print(f"\nper-row: bitmap {t_bm / N * 1e9:.2f} ns, small "
          f"{t_sm / N * 1e9:.2f} ns, payload {t_w / N * 1e9:.2f} ns")
    print(f"prefilter pipeline {t_f * 1e3:.1f} ms (+bitmap "
          f"{t_bm * 1e3:.1f}) vs full gather {t_w * 1e3:.1f} ms -> "
          f"{'PAYS' if pays else 'DOES NOT PAY'} at 8% density")
    print(f"GATHER_SCALE bitmap_ns={t_bm / N * 1e9:.2f} "
          f"small_ns={t_sm / N * 1e9:.2f} payload_ns={t_w / N * 1e9:.2f} "
          f"compact_ms={t_c * 1e3:.2f} filtered_ms={t_f * 1e3:.2f}",
          flush=True)
    return dict(bitmap=t_bm, small=t_sm, payload=t_w, compact=t_c,
                filtered=t_f, bitmap_ns=t_bm / N * 1e9,
                small_ns=t_sm / N * 1e9, payload_ns=t_w / N * 1e9,
                pays=pays)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("no CUDA card: the experiments time the card",
              file=sys.stderr)
        return 1
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    run("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
