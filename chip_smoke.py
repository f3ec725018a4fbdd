#!/usr/bin/env python3
"""Smoke run of the torch port's /query (with device best-call), family,
genome, /matrix, probe-gather, TpuEngine, sharded serving and
build_signature_kmers paths on one NVIDIA card.

    python3 chip_smoke.py [--compare LABEL=DIR ...]

Builds the CUDA kernels from ``close_kmers_tpu_torch/csrc`` (one nvcc per
source, in parallel) and drives the port's main paths on the card, phase
by phase; any failure exits non-zero and prints no result.  It needs one
card, and exits 1 without one.

1. Device and build: the card's name and power limit (nvidia-smi), then
   ``nvcc`` builds the kernels for sm_90a (build seconds printed).
2. Kernels against their plain torch versions, exact equality, times
   from CUDA events: probe_select and scan_score on one 4096 x 300-aa
   batch against the real-size DB of phase 4; row_gather, famwide_select
   and family_group on the same batch against the family universe of
   phase 4 (D = 3), family_group also on the first chunk of phase 4's
   /fq_lookup ORF batch and on both sides of its route limit (W*D =
   8192 fused, 8193 sorted); probe_select again on the deep DB's sub
   blocks; and
   best_call on the query and deep batches' scan outputs (as the scan
   lays them out), also at B in {1, 33, 4097} x W+1 in BC_WIDTHS (1 to
   1,017), on column slices of wider rows and on rows of 0-63 calls
   (overflow flags past 32), timed as called and by launch alone, L2
   flushed, beside the launch floor (a one-element fill_), its bound the
   emit bytes once, 12 B a call it reduces and 36 B a row written, and
   the wrapper's host cost split into its parts; with ``--compare
   LABEL=DIR`` (e.g. the parent commit unpacked by ``git archive``) that
   tree's best_call kernel and wrapper are timed in turns with this
   one's; and
   the four probe-gather kernels at scripts/gather_exp.py's shapes
   (dma_gather: 2,490,000 ids from a [3.2M, 128] table; vgather:
   2,488,320 ids on a 448 x 128 tile; hbmstream: [3,198,976, 128] in
   blocks of 2048 rows; dmaflush: 32,768 copies of 8 x 128).
   scan_score, row_gather and family_group are timed as the path calls
   them (the wrapper, L2 flushed between calls) and by launch alone;
   family_group beside its earlier design (sort_fams + the sorted walk),
   with the stages of rollup_from_fams apart (group, global pack);
   famwide_select by launch alone, warm and L2 flushed, with its traffic
   in 64-B bursts; probe_select the same, and as the path calls it
   (warm), on the query cell and on the sub blocks; row_gather beside
   ``torch.index_select``, and with a bad id, which must raise
   IndexError at its check and leave the context usable; scan_score
   also at B in {1, 33, 4096, 4097} x W in {1, 63, 64, 65, 304}, fresh,
   chained and state-only, and at the genome program's shape (W = 1,016,
   B in {1, 9984}), chained and state-only.  The genome program's
   kernels at its own inputs (phase 4's 5-Mbp genome): probe_select on
   its 10,143,744 tile windows (timed as on the query cell), and
   scan_score on its 9,984 x 1,016 scan inputs chained (init as the
   fixpoint builds it, pos0, final_flush) with emit and state-only, each
   timed as the path calls it and by launch alone, L2 flushed, with its
   bound; probe_select also on one /matrix chunk's 2,048 x 304 windows.
   Each kernel's record carries its bound (the
   bytes it must move over 3.35 TB/s; for vgather the longer of its
   shared-memory bytes over the SMs' bank rate and its 64-bit adds over
   their INT32 rate, both in the record) and, where one PyTorch call
   computes the same function, that call's time; the genome and matrix
   shapes sit in the records' ``genome`` and ``matrix`` fields.
   Tiers: the 20.5M-kmer DB of phase 4 built in each probe tier by
   ``DeviceDB.from_db`` flags (the six variants of
   tests/test_engine.py::test_probe_layout_parity), one table at a time;
   each tier's probe of the batch must equal the payload-wide probe
   (ms per batch and peak memory printed).
3. The golden server on the card: the port's kser context on
   tests/golden/data with device="cuda", and the version / query /
   query_details / query_best / lookup / lookup_best / wadd / xmatrix
   (/add then /matrix) / yfq / zfq_gz conversations over a socket, byte
   for byte against
   tests/golden/*.resp; then a second context forced onto the device
   family program (device_family_min = 0), whose four /lookup modes and
   /fq_lookup must give the first context's bytes.
4. Real size: bench.py's query corpus rebuilt from its seed (70,000
   source proteins x 300 aa, 4,096 functions: ~20.5M signature kmers;
   65,536 query proteins).
   * /query: all queries through DeviceScorer.score_batch_packed (slim
     pack) + native.best_call_batch in batches of 4096, and 4096 through
     KmerEngine.annotate_with_hits (the server's engine call); a
     4096-query sample is held against native.HashPipeline call counts
     and against native.score_batch fed by a numpy searchsorted over the
     DB keys.  All queries also through DeviceScorer.best_calls_batch
     (the best_call kernel), each BestCall equal to the slim pack's
     native one, the two paths' rates side by side (deep cell too).
   * overflow: 128 rows of 2-48 fragments of query proteins through
     best_calls_batch; the rows past 32 calls take the fallback, and
     every row equals the native reference.
   * TpuEngine: process_batch and annotate_best_match (the family cell's
     mapping) on 256 query proteins, equal to a CPU engine.
   * family: bench.py's family universe (make_family_universe: kmer
     degree 1-3, 12,288 families) rebuilt from the same seed; all 65,536
     proteins through KmerEngine.best_family_matches_padded (the auto
     gate takes the famwide path), the same chunks through a two-gather
     DeviceFamilyScorer(famwide=False) with equal packs, and a
     4096-protein sample equal to the host path (native.family_scores
     and the scalar find_best_family_match).
   * reads: 20,000 synthetic 150-bp reads (scripts/fq_bench.py's
     synth_reads, seed 3 as bench.py) through the /fq_lookup path
     (server.http.process_reads: batch_orf_arrays,
     best_family_matches_padded(as_arrays=True), best-frame reduction);
     a 1,000-read sample equal to the host path's output.
   * deep: scripts/gather_exp.py deepcmp's DB (20M random keys over
     64,000 hi buckets, ~312 per bucket, PATRIC density), which the
     auto-ladder puts on the sub_blocks tier; 65,536 proteins spelled
     from its kmers (37 kmers of one function each, so calls form)
     through the /query checks above.
   * genome: a 5-Mbp genome by scripts/dna_bench.py's synth_genome (seed
     4, the query proteins reverse-translated between 900-base random
     stretches) through GenomeAnnotator.calls_of on the payload-wide DB:
     Mbp/s (best of 5 passes), the fixpoint rounds and each kernel's
     launches per genome, one pass profiled (wall, the card's busy time
     and its top five kernels); all six frames' call lists equal to the
     native CPU reference (translate.six_frame_kguts_offsets, searchsorted
     hits, native.score_batch with 65,536 calls a frame).
   * matrix: bench.py's matrix cell (P = 2,048 query proteins, a
     degree-1-3 kmer->peg CSR over the DB from bench.py's seed stream,
     rank over 2P, max_deg 3) through DeviceMatrix.count_pairs:
     proteins/s (best of 5), one request profiled as the genome pass,
     (pairs, shared hits) equal to native.matrix_hash, the first 256
     proteins' exact pairs equal to a numpy replay of the registration
     rule.
   * the probe-gather experiments: ``python -m
     close_kmers_tpu_torch.scripts.gather_exp`` with every experiment
     it runs, deepcmp on the deep DB (deep_sub equal to deep_bin on
     2.49M windows).
   * build_db: cli/build_db.main on 20,000 annotated proteins in 20
     genome files (each function's protein point-mutated in every
     genome), --min-reps-required 5, recall and validation with
     --device cuda, and the same CLI with --device cpu, in two processes
     at the same time: byte-identical files and lines.
   * sharded (parallel/sharding.py): the query DB and its family table
     range-sharded over four entries on card 0, meshes (1, 4) and
     (2, 2), routed and replicated: serve_step_sharded on all 65,536
     proteins with family rows, each best pack equal to
     DeviceScorer.best_batch_packed and each rollup (parsed) to
     DeviceFamilyScorer.rollup; ShardedEngine.probe_compact equal to
     FastAnnotator's; probe_routed equal to probe_sharded at the default
     capacity and at a forced-overflow one; the step's proteins/s beside
     best_batch_packed's (interleaved, median of 3), one pass profiled by
     stage (torch.profiler ranges: encode, route, probe, family rows,
     exchange, scan, best_call, rollup), the kernels' launches a pass;
     the deep DB on (1, 4) through each shard's sub blocks; the golden
     conversations through 4-shard kser contexts (all replicated,
     /lookup and /query best calls routed); a one-rank NCCL group
     (multihost.initialize, pod_mesh (1, 1)) whose routed and replicated
     steps equal the single-card pack.  Its launch counts are set to 0
     just before it and read just after: the five kernels of the path
     (probe_select, scan_score, row_gather, family_group, best_call) must
     each have launched in the sharded calls themselves.
5. All ten kernels' launch counters, reset just before phases 3-4, must
   be above 0; probe_select must have launched on the deep DB's
   sub_blocks path, on the genome path (with scan_score) and on the
   matrix path.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import sys
import threading
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

# bench.py's query corpus (bench.py:25-92)
N_SRC = 70_000
PROT_LEN = 300
N_QUERY = 65_536
BATCH = 4096
N_FUNCS = 4096
SAMPLE = 4096
# bench.py bench_fastq
N_READS = 20_000
READ_LEN = 150
READ_SAMPLE = 1000
# bench.py bench_genome (BENCH_GENOME_MBP = 5) and bench_matrix
GENOME_BASES = 5_000_000
MATRIX_P = 2048
MATRIX_PREFIX = 256      # proteins whose exact pairs the replay holds
# tests/test_engine.py::test_probe_layout_parity's from_db variants
TIER_VARIANTS = (
    ("binary_search", dict(wide=False, sub=False, wide_lo=False,
                           fused=False)),
    ("scale_lo_wide", dict(wide=False, sub=False, fused=False)),
    ("fused_wide", dict(wide=False, sub=False)),
    ("sub_blocks", dict(wide=False, sub=True, fused=False)),
    ("lo_wide", dict(wide=True, wide_payload=False, fused=False)),
    ("payload_wide", dict(wide=True, wide_payload=True)),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def build_corpus(host):
    """bench.py build_corpus, rebuilt from its seeds (no cache)."""
    src_rng = np.random.default_rng(0)
    off = src_rng.integers(0, 20, size=(N_SRC, PROT_LEN), dtype=np.int64
                           ).astype(np.uint8)
    W = PROT_LEN - 8 + 1
    o32 = off.astype(np.int32)
    hi = np.zeros((N_SRC, W), dtype=np.int32)
    lo = np.zeros((N_SRC, W), dtype=np.int32)
    for j in range(4):
        hi = hi * 20 + o32[:, j:j + W]
        lo = lo * 20 + o32[:, 4 + j:4 + j + W]
    keys = (hi.astype(np.int64) * 160000 + lo).ravel()
    del hi, lo, o32
    fi = np.repeat(np.arange(N_SRC, dtype=np.int64) % N_FUNCS, W)
    keys, idx = np.unique(keys, return_index=True)
    fi = fi[idx].astype(np.int32)
    rng = np.random.default_rng(len(keys))
    db = host.SignatureDB(
        keys, fi,
        rng.integers(-1, 64, size=len(keys)).astype(np.int32),
        rng.integers(0, PROT_LEN, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
        functions=[f"function {i}" for i in range(N_FUNCS)])
    qi = rng.integers(0, N_SRC, size=N_QUERY)
    width = -(-(PROT_LEN + 8) // 8) * 8
    offsets = np.full((N_QUERY, width), 20, dtype=np.uint8)
    offsets[:, :PROT_LEN] = off[qi]
    lengths = np.full(N_QUERY, PROT_LEN, dtype=np.int32)
    # bench.py hands its seed-0 stream, as the corpus build left it, to
    # make_family_universe
    return db, offsets, lengths, src_rng


def make_family_universe(host, db, rng):
    """bench.py make_family_universe: named-function DB + synthetic
    family universe (deg 1-3 kmer->fam CSR, 3 families per function)."""
    n_funcs = int(db.fi.max()) + 1
    dbf = host.SignatureDB(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                           functions=[f"fn{i}" for i in range(n_funcs)])
    n = len(dbf)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = np.repeat(dbf.fi * 3, deg) \
        + (np.arange(offs[-1]) % 3).astype(np.int32)
    mapping = host.family_db.KmerFamilyMapping()
    mapping._fam_csr = (dbf.keys, offs, vals.astype(np.int32))
    mapping.families = [
        host.family_db.FamilyData(f"PGF_{f:08d}", f"PLF_{f % 5}_{f:08d}",
                                  f % 5, f"fn{f // 3}", f, 10, 10)
        for f in range(3 * n_funcs)]
    return dbf, mapping


# scripts/dna_bench.py CODON: one codon per amino acid, index = aa offset
CODON = ["GCG", "TGC", "GAT", "GAA", "TTT", "GGT", "CAT", "ATT", "AAA",
         "CTG", "ATG", "AAC", "CCG", "CAG", "CGT", "AGC", "ACC", "GTT",
         "TGG", "TAT"]


def synth_reads(rng, src_off: np.ndarray, n_reads: int, read_len: int):
    """scripts/fq_bench.py synth_reads: ~70% coding reads (a random
    window of a reverse-translated source protein, random strand/offset),
    ~30% random DNA."""
    bases = np.array(list("ACGT"))
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(n_reads):
        if rng.random() < 0.7:
            prot = src_off[rng.integers(0, len(src_off))]
            dna = "".join(CODON[o] for o in prot)
            start = int(rng.integers(0, max(1, len(dna) - read_len)))
            r = dna[start:start + read_len]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
        else:
            r = "".join(rng.choice(bases, size=read_len))
        reads.append((f"read{i}", r))
    return reads


# The card's published memory rate (NVIDIA's data sheet, H100 SXM), the
# denominator of every bound_ms below.
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Mean milliseconds of one call of ``fn`` with the L2 cache flushed
    before it (a write of ``flush``, larger than the 50 MB L2, between
    calls; CUDA events around each call alone, after one warm-up call)."""
    import torch
    fn()
    times = []
    for k in range(reps):
        flush.fill_(k)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        times.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in times) / reps


def cuda_ms_cold_turns(fns: dict, reps: int, flush) -> dict:
    """:func:`cuda_ms_cold` for each of ``fns`` ({name: fn}), the
    functions taken in turns within each rep (in order, then in reverse
    in the next rep), so that a drift of the card's clocks falls on all
    alike; after a warm-up call of each and ~20 ms of flushes.  A ~0.1-ms
    spin on the card follows each flush, so that the host's enqueue of
    the call (tens of microseconds for a wrapper) is done before the card
    reaches it and no wait for the host falls inside the timed span."""
    import torch
    for fn in fns.values():
        fn()
    for k in range(60):
        flush.fill_(k)
    keys = list(fns)
    times = {k: [] for k in keys}
    for r in range(reps):
        for k in keys if r % 2 == 0 else keys[::-1]:
            flush.fill_(r)
            torch.cuda._sleep(200_000)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            stop.record()
            times[k].append((start, stop))
    torch.cuda.synchronize()
    return {k: sum(a.elapsed_time(b) for a, b in v) / reps
            for k, v in times.items()}


def graph_ms(fn, n: int = 20) -> float:
    """Device milliseconds per call of ``fn`` back to back, L2 warm, free
    of the host: ``n`` calls captured in one CUDA graph, one replay timed
    by CUDA events after a warm-up replay."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def sm_clocks_per_s() -> float:
    """The card's SM clocks a second: its SMs times their maximum clock
    (nvidia-smi clocks.max.sm).  Each SM's shared memory moves 32 banks x
    4 B a clock, and its 64 INT32 lanes do one operation a clock each."""
    import subprocess
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * mhz * 1e6


def bound(hbm_bytes: float, smem_bytes: float = 0.0, smem_rate: float = 0.0,
          ops: float = 0.0, ops_rate: float = 0.0) -> dict:
    """bound_ms / bound_by of a kernel: the longest of the device-memory
    bytes it must move (each input read once, each output written once)
    over HBM_BYTES_PER_S, its shared-memory bytes over ``smem_rate`` and
    its integer operations over ``ops_rate``.  Most kernels here do a few
    integer operations per byte, far below the card's operation rates, and
    pass no ``ops``."""
    ms = hbm_bytes / HBM_BYTES_PER_S * 1e3
    if smem_bytes:
        ms = max(ms, smem_bytes / smem_rate * 1e3)
    if ops and ops / ops_rate * 1e3 > ms:
        return dict(bound_ms=ops / ops_rate * 1e3, bound_by="operations")
    return dict(bound_ms=ms, bound_by="bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(want, got) -> float:
    """Largest |kernel - plain| over all output planes (as float64), after
    checking that every plane is equal bit for bit."""
    import torch
    err = 0.0
    for w, g in zip(want, got):
        if w.dtype == torch.float32:
            check(torch.equal(w.view(torch.int32), g.view(torch.int32)),
                  "f32 plane differs bit-wise")
        else:
            check(torch.equal(w, g), f"{w.dtype} plane differs")
        err = max(err, float((w.double() - g.double()).abs().max())
                  if w.numel() else 0.0)
    return err


SCAN_PARAMS = [(5, 0, 200, 0), (2, 0, 10, 0), (1, 2, 50, 0), (2, 0, 200, 1)]


def scan_sweep(device) -> int:
    """scan_score against its plain version at B in {1, 33, 4096, 4097}
    and W in {1, 63, 64, 65, 304} (tile edges, no alignment): a fresh
    state, a chained tile (init, pos0, final_flush) and the state alone
    (want_emit=False); and at the genome program's shape, W = 1,016 with
    B in {1, 9984}, chained and state-only.  Returns the number of cases
    held."""
    import torch
    from close_kmers_tpu_torch.ops.scan_score import (scan_score,
                                                      scan_score_plain)
    grid = [(B, W, 3) for B in (1, 33, 4096, 4097)
            for W in (1, 63, 64, 65, 304)]
    n = 0
    for B, W, n_kw in grid + [(1, 1016, 2), (9984, 1016, 2)]:
        rng = np.random.default_rng(B * 1000 + W)
        x = [torch.from_numpy(v).to(device) for v in (
            rng.random((B, W)) < 0.3,
            rng.integers(0, 5, size=(B, W)).astype(np.int32),
            rng.integers(0, 300, size=(B, W)).astype(np.int32),
            rng.uniform(0.1, 3, size=(B, W)).astype(np.float32))]
        p = SCAN_PARAMS[(B + W) % len(SCAN_PARAMS)]
        _, _, carry = scan_score_plain(*x, *p, want_emit=False)
        pos0 = torch.from_numpy(
            rng.integers(0, 500, size=B).astype(np.int32)).to(device)
        flush = torch.from_numpy(rng.random(B) < 0.5).to(device)
        for kw in (dict(), dict(init=carry, pos0=pos0, final_flush=flush),
                   dict(init=carry, pos0=pos0, want_emit=False))[-n_kw:]:
            want = scan_score_plain(*x, *p, **kw)
            got = scan_score(*x, *p, **kw)
            torch.cuda.synchronize()
            planes = [] if want[0] is None else [want[0], *want[1]]
            got_planes = [] if got[0] is None else [got[0], *got[1]]
            check(len(planes) == len(got_planes),
                  f"scan_score B={B} W={W}: emit planes differ")
            max_abs_err(planes + list(want[2].values()),
                        got_planes + list(got[2].values()))
            n += 1
    return n


def probe_bursts(flat, found, idx, table, wd: int) -> int:
    """The distinct 64-B bursts of ``table`` that probe_select must read:
    start and the lo plane (ints 0..wd) of each valid row, and the fi,
    oi, avg_off and wt picks of each hit (idx = start + slot)."""
    import torch
    hi, _lo, valid = flat
    row_w = table.shape[1]
    ok = valid & (hi >= 0) & (hi < table.shape[0])
    rows = torch.unique(hi[ok]).long() * row_w * 4            # byte offsets
    first, last = rows // 64, (rows + (wd + 1) * 4 - 1) // 64
    span = torch.arange(int((last - first).max()) + 1 if rows.numel() else 1,
                        device=hi.device)
    lo_bursts = first[:, None] + span[None, :]
    lo_bursts = lo_bursts[lo_bursts <= last[:, None]]
    h = hi[found].long()
    slot = (idx[found] - table[h, 0]).long()
    key = torch.unique(h * wd + slot)
    base = key // wd * row_w * 4
    picks = torch.stack([(base + (1 + p * wd + key % wd) * 4) // 64
                         for p in range(1, 5)]).reshape(-1)
    return int(torch.unique(torch.cat([lo_bursts, picks])).numel())


def time_probe(flat, table, wd: int, n: int, flush, label: str):
    """probe_select against its plain version on ``table``'s rows: the
    launch alone (warm and L2 flushed), the wrapper as the path calls it
    (warm), the plain version, the bound and the 64-B burst traffic.
    Returns (the kernel's planes, the record's fields)."""
    import torch
    from close_kmers_tpu_torch.ops import probe_select as PS
    args = (*flat, table, wd, n)
    got = PS.probe_select(*args)
    torch.cuda.synchronize()
    err = max_abs_err(PS.probe_select_plain(*args), got)
    check(int(got[0].sum()) > 0, f"probe on {label} found no hits")
    out = PS.probe_outputs(flat[0].numel(), flat[0].device)
    rec = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: PS._launch_probe(*args, out), 20),
        cold_ms=cuda_ms_cold(lambda: PS._launch_probe(*args, out), 20, flush),
        wrapper_ms=cuda_ms(lambda: PS.probe_select(*args), 20),
        plain_ms=cuda_ms(lambda: PS.probe_select_plain(*args), 5))
    # windows in, six planes out; the table: each valid window's row
    # (start + lo plane) once per distinct row, a hit's four payload ints
    # once per distinct hit
    ok = flat[2] & (flat[0] >= 0) & (flat[0] < table.shape[0])
    rows = int(torch.unique(flat[0][ok]).numel())
    hits = int(torch.unique(got[5][got[0]]).numel())
    rec.update(bound(nbytes(*flat, *got) + rows * (1 + wd) * 4 + hits * 16))
    bursts = probe_bursts(flat, got[0], got[5], table, wd)
    rec["burst_mb"] = (nbytes(*flat, *got) + bursts * 64) / 1e6
    rec["burst_tbps"] = rec["burst_mb"] / rec["ms"] / 1e3   # MB/ms is GB/s
    log(f"probe_select on {label}: N={flat[0].numel()} windows, rows "
        f"{tuple(table.shape)}, wd={wd}: launch alone {rec['ms']:.4f} ms "
        f"warm, {rec['cold_ms']:.4f} ms L2 flushed, wrapper "
        f"{rec['wrapper_ms']:.4f} ms warm, plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rows} distinct rows, {hits} "
        f"hits), max_abs_err {err}; {bursts} bursts of 64 B + windows and "
        f"planes = {rec['burst_mb']:.1f} MB = {rec['burst_tbps']:.2f} TB/s "
        f"warm ({bursts / max(hits, 1):.2f} bursts a hit)")
    return got, rec


def scan_calls(T, S, ddb, off_d, len_d, params):
    """The scan's emit and (count, function, weight) planes of one batch,
    as best_call takes them on the device best-call path."""
    hi, lo, valid = T.encode_windows(off_d, len_d)
    found, fi, _oi, av, wt, _idx = T.probe_windows(ddb, hi, lo, valid)
    emit, fields, _state = S.scan_score(
        found, fi, av, wt, params.min_hits, params.min_weighted_hits,
        params.max_gap, params.order_constraint)
    return emit, fields[2], fields[3], fields[4]


def phase_kernels(T, ddb, off_d, len_d, params, flush, deep_calls,
                  compare):
    """Phase 2: each kernel against its plain version at the shapes the
    main path gives it; best_call also on ``deep_calls`` (the deep cell's
    batch, :func:`scan_calls`) and beside the versions in ``compare``."""
    import torch
    from close_kmers_tpu_torch.ops import best_call as BC
    from close_kmers_tpu_torch.ops import scan_score as S
    hi, lo, valid = T.encode_windows(off_d, len_d)
    flat = (hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    got, rec = time_probe(flat, ddb.payload_wide, ddb.wide_w, ddb.n, flush,
                          "the query cell's payload-wide rows")
    sh = hi.shape
    found, fi, _oi, av, wt, _idx = (x.reshape(sh) for x in got)
    sargs = (found, fi, av, wt, params.min_hits, params.min_weighted_hits,
             params.max_gap, params.order_constraint)
    got_s = S.scan_score(*sargs)
    torch.cuda.synchronize()
    want_s = S.scan_score_plain(*sargs)
    torch.cuda.synchronize()
    check(int(want_s[0].sum()) > 0, "scan emitted no calls")
    err_s = max_abs_err([want_s[0], *want_s[1], *want_s[2].values()],
                        [got_s[0], *got_s[1], *got_s[2].values()])
    # as the path calls it (the wrapper, L2 cold), and the launch alone
    ms_s = cuda_ms_cold(lambda: S.scan_score(*sargs), 20, flush)
    largs = (*S._prepare(found, fi, av, wt, None, None, True, None),
             *sargs[4:])
    launch_s = cuda_ms_cold(lambda: S._launch(*largs), 20, flush)
    plain_ms_s = cuda_ms(lambda: S.scan_score_plain(*sargs), 3)
    bound_s = bound(nbytes(found, fi, av, wt, got_s[0], *got_s[1],
                           *got_s[2].values()))
    n_sweep = scan_sweep(off_d.device)
    log(f"scan_score: B={sh[0]} W={sh[1]}: wrapper {ms_s:.4f} ms, launch "
        f"alone {launch_s:.4f} ms (L2 flushed), plain {plain_ms_s:.4f} ms, "
        f"bound {bound_s['bound_ms']:.4f} ms, max_abs_err {err_s}; "
        f"{n_sweep} sweep cases (B x W x fresh/chained/state-only) equal")
    return {
        "probe_select": dict(
            name="probe_select", route="cuda",
            source="close_kmers_tpu_torch/csrc/probe_select.cu",
            replaces="close_kmers_tpu/ops/pallas_select.py:54", **rec,
            library_call=None, library_ms=None),
        "scan_score": dict(
            name="scan_score", route="cuda",
            source="close_kmers_tpu_torch/csrc/scan_score.cu",
            replaces="close_kmers_tpu/ops/pallas_scan.py:150",
            max_abs_err=err_s, ms=ms_s, launch_ms=launch_s,
            plain_ms=plain_ms_s, **bound_s, library_call=None,
            library_ms=None),
        "best_call": best_call_record(BC, got_s[0], got_s[1], deep_calls,
                                      flush, compare),
    }


def row_gather_bad_id(table, idx) -> None:
    """A bad id makes row_gather raise IndexError at its check, after the
    caller's copy of the result, writes a zero row, and leaves the
    context usable (a good gather right after equals the plain one)."""
    import torch
    from close_kmers_tpu_torch.ops.row_gather import (row_gather,
                                                      row_gather_plain)
    bad = idx.clone()
    bad[7] = table.shape[0]
    out, id_check = row_gather(table, bad)
    host = out.cpu()
    try:
        id_check.raise_if_bad()
        raised = False
    except IndexError:
        raised = True
    check(raised, "row_gather did not raise on a bad id")
    check(not bool(host[7].any()), "row_gather's bad row is not zero")
    out, id_check = row_gather(table, idx)
    torch.cuda.synchronize()
    id_check.raise_if_bad()
    max_abs_err([row_gather_plain(table, idx)], [out])


def time_group_step(TF, FG, fams, gcap, flush, label):
    """family_group at one shape: as the path calls it (the wrapper, L2
    flushed), by launch alone (flushed and warm), the earlier design
    (sort_fams + the sorted walk, flushed), the global pack apart and
    the whole rollup_from_fams (flushed).  Returns the times and bound."""
    B, W, D = fams.shape
    M = W * D
    cap = M + 1                       # the global pack's per-row width
    out = FG._outputs(B, cap, fams.device)
    wts = FG._weights(D, fams.device)
    groups = FG.family_group(fams, cap)
    t = dict(
        wrapper_ms=cuda_ms_cold(lambda: FG.family_group(fams, cap), 20,
                                flush),
        launch_ms=cuda_ms_cold(lambda: FG._launch(fams, wts, cap, out), 20,
                               flush),
        launch_warm_ms=cuda_ms(lambda: FG._launch(fams, wts, cap, out), 20),
        earlier_ms=cuda_ms_cold(
            lambda: FG._launch_sorted(*FG.sort_fams(fams), cap, out), 20,
            flush),
        pack_ms=cuda_ms_cold(lambda: TF.pack_global(groups, gcap, M), 20,
                             flush),
        rollup_ms=cuda_ms_cold(lambda: TF.rollup_from_fams(fams, -gcap), 20,
                               flush))
    t.update(bound(nbytes(fams, *groups)))
    log(f"family_group {label}: B={B} x W={W} x D={D}, cap {cap}, "
        f"{int(groups[0].sum())} groups, route {FG.route(M)}: wrapper "
        f"{t['wrapper_ms']:.4f} ms, launch alone {t['launch_ms']:.4f} ms "
        f"(L2 flushed; warm {t['launch_warm_ms']:.4f}), earlier design "
        f"(sort_fams + sorted walk) {t['earlier_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms; rollup_from_fams (global pack of {gcap}) "
        f"{t['rollup_ms']:.4f} ms = group + pack {t['pack_ms']:.4f} ms")
    return t


def family_group_routes(FG, device) -> None:
    """Both routes of family_group at the fused route's widest row and
    one past it, bit for bit against the plain version."""
    import torch
    rng = np.random.default_rng(9)
    for W, D in ((FG.SMEM_MAX_COLS // 4, 4), (FG.SMEM_MAX_COLS // 3 + 1, 3)):
        fams = rng.integers(0, 500, size=(37, W, D))
        fams[rng.random(fams.shape) < 0.3] = -1
        fams = torch.from_numpy(fams.astype(np.int32)).to(device)
        got = FG.family_group(fams, W * D + 1)
        torch.cuda.synchronize()
        max_abs_err(FG.family_group_plain(fams, W * D + 1), got)
        log(f"family_group: W*D = {W * D} (route {FG.route(W * D)}) equal to "
            f"its plain version")


def phase_family_kernels(T, TF, dfs, off_d, len_d, fq_chunk, flush):
    """Phase 2, family half: row_gather, famwide_select and family_group
    against their plain versions at the family path's shapes (the batch's
    windows on the famwide rows, its matched-row ids on the family table,
    its family rows; family_group also on one /fq_lookup chunk's rows and
    on both sides of its route limit)."""
    import torch
    from close_kmers_tpu_torch.ops import family_group as FG
    from close_kmers_tpu_torch.ops import row_gather as RG
    from close_kmers_tpu_torch.ops import probe_select as PS
    out = {}
    hi, lo, valid = T.encode_windows(off_d, len_d)
    B, W = hi.shape
    flat = (hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))

    fargs = (*flat, dfs.famwide, dfs.fam_w, dfs.fam_d, T.FUSED_LO_BITS)
    got = PS.famwide_select(*fargs)
    torch.cuda.synchronize()
    err = max_abs_err(PS.famwide_select_plain(*fargs), got)
    check(int(got[0].sum()) > 0, "famwide probe found no hits")
    check(int((got[3] >= 0).sum()) > 0, "famwide probe found no families")
    fw_out = PS.famwide_outputs(flat[0].numel(), dfs.fam_d, off_d.device)
    ms = cuda_ms(lambda: PS._launch_famwide(*fargs, fw_out), 20)
    cold_ms = cuda_ms_cold(lambda: PS._launch_famwide(*fargs, fw_out), 20,
                           flush)
    wrapper_ms = cuda_ms(lambda: PS.famwide_select(*fargs), 20)
    plain_ms = cuda_ms(lambda: PS.famwide_select_plain(*fargs), 5)
    # windows in, four planes out; the table: the packed plane of each
    # distinct valid row, a hit's wt and D families
    ok = flat[2] & (flat[0] >= 0) & (flat[0] < dfs.famwide.shape[0])
    rows = int(torch.unique(flat[0][ok]).numel())
    hits = int(got[0].sum())
    bnd = bound(nbytes(*flat, *got) + rows * dfs.fam_w * 4
                + hits * (1 + dfs.fam_d) * 4)
    # what device memory moves in 64-B bursts: each distinct row's lo
    # plane, each hit's d family picks (the wt pick mostly shares the lo
    # plane's last burst)
    bursts = (nbytes(*flat, *got) + rows * -(-dfs.fam_w * 4 // 64) * 64
              + hits * dfs.fam_d * 64)
    log(f"famwide_select: N={flat[0].numel()} windows, rows "
        f"{tuple(dfs.famwide.shape)}, fam_w={dfs.fam_w}, D={dfs.fam_d}: "
        f"launch alone {ms:.4f} ms warm, {cold_ms:.4f} ms L2 flushed, "
        f"wrapper {wrapper_ms:.4f} ms warm, plain {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({rows} distinct rows, {hits} hits), "
        f"max_abs_err {err}; in 64-B bursts {bursts / 1e6:.1f} MB = "
        f"{bursts / ms / 1e9:.2f} TB/s warm")
    out["famwide_select"] = dict(
        name="famwide_select", route="cuda",
        source="close_kmers_tpu_torch/csrc/probe_select.cu",
        replaces="close_kmers_tpu/core/device_family.py:373",
        max_abs_err=err, ms=ms, cold_ms=cold_ms, wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, **bnd, library_call=None, library_ms=None)
    fams = got[3].reshape(B, W, -1)

    idx = T.probe_windows(dfs.ddb, hi, lo, valid)[5].reshape(-1)
    table = dfs.fdb.fam
    got, id_check = RG.row_gather(table, idx)
    torch.cuda.synchronize()
    id_check.raise_if_bad()
    err = max_abs_err([RG.row_gather_plain(table, idx)], [got])
    check(torch.equal(got.reshape(B, W, -1), fams),
          "the two-gather and famwide family rows differ")
    row_gather_bad_id(table, idx)
    # as the path calls it (the wrapper with its queued flag copy, L2
    # cold), the launch alone, and one PyTorch call of the same function
    ms = cuda_ms_cold(lambda: RG.row_gather(table, idx), 20, flush)
    o_buf = torch.empty_like(got)
    f_buf = torch.empty(1, dtype=torch.int32, device=table.device)
    launch_ms = cuda_ms_cold(lambda: RG._launch(table, idx, o_buf, f_buf),
                             20, flush)
    lib_ms = cuda_ms_cold(lambda: torch.index_select(table, 0, idx), 20,
                          flush)
    plain_ms = cuda_ms(lambda: RG.row_gather_plain(table, idx), 20)
    rows = int(torch.unique(idx).numel())
    bnd = bound(nbytes(idx, got) + rows * table.shape[1] * 4)
    log(f"row_gather: {idx.numel()} ids x {dfs.fdb.d} ints from "
        f"{tuple(table.shape)} ({rows} distinct rows): checked wrapper "
        f"{ms:.4f} ms, launch alone {launch_ms:.4f} ms, index_select "
        f"{lib_ms:.4f} ms (L2 flushed), plain {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms, max_abs_err {err}; a bad id raised "
        f"IndexError at the check and the context stayed usable")
    out["row_gather"] = dict(
        name="row_gather", route="cuda",
        source="close_kmers_tpu_torch/csrc/row_gather.cu",
        replaces="close_kmers_tpu/ops/pallas_gather.py:65",
        max_abs_err=err, ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
        **bnd, library_call="torch.index_select(table, 0, idx)",
        library_ms=lib_ms)

    # family_group on the family cell's rows, the global pack's width
    cap = W * dfs.fam_d + 1
    got = FG.family_group(fams, cap)
    torch.cuda.synchronize()
    want = FG.family_group_plain(fams, cap)
    torch.cuda.synchronize()
    err = max_abs_err(want, got)
    check(int(got[0].sum()) > 0, "family_group found no groups")
    n_groups = int(got[0].sum())
    t = time_group_step(TF, FG, fams, -(-n_groups // B) * B, flush,
                        "family cell")
    plain_ms = cuda_ms(lambda: FG.family_group_plain(fams, cap), 2)

    # one /fq_lookup chunk: the ORF batch's first chunk, famwide rows
    f_off, f_len = (torch.from_numpy(np.ascontiguousarray(x)).to(
        off_d.device) for x in fq_chunk)
    f_hi, f_lo, f_valid = T.encode_windows(f_off, f_len)
    f_fams = PS.famwide_select(
        f_hi.reshape(-1), f_lo.reshape(-1), f_valid.reshape(-1),
        dfs.famwide, dfs.fam_w, dfs.fam_d, T.FUSED_LO_BITS)[3].reshape(
            *f_hi.shape, -1)
    f_cap = f_fams.shape[1] * f_fams.shape[2] + 1
    f_got = FG.family_group(f_fams, f_cap)
    torch.cuda.synchronize()
    max_abs_err(FG.family_group_plain(f_fams, f_cap), f_got)
    f_n = int(f_got[0].sum())
    check(f_n > 0, "family_group found no groups in the fq chunk")
    t_fq = time_group_step(TF, FG, f_fams,
                           -(-f_n // f_fams.shape[0]) * f_fams.shape[0],
                           flush, "fq chunk")
    family_group_routes(FG, off_d.device)
    out["family_group"] = dict(
        name="family_group", route="cuda",
        source="close_kmers_tpu_torch/csrc/family_group.cu",
        replaces="close_kmers_tpu/core/device_family.py:197-253",
        max_abs_err=err, ms=t["wrapper_ms"], launch_ms=t["launch_ms"],
        launch_warm_ms=t["launch_warm_ms"], earlier_ms=t["earlier_ms"],
        pack_ms=t["pack_ms"], rollup_ms=t["rollup_ms"], plain_ms=plain_ms,
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        fq_chunk={k: t_fq[k] for k in ("wrapper_ms", "launch_ms",
                                       "earlier_ms", "rollup_ms", "bound_ms")},
        library_call=None, library_ms=None)
    return out


def phase_gather_kernels(device):
    """Phase 2, probe-gather half: the four kernels of the probe-gather
    experiments against their plain versions at the experiment shapes.
    ``ms`` is the launch alone (``_launch_*``); the wrappers that check
    their ids read the range back to the host first, printed beside."""
    import torch
    from close_kmers_tpu_torch.ops import gather_exp as gx
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    gen = torch.Generator(device=device).manual_seed(2)
    clocks = sm_clocks_per_s()
    smem_rate, ops_rate = clocks * 128, clocks * 64

    def randint(high, size):
        return torch.randint(0, high, size, generator=gen, device=device,
                             dtype=torch.int32)

    out = {}

    def hold(name, replaces, what, checked, launch, plain, plain_reps, bnd,
             library=None, library_call=None):
        got = checked()
        torch.cuda.synchronize()
        err = max_abs_err([plain()], [got])
        check(bool((got != 0).any()), f"{name} gave only zeros")
        ms = cuda_ms(launch, 20)
        plain_ms = cuda_ms(plain, plain_reps)
        lib_ms = cuda_ms(library, 20) if library is not None else None
        line = f"{name}: {what}: kernel {ms:.4f} ms"
        if checked is not launch:
            line += f" ({cuda_ms(checked, 10):.4f} ms with its id-range check)"
        if lib_ms is not None:
            line += f", {library_call} {lib_ms:.4f} ms"
        log(f"{line}, plain {plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms, max_abs_err {err}")
        out[name] = dict(name=name, route="cuda",
                         source="close_kmers_tpu_torch/csrc/gather_exp.cu",
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, **bnd, library_call=library_call,
                         library_ms=lib_ms)
        return ms

    tbl = randint(100, (GX.N_ROWS, 128))
    idx = randint(GX.N_ROWS, (GX.N_IDX,))
    rows = int(torch.unique(idx).numel())
    hold("dma_gather", "scripts/gather_exp.py:109",
         f"{GX.N_IDX} ids x 128 int32 from {tuple(tbl.shape)}, depth 16",
         lambda: gx.dma_gather(tbl, idx),
         lambda: gx._launch_dma_gather(tbl, idx),
         lambda: gx.dma_gather_plain(tbl, idx), 20,
         bound(idx.numel() * 4 + rows * 512 + idx.numel() * 512),
         lambda: torch.index_select(tbl, 0, idx),
         "torch.index_select(table, 0, idx)")
    del tbl, idx

    rows, chunk = gx.VGATHER_TILE_ROWS, GX.VGATHER_CHUNK
    tile = randint(100, (rows, 128))
    vidx = randint(rows, (GX.N_IDX // chunk * chunk,))
    # shared memory: every gathered row once; the INT32 lanes: a 64-bit
    # add (two operations) for every gathered element
    smem_bytes, ops = vidx.numel() * 128 * 4, vidx.numel() * 128 * 2
    hold("vgather", "scripts/gather_exp.py:163",
         f"{vidx.numel()} ids in chunks of {chunk} on a {rows} x 128 tile "
         f"(shared-memory bound {smem_bytes / smem_rate * 1e3:.4f} ms, "
         f"INT32 bound {ops / ops_rate * 1e3:.4f} ms)",
         lambda: gx.vgather(tile, vidx, chunk),
         lambda: gx._launch_vgather(tile, vidx, chunk),
         lambda: gx.vgather_plain(tile, vidx, chunk), 10,
         bound(nbytes(vidx, tile) + vidx.numel() // chunk * 4,
               smem_bytes, smem_rate, ops, ops_rate))
    out["vgather"].update(smem_bound_ms=smem_bytes / smem_rate * 1e3,
                          alu_bound_ms=ops / ops_rate * 1e3)
    del tile, vidx

    nr = GX.N_ROWS // GX.HBM_BLK * GX.HBM_BLK
    tbl = randint(3, (nr, 128))
    fn = lambda: gx.hbmstream(tbl, GX.HBM_BLK)           # noqa: E731
    ms = hold("hbmstream", "scripts/gather_exp.py:196",
              f"{tuple(tbl.shape)} int32 in blocks of {GX.HBM_BLK} rows",
              fn, fn, lambda: gx.hbmstream_plain(tbl, GX.HBM_BLK), 5,
              bound(nbytes(tbl) + nr // GX.HBM_BLK * 4),
              lambda: tbl.sum(dtype=torch.int64),
              "table.sum(dtype=torch.int64)")
    log(f"hbmstream: {nr * 128 * 4 / ms / 1e6:.0f} GB/s")
    del tbl

    perm = torch.randperm(GX.FLUSH_DMAS, generator=gen, device=device)
    dst = perm.to(torch.int32).reshape(-1, GX.FLUSH_PER_PROG)
    buf = randint(100, (GX.FLUSH_PER_PROG * GX.FLUSH_RPD, 128))
    rpd = GX.FLUSH_RPD
    hold("dmaflush", "scripts/gather_exp.py:216",
         f"{GX.FLUSH_DMAS} copies of {rpd} x 128 int32",
         lambda: gx.dmaflush(dst, buf, rpd),
         lambda: gx._launch_dmaflush(dst, buf, rpd),
         lambda: gx.dmaflush_plain(dst, buf, rpd), 10,
         bound(nbytes(dst, buf) + GX.FLUSH_DMAS * rpd * 128 * 4))
    return out


def phase_sub_select(T, ddb, off_d, len_d, flush) -> dict:
    """Phase 2: probe_select against its plain version on the sub_blocks
    tier's shapes (the deep DB's block rows, one 4096-protein batch), timed
    as on the query cell; returns the record's fields."""
    hi, lo, valid = T.encode_windows(off_d, len_d)
    rows = T.sub_block_ids(ddb, hi, lo, valid).reshape(-1)
    return time_probe((rows, lo.reshape(-1), valid.reshape(-1)),
                      ddb.sub_blocks, ddb.sub_w, ddb.n, flush,
                      "the deep DB's sub blocks")[1]


def phase_tiers(T, db, ddb, off_d, len_d):
    """Tier phase: ``db`` built in each probe tier by from_db flags, one
    table at a time; each tier's probe of the batch must equal the
    payload-wide probe of ``ddb``.  Returns {label: (ms, peak bytes above
    the resident tensors)}."""
    import torch
    check(ddb.tier == "payload_wide", f"the corpus DB took {ddb.tier}")
    hi, lo, valid = T.encode_windows(off_d, len_d)
    want = T.probe_windows(ddb, hi, lo, valid)
    out = {}
    for label, kw in TIER_VARIANTS:
        t0 = time.time()
        d = T.DeviceDB.from_db(db, off_d.device, **kw)
        torch.cuda.synchronize()
        built = time.time() - t0
        check(d.tier == label.replace("scale_", ""),
              f"{label} flags built the {d.tier} tier")
        table = sum(getattr(d, f).numel() * 4 for f in T.DeviceDB.ARRAYS
                    if getattr(d, f) is not None)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = T.probe_windows(d, hi, lo, valid)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        max_abs_err(want, got)
        ms = cuda_ms(lambda: T.probe_windows(d, hi, lo, valid), 10)
        log(f"tiers: {label} ({d.tier}): {table} B of tables built and "
            f"uploaded in {built:.1f} s; probe of {hi.numel()} windows "
            f"{ms:.4f} ms, peak {peak} B above the resident tensors; equal "
            f"to the payload-wide probe")
        out[label] = (ms, peak)
        del d, got
        torch.cuda.empty_cache()
    return out


def spelled_queries(db, n: int, rng):
    """``n`` proteins of PROT_LEN aa, each PROT_LEN // 8 back-to-back DB
    kmers of one function (so that calls form), then random residues,
    padded as build_corpus pads."""
    n_k = PROT_LEN // 8
    order = np.argsort(db.fi, kind="stable")
    fi_sorted = db.fi[order]
    funcs = np.unique(fi_sorted)
    first = np.searchsorted(fi_sorted, funcs)
    count = np.searchsorted(fi_sorted, funcs, side="right") - first
    f = rng.integers(0, len(funcs), size=n)
    pick = first[f][:, None] + (rng.random((n, n_k))
                                * count[f][:, None]).astype(np.int64)
    keys = db.keys[order[pick]]
    pow20 = 20 ** np.arange(7, -1, -1, dtype=np.int64)
    width = -(-(PROT_LEN + 8) // 8) * 8
    offsets = np.full((n, width), 20, dtype=np.uint8)
    offsets[:, :8 * n_k] = ((keys[:, :, None] // pow20) % 20).reshape(n, -1)
    offsets[:, 8 * n_k:PROT_LEN] = rng.integers(0, 20,
                                                size=(n, PROT_LEN - 8 * n_k))
    return offsets, np.full(n, PROT_LEN, dtype=np.int32)


def phase_query(host, T, ds, eng, db, offsets, lengths, params, label,
                card):
    """Phase 4, /query on one DB: every query through DeviceScorer (slim
    pack + native.best_call_batch) and through the device best-call path
    (phase_best_calls), SAMPLE through KmerEngine.annotate_with_hits, and
    the sample against native.HashPipeline and the searchsorted
    native.score_batch reference.  Returns (DeviceScorer proteins/s,
    engine proteins/s, the best-call rates)."""
    import torch
    n_query = len(offsets)
    slim = ds.slim_mode()
    unpack = {2: ds.unpack_dense2, 3: ds.unpack_dense3}[slim]
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, n_query, BATCH)]

    def score_all(cap_per_seq):
        counts, natives = [], []
        n_calls_total = 0
        for c_off, c_len in chunks:
            cap = cap_per_seq
            while True:
                out, cap_n = ds.score_batch_packed(c_off, c_len, params,
                                                   calls_per_seq_cap=cap,
                                                   slim=slim)
                dense = unpack(out.cpu().numpy(), len(c_off), cap_n)
                if dense is not None:
                    break
                cap *= 4
            n_calls, cc, cf, cw = dense
            natives.append(host.native.best_call_batch(n_calls, None, None,
                                                       cc, cf, cw))
            counts.append((n_calls, cc, cf, cw))
            n_calls_total += int(n_calls.sum())
        return counts, n_calls_total, natives

    score_all(2)                                     # warm-up pass
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        counts, n_calls_total, natives = score_all(2)
        torch.cuda.synchronize()
        passes.append(time.time() - t0)
    dt_ds = sorted(passes)[1]
    rate_ds = n_query / dt_ds
    log(f"phase 4 {label}: DeviceScorer slim={slim} on {ds.ddb.tier}: "
        f"{n_query} proteins, {n_calls_total} calls per pass; passes "
        f"{passes} s; median {dt_ds:.4f} s = {rate_ds:.0f} proteins/s")
    rates_best = phase_best_calls(T, ds, db, chunks,
                                  lambda: score_all(2)[2], params, label,
                                  card)

    alpha = np.frombuffer(host.encoder.PROT_ALPHA.encode(), np.uint8)
    items = [(f"q{i}", alpha[offsets[i, :lengths[i]]].tobytes().decode())
             for i in range(SAMPLE)]
    eng.annotate_with_hits(items[:64], params, want_otu=True,
                           want_code=False)             # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    results, _h = eng.annotate_with_hits(items, params, want_otu=True,
                                         want_code=False)
    dt_eng = time.time() - t0
    rate_eng = SAMPLE / dt_eng
    log(f"phase 4 {label}: KmerEngine.annotate_with_hits on "
        f"{eng.fa.ddb.tier}: {SAMPLE} proteins in {dt_eng:.3f} s = "
        f"{rate_eng:.0f} proteins/s")

    # correctness on the sample: independent CPU references
    s_off, s_len = offsets[:SAMPLE], lengths[:SAMPLE]
    t0 = time.time()
    hp_counts = host.native.HashPipeline(db).run(s_off, s_len,
                                                 params.min_hits,
                                                 params.max_gap)
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(host, T, db, s_off, s_len,
                                                   params)
    log(f"phase 4 {label}: CPU references for {SAMPLE} proteins in "
        f"{time.time() - t0:.1f} s")
    ds_n, ds_cc, ds_cf, ds_cw = counts[0]
    check(np.array_equal(hp_counts, n_ref),
          "HashPipeline and the searchsorted reference disagree")
    check(np.array_equal(ds_n, hp_counts),
          "DeviceScorer call counts differ from HashPipeline")
    check(int(ds_n.sum()) > 0, "no calls in the sample")
    eng_n = np.array([len(r.calls) for r in results])
    check(np.array_equal(eng_n, hp_counts),
          "KmerEngine call counts differ from HashPipeline")
    for s, r in enumerate(results):
        want = [(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]), int(cf[s, i]),
                 int(np.float32(cw[s, i]).view(np.int32)))
                for i in range(int(n_ref[s]))]
        got = [(c.start, c.end, c.count, c.fI,
                int(np.float32(c.weighted).view(np.int32)))
               for c in r.calls]
        check(got == want, f"KmerEngine calls differ for query {s}")
        got_ds = [(int(ds_cc[s, i]), int(ds_cf[s, i]),
                   int(np.float32(ds_cw[s, i]).view(np.int32)))
                  for i in range(int(ds_n[s]))]
        check(got_ds == [w[2:] for w in want],
              f"DeviceScorer calls differ for query {s}")
    log(f"phase 4 {label}: {SAMPLE}-protein sample matches the native CPU "
        f"references ({int(n_ref.sum())} calls)")
    return rate_ds, rate_eng, rates_best


def _reads_body(name: str) -> bytes:
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _post(path: bytes, body: bytes) -> bytes:
    return (b"POST " + path + b" HTTP/1.1\nContent-length: %d\n\n"
            % len(body) + body)


def _matrix_body(body: bytes) -> bytes:
    """tests/test_golden.py _matrix_body: A = q1, B = q1[:60] + q2[60:],
    C = q2, from the golden queries."""
    import re
    seqs = dict(re.findall(rb">(\S+)[^\n]*\n([A-Z\n]+)", body))
    s1 = seqs[b"q1"].replace(b"\n", b"")
    s2 = seqs[b"q2"].replace(b"\n", b"")
    return (b">A\n" + s1 + b"\n>B\n" + s1[:60] + s2[60:] + b"\n>C\n"
            + s2 + b"\n")


# tests/test_golden.py CONVS: one request, or a list played in turn
GOLDEN_CONVS = {
    "version": lambda body: b"GET /version HTTP/1.1\n\n",
    "query": lambda body:
        b"POST /query HTTP/1.1\nContent-length: %d\n\n" % len(body) + body,
    "query_details": lambda body:
        b"POST /query?details=1&min_hits=3 HTTP/1.1\nContent-length: %d\n\n"
        % len(body) + body,
    "query_best": lambda body:
        b"POST /query?find_best_call=1 HTTP/1.1\nContent-length: %d\n\n"
        % len(body) + body,
    "lookup": lambda body: _post(b"/lookup", body),
    "lookup_best": lambda body: _post(
        b"/lookup?find_best_match=1&target_genus=Escherichia", body),
    "wadd": lambda body: _post(b"/mapping/gold_add/add", body),
    "xmatrix": lambda body: [
        _post(b"/mapping/gold_m/add?silent=1", _matrix_body(body)),
        _post(b"/mapping/gold_m/matrix", _matrix_body(body))],
    "yfq": lambda body: _post(b"/fq_lookup", _reads_body("reads.fq")),
    "zfq_gz": lambda body: _post(b"/fq_lookup", _reads_body("reads.fq.gz")),
}

# tests/test_server.py test_device_family_server_byte_identical's modes
FAMILY_MODES = [b"/lookup?find_best_match=1&target_genus=Escherichia",
                b"/lookup?find_best_match=1&allow_ambiguous_functions=1",
                b"/lookup", b"/lookup?find_reps=1"]


def _http(port: int, req: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(req)
        out = b""
        while True:
            c = s.recv(65536)
            if not c:
                return out
            out += c


class _Server:
    """A kser context served on a thread of this process."""

    def __init__(self, ctx):
        from close_kmers_tpu_torch.server.http import handle_connection
        self.ctx = ctx
        self.loop = asyncio.new_event_loop()
        holder = {}
        ready = threading.Event()

        async def run():
            srv = await asyncio.start_server(
                lambda r, w: handle_connection(r, w, ctx), "127.0.0.1", 0)
            holder["port"] = srv.sockets[0].getsockname()[1]
            ready.set()
            async with srv:
                await ctx.stop_event.wait()

        self.thread = threading.Thread(
            target=lambda: self.loop.run_until_complete(run()))
        self.thread.start()
        check(ready.wait(120), "golden server did not start")
        self.port = holder["port"]

    def close(self):
        self.loop.call_soon_threadsafe(self.ctx.stop_event.set)
        self.thread.join(60)
        self.ctx._compute.shutdown()
        self.loop.close()
        check(not self.thread.is_alive(), "golden server thread did not stop")


def phase_golden(device) -> None:
    """Phase 3: the golden conversations through the port's server with
    its engine on the card, then the device family program against the
    host family path on every /lookup mode and /fq_lookup."""
    from close_kmers_tpu_torch.cli.kser import load_server_context

    data = os.path.join(GOLDEN, "data")
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    servers = []
    try:
        host = _Server(load_server_context(data, batch_size=64,
                                           device=device))
        servers.append(host)
        for name, make in GOLDEN_CONVS.items():
            with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
                want = f.read()
            reqs = make(body)
            got = b"".join(_http(host.port, r) for r in (
                [reqs] if isinstance(reqs, bytes) else reqs))
            check(got == want, f"golden conversation {name} differs:\n"
                  f"{got[:400]!r}")
            log(f"golden {name}: {len(got)} bytes identical")
        dev_ctx = load_server_context(data, batch_size=64, device=device)
        dev_ctx.engine.device_family_min = 0
        dev = _Server(dev_ctx)
        servers.append(dev)
        reqs = [_post(m, body) for m in FAMILY_MODES]
        reqs.append(_post(b"/fq_lookup", _reads_body("reads.fq")))
        for req in reqs:
            want = _http(host.port, req)
            got = _http(dev.port, req)
            check(got == want and b"PGF_" in got,
                  f"device family program differs on {req[:60]!r}")
        root = dev_ctx.mapping_map[""]
        check(dev_ctx.engine._family_scorers[root][1] is not None,
              "the forced context did not build a device family scorer")
        log(f"golden: device family program byte-identical to the host "
            f"family path on {len(reqs)} requests")
    finally:
        for srv in servers:
            srv.close()


def reference_calls(host, T, db, offsets, lengths, params, max_calls=64):
    """Independent CPU reference for a sample: hits by a numpy
    searchsorted over the DB keys, scored by native.score_batch (at most
    ``max_calls`` calls a sequence)."""
    K = host.params.K
    B, L = offsets.shape
    W = L - K
    pos = np.arange(W)[None, :]
    windows_ok = pos < lengths[:, None] - K          # kguts.cc:792 bound
    bad = offsets >= 20
    for j in range(K):
        windows_ok &= ~bad[:, j:j + W]
    bi, p, codes = T._hit_codes(windows_ok, offsets)
    idx = np.minimum(np.searchsorted(db.keys, codes), len(db) - 1)
    hit = db.keys[idx] == codes
    bi, p, idx = bi[hit], p[hit], idx[hit]
    row_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.bincount(bi, minlength=B), out=row_off[1:])
    return host.native.score_batch(p, db.fi[idx], db.oi[idx],
                                   db.avg_off[idx], db.wt[idx], row_off,
                                   params, max_calls_per_seq=max_calls)


def phase_family(TF, eng, mapping, offsets, lengths, params, device):
    """Phase 4, family: all queries through best_family_matches_padded
    (famwide, by the auto gate), the same chunks through a two-gather
    scorer with equal packs, and a sample against the host path."""
    import torch
    from close_kmers_tpu_torch.core.device_score import DeviceScorer
    dfs = eng._device_family_scorer(mapping)
    check(dfs is not None and dfs.famwide is not None,
          "the auto gate did not take the famwide path")
    eng.best_family_matches_padded(offsets[:BATCH], lengths[:BATCH],
                                   mapping)                  # warm-up
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        ms = eng.best_family_matches_padded(offsets, lengths, mapping)
        passes.append(time.time() - t0)
    dt = sorted(passes)[1]
    placed = sum(1 for m in ms if m.gfam_id)
    check(len(ms) == N_QUERY and placed > N_QUERY // 2,
          f"only {placed} of {len(ms)} proteins placed in a family")
    log(f"phase 4: family best-match (famwide): {N_QUERY} proteins, "
        f"{placed} placed; passes {passes} s; median {dt:.4f} s = "
        f"{N_QUERY / dt:.0f} proteins/s")

    tg = TF.DeviceFamilyScorer(eng.db, mapping, device, ddb=eng.fa.ddb,
                               famwide=False)
    ccap, gps = dfs.bm_calls_per_seq, dfs.bm_groups_per_seq
    fold_calls, fold_rows = dfs.pack_flags(offsets.shape[1])
    unpack = (DeviceScorer.unpack_dense2 if fold_calls
              else DeviceScorer.unpack_dense3)
    spent = {"famwide": 0.0, "two-gather": 0.0}
    for _ in range(2):                   # the first round warms both
        spent = dict.fromkeys(spent, 0.0)
        for a in range(0, N_QUERY, BATCH):
            c_off, c_len = offsets[a:a + BATCH], lengths[a:a + BATCH]
            packs = {}
            for name, sc in (("famwide", dfs), ("two-gather", tg)):
                torch.cuda.synchronize()
                t0 = time.time()
                calls, call_cap, rows, _, id_check = sc.score_family_packed(
                    c_off, c_len, params, ccap, -gps * BATCH,
                    slim_calls=True)
                torch.cuda.synchronize()
                spent[name] += time.time() - t0
                packs[name] = (calls.cpu(), rows.cpu())
                id_check.raise_if_bad()
            (fc, fr), (gc, gr) = packs["famwide"], packs["two-gather"]
            check(torch.equal(fc, gc) and torch.equal(fr, gr),
                  f"famwide and two-gather packs differ at chunk {a}")
            check(unpack(fc.numpy(), BATCH, call_cap) is not None
                  and TF.DeviceFamilyScorer.finish_rollup_global(
                      fr.numpy(), BATCH, gps * BATCH, folded=fold_rows)
                  is not None, f"packs overflowed at chunk {a}")
    log(f"phase 4: famwide and two-gather packs equal on all "
        f"{N_QUERY // BATCH} chunks; fused program (upload to packs, "
        f"synced) per {N_QUERY}: famwide {spent['famwide']:.4f} s, "
        f"two-gather {spent['two-gather']:.4f} s")

    eng.device_family = False
    try:
        t0 = time.time()
        want = eng.best_family_matches_padded(offsets[:SAMPLE],
                                              lengths[:SAMPLE], mapping)
    finally:
        eng.device_family = True
    check(want == ms[:SAMPLE],
          "family best matches differ from the host path on the sample")
    log(f"phase 4: {SAMPLE}-protein family sample equals the host path "
        f"(native.family_scores + find_best_family_match, "
        f"{time.time() - t0:.1f} s)")
    return N_QUERY / dt, spent


def make_reads(host, eng, offsets):
    """The reads of phase 4 (scripts/fq_bench.py synth_reads, seed 3) and
    the first chunk of their ORF batch as best_family_matches_padded
    cuts it.  Returns (reads, ORF count, (offsets, lengths) of the
    chunk)."""
    t0 = time.time()
    reads = synth_reads(np.random.default_rng(3), offsets[:2048, :PROT_LEN],
                        N_READS, READ_LEN)
    o_off, o_len, _ = host.translate.batch_orf_arrays(
        [seq for _, seq in reads])
    B = eng._chunk_rows(o_off.shape[0], o_off.shape[1])
    log(f"set-up: {N_READS} reads x {READ_LEN} bp, {o_off.shape[0]} ORFs "
        f"padded to {o_off.shape[1]} aa (chunks of {B}), in "
        f"{time.time() - t0:.1f} s")
    return reads, o_off.shape[0], (o_off[:B], o_len[:B])


def phase_reads(eng, mapping, reads, n_orfs, params):
    """Phase 4, reads: the /fq_lookup compute path on synthetic reads,
    and a sample against the host family path."""
    import torch
    from close_kmers_tpu_torch.server.http import (Request, ServerContext,
                                                   process_reads)
    ctx = ServerContext(eng, family_mode=True)
    ctx.mapping_map[""] = mapping
    req = Request()
    try:
        def run(rs):
            return asyncio.run(process_reads(ctx, rs, params, req))

        run(reads[:2000])                                     # warm-up
        passes = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            text = run(reads)
            passes.append(time.time() - t0)
        dt = sorted(passes)[1]
        called = text.count("\n")
        check(called > N_READS // 4, f"only {called} reads called")
        log(f"phase 4: /fq_lookup path: {N_READS} reads, {called} called; "
            f"passes {passes} s; median {dt:.4f} s = {N_READS / dt:.0f} "
            f"reads/s = {n_orfs / dt:.0f} ORF proteins/s")
        dev_text = run(reads[:READ_SAMPLE])
        eng.device_family = False
        try:
            host_text = run(reads[:READ_SAMPLE])
        finally:
            eng.device_family = True
        check(dev_text and dev_text == host_text,
              "/fq_lookup output differs from the host family path")
        log(f"phase 4: {READ_SAMPLE}-read /fq_lookup sample equals the host "
            f"family path ({dev_text.count(chr(10))} lines)")
    finally:
        ctx._compute.shutdown()
    return N_READS / dt, n_orfs / dt


def synth_genome(rng, src_off: np.ndarray, n_bases: int) -> str:
    """scripts/dna_bench.py synth_genome: reverse-translated source
    proteins alternating with 900 bases of random DNA."""
    parts = []
    total = 0
    i = 0
    bases = np.array(list("ACGT"))
    while total < n_bases:
        if i % 2 == 0:
            prot = src_off[rng.integers(0, len(src_off))]
            dna = "".join(CODON[o] for o in prot)
        else:
            dna = "".join(rng.choice(bases, size=900))
        parts.append(dna)
        total += len(dna)
        i += 1
    return "".join(parts)[:n_bases]


def scan_record(S, sargs, init, pos0, final_flush, flush) -> dict:
    """scan_score held against its plain version on the genome program's
    scan inputs (``sargs``), chained from ``init`` with emit and
    ``final_flush``, and the state alone; each timed as the path calls
    it (the wrapper) and by launch alone, L2 flushed, with its bound."""
    import torch
    found, fi, av, wt = sargs[:4]
    rec = {}
    for mode, kw in (("emit", dict(want_emit=True, final_flush=final_flush)),
                     ("state_only", dict(want_emit=False))):
        got = S.scan_score(*sargs, init=init, pos0=pos0, **kw)
        torch.cuda.synchronize()
        want = S.scan_score_plain(*sargs, init=init, pos0=pos0, **kw)
        torch.cuda.synchronize()
        planes = [] if want[0] is None else [want[0], *want[1]]
        got_planes = [] if got[0] is None else [got[0], *got[1]]
        check(len(planes) == len(got_planes), f"scan {mode}: planes differ")
        err = max_abs_err(planes + list(want[2].values()),
                          got_planes + list(got[2].values()))
        if mode == "emit":
            check(int(want[0].sum()) > 0, "the genome scan emitted no calls")
        largs = (*S._prepare(found, fi, av, wt, init, pos0, kw["want_emit"],
                             kw.get("final_flush")), *sargs[4:])
        ins = nbytes(found, fi, av, wt, pos0, *init.values())
        if final_flush is not None and mode == "emit":
            ins += nbytes(final_flush)
        rec[mode] = dict(
            max_abs_err=err,
            ms=cuda_ms_cold(lambda: S.scan_score(*sargs, init=init, pos0=pos0,
                                                 **kw), 10, flush),
            launch_ms=cuda_ms_cold(lambda: S._launch(*largs), 10, flush),
            plain_ms=cuda_ms(lambda: S.scan_score_plain(
                *sargs, init=init, pos0=pos0, **kw), 1),
            **bound(ins + nbytes(*planes, *got[2].values())))
    return rec


def phase_genome_kernels(T, TG, S, ddb, digits, n_true, params, flush):
    """Phase 2, genome: probe_select on the 5-Mbp genome's tile windows
    and scan_score on its scan inputs (9,984 rows x 1,016 windows),
    chained and state-only, each against its plain version.  Returns the
    two records' ``genome`` fields."""
    import torch
    tiles, tlens, pos0, t_of, n_t = TG._genome_tiles(digits, n_true)
    hi, lo, valid = T.encode_windows(tiles, tlens)
    flat = (hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    got, probe = time_probe(flat, ddb.payload_wide, ddb.wide_w, ddb.n, flush,
                            "the genome's windows")
    found, fi, _oi, av, wt, _idx = (x.reshape(hi.shape) for x in got)
    sargs = (found, fi, av, wt, params.min_hits, params.min_weighted_hits,
             params.max_gap, params.order_constraint)
    # a chained init as the fixpoint builds one: each row takes the
    # previous row's final state (rows of one [13, B] int32 buffer)
    _, _, fin = S.scan_score(*sargs, pos0=pos0, want_emit=False)
    init = TG._state_of(torch.roll(TG._packed_state(fin), 1, dims=1))
    scan = scan_record(S, sargs, init, pos0, t_of == n_t - 1, flush)
    scan.update(B=hi.shape[0], W=hi.shape[1])
    e, so = scan["emit"], scan["state_only"]
    log(f"scan_score at the genome's shape: B={hi.shape[0]} W={hi.shape[1]}:"
        f" with emit {e['ms']:.4f} ms as called, {e['launch_ms']:.4f} ms "
        f"launch alone, bound {e['bound_ms']:.4f} ms, plain "
        f"{e['plain_ms']:.1f} ms; state only {so['ms']:.4f} ms as called, "
        f"{so['launch_ms']:.4f} ms launch alone, bound {so['bound_ms']:.4f} "
        f"ms, plain {so['plain_ms']:.1f} ms (L2 flushed); equal to the plain "
        f"version, chained and state-only")
    return probe, scan


def device_share(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the card's
    busy ms (the summed device intervals of its kernels and copies, one
    stream) and the five names that took most of it.  ``busy_ms`` is
    None where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall, busy_ms=busy,
                top=[(name[:60], ms) for name, ms in top])


def phase_genome(host, T, TG, eng, db, genome: str, params) -> dict:
    """Phase 4, genome: the 5-Mbp genome through GenomeAnnotator.calls_of
    (best of passes, Mbp/s), its fixpoint rounds and kernel launches per
    genome, and all six frames' call lists against the native CPU
    reference over translate.six_frame_kguts_offsets."""
    import torch
    from close_kmers_tpu_torch.ops.probe_select import probe_select
    from close_kmers_tpu_torch.ops.scan_score import scan_score
    tr = host.translate
    digits = tr._DNA_CHAR[tr._to_bytes(genome)]   # parsed once, as a server
    ga = TG.GenomeAnnotator(eng)
    ga.calls_of(digits, params)                                 # warm-up
    before = (probe_select.launches, scan_score.launches)
    per_frame, frames = ga.calls_of(digits, params)
    per_genome = (probe_select.launches - before[0],
                  scan_score.launches - before[1])
    _, rounds, n_t = ga.dispatch(digits, params)
    passes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        ga.calls_of(digits, params)
        passes.append(time.time() - t0)
    best = min(passes)
    n_calls = int(per_frame.sum())
    log(f"phase 4: genome: {len(genome):,} bp, T={n_t} tiles a frame, "
        f"{rounds} fixpoint rounds, {n_calls} calls; launches per genome: "
        f"probe_select {per_genome[0]}, scan_score {per_genome[1]}; passes "
        f"{passes} s; best {best:.4f} s = "
        f"{len(genome) / best / 1e6:.2f} Mbp/s")
    check(n_calls > 1000, f"only {n_calls} calls in the genome")
    check(min(per_genome) > 0, "the genome path launched no kernel")
    prof = device_share(lambda: ga.calls_of(digits, params))
    log(f"phase 4: genome: one pass profiled: {prof}")

    t0 = time.time()
    fr = tr.six_frame_kguts_offsets(genome)
    L = max(len(p) for _s, _o, p in fr)
    fr_off = np.full((6, -(-(L + 1) // 8) * 8), 20, dtype=np.uint8)
    fr_len = np.zeros(6, dtype=np.int32)
    for i, (_s, _o, p) in enumerate(fr):
        fr_off[i, :len(p)] = p
        fr_len[i] = len(p)
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(
        host, T, db, fr_off, fr_len, params, max_calls=65536)
    check(np.array_equal(n_ref, per_frame),
          f"per-frame call counts {per_frame} differ from the reference "
          f"{n_ref}")
    for f in range(6):
        want = [(int(cs[f, i]), int(ce[f, i]), int(cc[f, i]), int(cf[f, i]),
                 int(np.float32(cw[f, i]).view(np.int32)))
                for i in range(int(n_ref[f]))]
        got = [c[:4] + (int(np.float32(c[4]).view(np.int32)),)
               for c in frames[f]]
        check(got == want,
              f"genome frame {f}: calls differ from the reference")
    log(f"phase 4: genome: all six frames' {n_calls} calls equal the native "
        f"CPU reference (searchsorted hits + native.score_batch, "
        f"{time.time() - t0:.1f} s)")
    return dict(mbp_s=len(genome) / best / 1e6, rounds=rounds,
                launches=per_genome, calls=n_calls, profile=prof)


def matrix_csr(db, rng):
    """bench.py bench_matrix's kmer->peg CSR: degree 1-3 over the DB's
    rows, peg ids in [0, 2P) from each kmer's function, rank = id for the
    first P pegs (the matrix proteins, in row order)."""
    n = len(db)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = ((np.repeat(db.fi.astype(np.int64) * 3, deg)
             + (np.arange(offs[-1]) % 3)) % (2 * MATRIX_P)).astype(np.int64)
    rank = np.full(2 * MATRIX_P, 1 << 20, dtype=np.int64)
    rank[:MATRIX_P] = np.arange(MATRIX_P)
    return offs, vals, rank


def replay_pairs(db, offsets, lengths, offs, vals, rank) -> dict:
    """The registration rule in numpy: each hit kmer of protein s counts
    every peg o of its CSR list with rank[o] < s (matrix_request.cc:
    130-161).  Independent of the device program and of the port."""
    K = 8
    B, L = offsets.shape
    W = L - K
    ok = np.arange(W)[None, :] < lengths[:, None] - K
    bad = offsets >= 20
    for j in range(K):
        ok &= ~bad[:, j:j + W]
    bi, pos = np.nonzero(ok)
    codes = np.zeros(len(pos), dtype=np.int64)
    for j in range(K):
        codes = codes * 20 + offsets[bi, pos + j]
    row = np.minimum(np.searchsorted(db.keys, codes), len(db) - 1)
    hit = db.keys[row] == codes
    bi, row = bi[hit], row[hit]
    deg = offs[row + 1] - offs[row]
    s = np.repeat(bi, deg)
    start = np.repeat(offs[row] - np.concatenate([[0], np.cumsum(deg)[:-1]]),
                      deg)
    o = vals[start + np.arange(int(deg.sum()))]
    keep = rank[o] < s
    key = s[keep] << 15 | rank[o[keep]]
    k, c = np.unique(key, return_counts=True)
    return {(int(a >> 15), int(a & 0x7FFF)): int(n) for a, n in zip(k, c)}


def phase_matrix(host, TM, eng, db, offsets, lengths, rng) -> dict:
    """Phase 4, matrix: bench.py's matrix cell (P = 2,048 query proteins,
    the degree-1-3 CSR, rank over 2P, max_deg 3) through
    DeviceMatrix.count_pairs (best of passes, proteins/s), held against
    native.matrix_hash and, on a prefix, the numpy replay."""
    import torch
    from close_kmers_tpu_torch.ops.probe_select import probe_select
    t0 = time.time()
    offs, vals, rank = matrix_csr(db, rng)
    off_m, len_m = offsets[:MATRIX_P], lengths[:MATRIX_P]
    dm = TM.DeviceMatrix(eng, max_deg=3)
    po, pv = dm.stage_csr(offs, vals)
    torch.cuda.synchronize()
    log(f"set-up: matrix CSR of {len(vals):,} pegs built and staged in "
        f"{time.time() - t0:.1f} s")
    dm.count_pairs(off_m, len_m, po, pv, rank)                  # warm-up
    before = probe_select.launches
    pairs = dm.count_pairs(off_m, len_m, po, pv, rank)
    launches = probe_select.launches - before
    passes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        dm.count_pairs(off_m, len_m, po, pv, rank)
        passes.append(time.time() - t0)
    best = min(passes)
    shared = sum(pairs.values())
    log(f"phase 4: matrix: {MATRIX_P} proteins, {len(pairs)} pairs, {shared} "
        f"shared kmer-peg hits; probe_select launches {launches}; passes "
        f"{passes} s; best {best:.4f} s = {MATRIX_P / best:.0f} proteins/s")
    check(launches > 0, "the matrix path launched no probe_select")
    prof = device_share(lambda: dm.count_pairs(off_m, len_m, po, pv, rank))
    log(f"phase 4: matrix: one request profiled: {prof}")
    t0 = time.time()
    hp = host.native.HashPipeline(db)
    pm = host.native.PegMapRef(db.keys, offs, vals)
    got_c = host.native.matrix_hash(hp, pm, off_m, len_m)
    check(got_c == (len(pairs), shared),
          f"matrix_hash gives {got_c}, the device {(len(pairs), shared)}")
    want = replay_pairs(db, off_m[:MATRIX_PREFIX], len_m[:MATRIX_PREFIX],
                        offs, vals, rank)
    got = {k: v for k, v in pairs.items() if k[0] < MATRIX_PREFIX}
    check(got == want and len(want) > 0,
          f"the first {MATRIX_PREFIX} proteins' pairs differ from the replay")
    log(f"phase 4: matrix equals native.matrix_hash ({got_c[0]} pairs, "
        f"{got_c[1]} shared) and the numpy replay of the first "
        f"{MATRIX_PREFIX} proteins ({len(want)} pairs), "
        f"{time.time() - t0:.1f} s")
    return dict(proteins_s=MATRIX_P / best, launches=launches,
                pairs=len(pairs), profile=prof)


def calls_case(rng, B: int, M: int, p_emit: float, n_funcs: int):
    """Scan outputs for best_call: emit at rate ``p_emit``, counts 1-13
    (bridges merge and not), few functions and a small weight set with
    both signed zeros (totals tie)."""
    w = np.array([0.1, 0.3, 0.5, 1.0, 1.5, 2.0, -0.0, 0.0], np.float32)
    return (rng.random((B, M)) < p_emit,
            rng.integers(1, 14, size=(B, M)).astype(np.int32),
            rng.integers(0, n_funcs, size=(B, M)).astype(np.int32),
            rng.choice(w, size=(B, M)))


BC_WIDTHS = (1, 2, 15, 16, 17, 32, 33, 313, 511, 512, 513, 1017)


def best_call_sweep(BC, device) -> int:
    """best_call against its plain version at B in {1, 33, 4097} x W+1 in
    BC_WIDTHS (one byte, both sides of a 16-B word, of the 32-call cap and
    of a warp's 512-B round), sparse and dense emits; on column slices of
    wider rows (row starts off 16-B alignment, strides not multiples of
    16); and on a batch of 64 rows of 0 to 63 calls (past the 32-call cap
    from row 33 on), whose overflow flags must say so.  Returns the number
    of cases held."""
    import torch
    n = 0
    for B in (1, 33, 4097):
        for M in BC_WIDTHS:
            for p_emit in (0.1, 0.95):
                rng = np.random.default_rng(B * 1000 + M + int(p_emit * 10))
                x = [torch.from_numpy(a).to(device)
                     for a in calls_case(rng, B, M, p_emit, 2 + M % 4)]
                got = BC.best_call(*x)
                torch.cuda.synchronize()
                max_abs_err([BC.best_call_plain(*x)], [got])
                n += 1
    for M in (16, 305, 513, 1017):
        for col0, pad in ((1, 0), (7, 9), (15, 1)):
            rng = np.random.default_rng(M * 100 + col0)
            x = [torch.from_numpy(a).to(device)[:, col0:col0 + M]
                 for a in calls_case(rng, 4097, col0 + M + pad, 0.1, 3)]
            got = BC.best_call(*x)
            torch.cuda.synchronize()
            max_abs_err([BC.best_call_plain(*x)], [got])
            n += 1
    rng = np.random.default_rng(64)
    emit, cnt, fi, wt = calls_case(rng, 64, 313, 0.0, 3)
    for r in range(64):
        emit[r, rng.choice(313, size=r, replace=False)] = True
    x = [torch.from_numpy(a).to(device) for a in (emit, cnt, fi, wt)]
    got = BC.best_call(*x)
    torch.cuda.synchronize()
    max_abs_err([BC.best_call_plain(*x)], [got])
    check(got[:, 8].tolist() == [int(r > BC.CAPC) for r in range(64)],
          "best_call's overflow flags are wrong")
    return n + 1


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn``: the time to enqueue its work,
    ``n`` calls between two synchronisations (few enough that the launch
    queue never fills), the least of three runs."""
    import torch
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def best_call_tree(root: str, label: str):
    """best_call as the tree at ``root`` has it: its csrc/best_call.cu
    built alone by nvcc into the port's .build/, and its ops/best_call.py
    loaded as a module of its own that launches from that library.  To
    time another version of the kernel and its wrapper (the parent
    commit's, unpacked by ``git archive``) beside this tree's, in one
    process on one card."""
    import ctypes
    import importlib.util
    import subprocess
    from close_kmers_tpu_torch.ops import _build
    pkg = os.path.join(os.path.abspath(root), "close_kmers_tpu_torch")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, f"best_call_{label}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path,
         os.path.join(pkg, "csrc", "best_call.cu")],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc failed on {label}'s best_call.cu:\n"
          f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fns = {}

    def kernel(name, argtypes):
        if name not in fns:
            fns[name] = getattr(lib, name)
            fns[name].argtypes, fns[name].restype = argtypes, ctypes.c_int
        return fns[name]

    spec = importlib.util.spec_from_file_location(
        f"close_kmers_tpu_torch.ops._best_call_{label}",
        os.path.join(pkg, "ops", "best_call.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(kernel=kernel, check=_build.check)
    return mod


def best_call_record(BC, emit, fields, deep, flush, compare) -> dict:
    """Phase 2: best_call against its plain version on the query cell's
    scan outputs (the call planes as the scan lays them out: strided views
    of one allocation) and on the deep cell's ``deep``; timed as the path
    calls it (the wrapper) and by launch alone, L2 flushed, beside the
    launch floor (a one-element fill_, timed the same way), all in turns
    (:func:`cuda_ms_cold_turns`); back to back with the L2 warm
    (:func:`graph_ms`); its bound; the wrapper's host cost and its parts;
    then the sweep.  ``compare`` maps labels to other versions
    (:func:`best_call_tree`), held to the plain version and timed in the
    same turns."""
    import torch
    args = (emit, fields[2], fields[3], fields[4])
    versions = {"this": BC, **compare}
    dev = emit.device
    one = torch.empty(1, dtype=torch.int32, device=dev)
    want = [BC.best_call_plain(*args), BC.best_call_plain(*deep)]
    fns = {"floor": lambda: one.fill_(1)}
    warm = {"floor": graph_ms(lambda: one.fill_(1))}
    errs = {}
    for label, mod in versions.items():
        got = [mod.best_call(*args), mod.best_call(*deep)]
        torch.cuda.synchronize()
        errs[label] = max_abs_err(want, got)
        out, out_d = torch.empty_like(got[0]), torch.empty_like(got[1])
        fns[f"{label}/launch"] = (lambda m, o: lambda: m._launch(*args, o))(
            mod, out)
        fns[f"{label}/deep"] = (lambda m, o: lambda: m._launch(*deep, o))(
            mod, out_d)
        fns[f"{label}/called"] = (lambda m: lambda: m.best_call(*args))(mod)
        warm[label] = graph_ms(fns[f"{label}/launch"])
    check(int((want[0][:, 0] > 0).sum()) > 0, "best_call found no function")
    cold = cuda_ms_cold_turns(fns, 40, flush)
    host = {}
    for label in [*versions, *reversed(versions)]:
        host.setdefault(label, []).append(
            host_us(lambda: versions[label].best_call(*args)))
    fn = BC._build.kernel("ck_best_call_device", BC._ARGTYPES)
    out = torch.empty_like(want[0], device=dev)
    raw = (emit.data_ptr(), emit.stride(0), args[1].data_ptr(),
           args[1].stride(0), args[2].data_ptr(), args[2].stride(0),
           args[3].data_ptr(), args[3].stride(0), *emit.shape,
           out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def guard():
        with torch.cuda.device(dev):
            pass

    def times(label):
        return dict(ms=cold[f"{label}/called"],
                    launch_ms=cold[f"{label}/launch"],
                    deep_launch_ms=cold[f"{label}/deep"],
                    warm_ms=warm[label], host_us=host[label])

    rec = dict(
        max_abs_err=errs["this"], **times("this"), floor_ms=cold["floor"],
        floor_warm_ms=warm["floor"],
        plain_ms=cuda_ms(lambda: BC.best_call_plain(*args), 3),
        host_parts_us=dict(
            launch=host_us(lambda: BC._launch(*args, out)),
            ctypes_call=host_us(lambda: fn(*raw)),
            check=host_us(lambda: BC._check(*args)),
            empty=host_us(lambda: torch.empty((emit.shape[0], 9),
                                              dtype=torch.int32, device=dev)),
            device_guard=host_us(guard),
            current_device=host_us(torch.cuda.current_device),
            stream_object=host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            raw_stream=host_us(
                lambda: torch._C._cuda_getCurrentRawStream(dev.index))),
        compare={k: times(k) for k in compare})
    # the emit bytes once, 12 B (count, function, weight) for each call it
    # reduces (a row's first 32), 36 B a row written
    B, M = emit.shape
    n_calls = emit.sum(dim=1)
    reduced = int(n_calls.clamp(max=BC.CAPC).sum())
    rec.update(bound(B * M + reduced * 12 + B * 36))
    n_sweep = best_call_sweep(BC, emit.device)
    def calls_a_row(e):          # {calls: rows}, 33 standing for 33 or more
        h = torch.bincount(e.sum(dim=1).clamp(max=BC.CAPC + 1)).tolist()
        return {c: r for c, r in enumerate(h) if r}

    rec["rows_by_calls"] = dict(query=calls_a_row(emit),
                                deep=calls_a_row(deep[0]))
    line = {k: {m: (round(v, 6) if isinstance(v, float)
                    else [round(x, 2) for x in v]) for m, v in times(k).items()}
            for k in versions}
    log(f"best_call: B={B} W+1={M}, {int(n_calls.sum())} calls, "
        f"{int((n_calls > BC.CAPC).sum())} rows past the cap, deep batch "
        f"{int(deep[0].sum())} calls; rows by calls "
        f"{json.dumps(rec['rows_by_calls'])}; in turns, L2 flushed (ms = as called, "
        f"launch_ms and deep_launch_ms by launch alone; warm_ms back to back "
        f"in a CUDA graph; host_us the wrapper's host time a call): "
        f"{json.dumps(line)}; launch floor {rec['floor_ms']:.6f} ms (warm "
        f"{rec['floor_warm_ms']:.6f}), plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.5f} ms, max_abs_err {errs}; host us of the "
        f"wrapper's parts "
        f"{json.dumps({k: round(v, 2) for k, v in rec['host_parts_us'].items()})}"
        f"; {n_sweep} sweep cases (B x W+1 x sparse/dense, column slices, "
        f"rows of 0-63 calls) equal")
    return dict(name="best_call", route="cuda",
                source="close_kmers_tpu_torch/csrc/best_call.cu",
                replaces="close_kmers_tpu/core/device_score.py:223", **rec,
                library_call=None, library_ms=None)


def host_profile(fn) -> dict:
    """Where one call of ``fn`` spends its time: its wall seconds with
    the garbage collector on (the collections it ran by generation, with
    their seconds) and off; the card's busy ms under torch.profiler
    (:func:`device_share`); the six functions of most own time under
    cProfile."""
    import cProfile
    import gc
    import pstats
    import torch
    runs = {g: [0, 0.0] for g in range(3)}
    t = [0.0]

    def cb(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            runs[info["generation"]][0] += 1
            runs[info["generation"]][1] += time.perf_counter() - t[0]

    torch.cuda.synchronize()
    gc.callbacks.append(cb)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.callbacks.remove(cb)
    gc.disable()
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
    finally:
        gc.enable()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]
    return dict(wall_s=wall, gc={g: dict(n=n, s=s) for g, (n, s) in
                                 runs.items()},
                wall_gc_off_s=wall_off,
                device=device_share(fn),
                top=[(f"{os.path.basename(k[0])}:{k[1]} {k[2]}", v[2])
                     for k, v in top])


def phase_best_calls(T, ds, db, chunks, slim_natives, params, label, card):
    """Phase 4: every query through DeviceScorer.best_calls_batch, each
    row's BestCall equal to the one from the slim pack and
    native.best_call_batch; the rates of the two paths from this call,
    interleaved, each from the upload on: to arrays (the device pack
    copied home / ``slim_natives``: the slim pack unpacked and reduced by
    native best-call, one result per chunk) and to BestCall objects
    (best_calls_batch / the slim path plus finish_best_call a row).
    Returns the rates and best_call's launches a pass."""
    import torch
    from close_kmers_tpu_torch.ops.best_call import best_call
    fo = db.function_of

    def slim_objects():
        return [T.finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s], fo)
                for nf, ofi, ocnt, owt in slim_natives()
                for s in range(len(nf))]

    def device_arrays():
        return [ds.best_batch_packed(o, n, params).cpu().numpy()
                for o, n in chunks]

    def device_objects():
        return [b for o, n in chunks
                for b in ds.best_calls_batch(o, n, fo, params)]

    want = slim_objects()
    before = best_call.launches
    packs = device_arrays()                                  # warm-up
    per_pass = best_call.launches - before
    got = device_objects()
    check(len(got) == len(want) and all(
        vars(g) == vars(w) for g, w in zip(got, want)),
        f"best_calls_batch differs from the native best-call on the {label} "
        f"cell")
    passes = {"slim_arrays": slim_natives, "device_arrays": device_arrays,
              "slim_objects": slim_objects, "device_objects": device_objects}
    spent = {k: [] for k in passes}
    for _ in range(3):
        for name, fn in passes.items():
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            spent[name].append(time.time() - t0)
    n_query = len(want)
    n_ovf = int(sum(int(p[:, 8].sum()) for p in packs))
    named = sum(1 for w in want if w.function)
    rates = {k: n_query / sorted(v)[1] for k, v in spent.items()}
    prof = {k: host_profile(passes[k])
            for k in ("device_objects", "slim_objects")}
    log(f"phase 4 {label}: DeviceScorer.best_calls_batch: {n_query} "
        f"BestCalls equal the slim pack + native.best_call_batch ({named} "
        f"named, {n_ovf} rows past the device cap, {per_pass} best_call "
        f"launches a pass); proteins/s (median of 3, interleaved, upload "
        f"included) to arrays: device pack {rates['device_arrays']:.0f}, "
        f"slim pack + native best-call {rates['slim_arrays']:.0f}; to "
        f"BestCalls: best_calls_batch {rates['device_objects']:.0f}, slim "
        f"pack + native + finish_best_call {rates['slim_objects']:.0f}; "
        f"{card}")
    for k, p in prof.items():
        log(f"phase 4 {label}: one {k} pass: wall {p['wall_s']:.4f} s, "
            f"{p['wall_gc_off_s']:.4f} s with the garbage collector off; "
            f"collections by generation {json.dumps(p['gc'])}; card busy "
            f"{p['device']['busy_ms']} ms of {p['device']['wall_ms']:.1f} ms "
            f"profiled; cProfile's top own times (s) {json.dumps(p['top'])}")
    rates["launches"] = per_pass
    return rates


def overflow_batch(offsets, lengths, rng):
    """Rows of the query cell's DB with many calls: row r joins 2 + r % 47
    fragments of 12 residues (five hit windows each) of distinct query
    proteins, an invalid residue apart, so rows past 32 calls trip the
    device cap.  Returns (offsets, lengths)."""
    n_rows, frag = 128, 12
    width = -(-(48 * (frag + 1) + 9) // 8) * 8
    out = np.full((n_rows, width), 20, dtype=np.uint8)
    lens = np.zeros(n_rows, dtype=np.int32)
    for r in range(n_rows):
        src = rng.choice(len(offsets), size=2 + r % 47, replace=False)
        parts = []
        for q in src:
            a = int(rng.integers(0, int(lengths[q]) - frag))
            parts.append(np.append(offsets[q, a:a + frag], 20))
        row = np.concatenate(parts)
        out[r, :len(row)] = row
        lens[r] = len(row)
    return out, lens


def phase_overflow(host, T, ds, db, offsets, lengths, params) -> int:
    """Phase 4: a batch built to pass the device call-stream cap through
    best_calls_batch: the flagged rows take the compact-call fallback and
    every row equals the native reference (searchsorted hits,
    native.score_batch, native.best_call_batch).  Returns the rows past
    the cap."""
    o_off, o_len = overflow_batch(offsets, lengths, np.random.default_rng(8))
    pack = ds.best_batch_packed(o_off, o_len, params).cpu().numpy()
    got = ds.best_calls_batch(o_off, o_len, db.function_of, params)
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(host, T, db, o_off, o_len,
                                                   params, max_calls=128)
    check(np.array_equal(pack[:, 8], (n_ref > 32).astype(np.int32)),
          "the device cap flags differ from the reference call counts")
    n_over = int(pack[:, 8].sum())
    check(n_over > 20, f"only {n_over} rows passed the device cap")
    nf, ofi, ocnt, owt = host.native.best_call_batch(n_ref, cs, ce, cc, cf, cw)
    want = [T.finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                               db.function_of) for s in range(len(nf))]
    check(all(vars(g) == vars(w) for g, w in zip(got, want))
          and len(got) == len(want),
          "best_calls_batch differs from the native reference on the "
          "overflow batch")
    log(f"phase 4: overflow batch: {len(got)} rows of 2-48 fragments "
        f"({int(n_ref.max())} calls at most), {n_over} past the device cap "
        f"took the fallback; every BestCall equals the native reference")
    return n_over


def _results_key(results):
    """TpuEngine.process_batch's (calls, hits, otu) as comparable values
    (weights by their f32 bits)."""
    def bits(w):
        return int(np.float32(w).view(np.int32))
    return [([(c.start, c.end, c.count, c.fI, bits(c.weighted))
              for c in calls],
             [dict(vars(h), wt=bits(h.wt)) for h in hits], vars(otu))
            for calls, hits, otu in results]


def phase_tpu_engine(host, T, TFam, db, dbf, mapping, offsets, lengths,
                     params, device) -> None:
    """Phase 4: TpuEngine.process_batch on a 256-protein sample of the
    query cell, and annotate_best_match on the same sample against the
    family cell's mapping (whose DB is the query cell's, its functions
    renamed), each on the card equal to the same call on a CPU engine."""
    import copy
    n = 256
    alpha = np.frombuffer(host.encoder.PROT_ALPHA.encode(), np.uint8)
    items = [(f"q{i}", alpha[offsets[i, :lengths[i]]].tobytes().decode())
             for i in range(n)]
    t0 = time.time()
    gpu, cpu = T.TpuEngine(db, device), T.TpuEngine(db, "cpu")
    t_build = time.time() - t0
    t0 = time.time()
    got = gpu.process_batch(items, params, want_hits=True)
    t_gpu = time.time() - t0
    want = cpu.process_batch(items, params, want_hits=True)
    check(_results_key(got) == _results_key(want),
          "TpuEngine.process_batch on the card differs from the CPU engine")
    n_calls = sum(len(c) for c, _, _ in got)
    check(n_calls >= n, f"only {n_calls} calls in the TpuEngine sample")
    # the family cell's mapping with its CSR as the NR preload's bulk
    # table, which families_of_kmer reads
    fam_map = copy.copy(mapping)
    fam_map._bulk_fam = mapping.fam_csr()
    got_m = TFam.annotate_best_match(gpu, items, fam_map, dbf.function_of,
                                     params)
    want_m = TFam.annotate_best_match(cpu, items, fam_map, dbf.function_of,
                                      params)
    placed = sum(1 for _, m in got_m if m.gfam_id)
    check(got_m == want_m and placed > n // 2,
          f"annotate_best_match on the card differs from the CPU engine "
          f"({placed} placed)")
    log(f"phase 4: TpuEngine: {n} proteins, {n_calls} calls and "
        f"annotate_best_match ({placed} placed) equal the CPU engine's; "
        f"engines built in {t_build:.1f} s, process_batch on the card "
        f"{t_gpu:.2f} s")


# build_db corpus: each function's protein in every genome, point-mutated
BUILD_GENOMES = 20
BUILD_FUNCS = 1000
BUILD_PROT_LEN = 100
BUILD_MUTATION = 0.01


def synth_annotated(rng, root: str) -> list[str]:
    """An annotated protein corpus of BUILD_GENOMES genome files with one
    protein of each of BUILD_FUNCS functions in every genome, each residue
    mutated at rate BUILD_MUTATION, so a function recurs across genomes
    (past --min-reps-required 5) with mutant kmers of its own; ~1% of the
    proteins are annotated "hypothetical protein" instead (recall then
    renames them, in New/).  Returns the file paths."""
    alpha = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    base = rng.integers(0, 20, size=(BUILD_FUNCS, BUILD_PROT_LEN))
    paths = []
    for g in range(BUILD_GENOMES):
        prots = base.copy()
        mut = rng.random(prots.shape) < BUILD_MUTATION
        prots[mut] = rng.integers(0, 20, size=int(mut.sum()))
        text = "".join(
            f">fig|{1000 + g}.1.peg.{f + 1} "
            f"{'hypothetical protein' if (f + g) % 97 == 0 else f'function {f % 700}'}"
            f"\n{alpha[prots[f]].tobytes().decode()}\n"
            for f in range(BUILD_FUNCS))
        path = os.path.join(root, f"genome{g:02d}.fa")
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    return paths


def _tree(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


def phase_build_db() -> int:
    """Phase 4: build_signature_kmers (the port's cli/build_db.main) with
    recall and validation through a KmerEngine on the card, and the same
    CLI with --device cpu, each in a process of its own, at the same time
    (run_validation writes to the stdout its module saw at import); every
    Calls/ and New/ file, the data dir and the validation lines must be
    byte-identical.  Returns the kept-kmer count."""
    import re
    import shutil
    import subprocess
    work = os.path.join(REPO, ".build", "chip_smoke_build_db")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "fasta"))
    procs = []
    try:
        paths = synth_annotated(np.random.default_rng(6),
                                os.path.join(work, "fasta"))
        vdir = os.path.join(work, "valid")
        os.makedirs(os.path.join(vdir, "anno"))
        os.makedirs(os.path.join(vdir, "seq"))
        for i, path in enumerate(paths[:2]):
            shutil.copy(path, os.path.join(vdir, "seq", f"genome{i}.fa"))
            with open(path) as f:
                heads = [ln[1:].rstrip("\n").split(" ", 1) for ln in f
                         if ln[0] == ">"]
            with open(os.path.join(vdir, "anno", f"genome{i}"), "w") as f:
                # the second genome's truth names every fifth one wrongly
                f.write("".join(
                    f"{pid}\t{'other' if i and k % 5 == 0 else fn}\n"
                    for k, (pid, fn) in enumerate(heads)))

        def argv(device):
            out = os.path.join(work, device)
            return ([os.path.join(out, "data")]
                    + [f"--fasta={p}" for p in paths]
                    + ["--min-reps-required", "5",
                       f"--recall-output={os.path.join(out, 'recall')}",
                       f"--validation-folder={vdir}", "--validation-verbose",
                       "--device", device])

        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from close_kmers_tpu_torch.cli.build_db import main; "
                "sys.exit(main(sys.argv[2:]))")
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, "-c", code, REPO,
                                   *argv(dev)], cwd=REPO, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE)
                 for dev in ("cuda", "cpu")]
        outs, spent = [], []
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
            spent.append(time.time() - t0)
        (gpu_out, gpu_err), (cpu_out, cpu_err) = outs
        check(all(proc.returncode == 0 for proc in procs),
              f"build_db failed: {gpu_err[-400:]} {cpu_err[-400:]}")
        kept = int(re.search(r"Kept (\d+) kmers", gpu_err).group(1))
        check(gpu_out == cpu_out and "count=" in cpu_out,
              "build_db's validation lines differ between cuda and cpu")
        trees = [_tree(os.path.join(work, d)) for d in ("cuda", "cpu")]
        n_calls = sum(k.startswith("recall/Calls/") for k in trees[0])
        check(trees[0] == trees[1] and n_calls == BUILD_GENOMES,
              "build_db's files (data dir, Calls/, New/) differ between "
              "cuda and cpu")
        n_new = sum(len(v.splitlines()) for k, v in trees[0].items()
                    if k.startswith("recall/New/"))
        log(f"phase 4: build_db: {BUILD_GENOMES * BUILD_FUNCS} proteins in "
            f"{BUILD_GENOMES} genome files, {kept} kmers kept; recall "
            f"({n_calls} Calls/ files, {n_new} New/ lines) and validation "
            f"({gpu_out.count('incorrect' + chr(9))} incorrect lines)"
            f" byte-identical between --device cuda ({spent[0]:.1f} s) and "
            f"--device cpu ({spent[1]:.1f} s, concurrent)")
        return kept
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


# -- the sharded serving step (parallel/sharding.py) on one card

# the mesh shapes of the sharded phase, each over four entries on card 0
SHARD_MESHES = ((1, 4), (2, 2))
# families a protein's rollup row holds: up to 11 on the first 4,096
# query proteins, past serve_step_sharded's default of 8
SHARD_CAP = 32
SHARD_KERNELS = ("probe_select", "scan_score", "row_gather", "family_group",
                 "best_call")
DEEP_SHARD_CHUNKS = 4


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


class _Counted:
    """Calls a function and adds the launches it made of each kernel of
    ``wrappers`` to ``n``: the sharded calls' own launches, apart from
    those of the single-card references beside them."""

    def __init__(self, wrappers: dict):
        self.w = wrappers
        self.n = dict.fromkeys(wrappers, 0)

    def __call__(self, fn, *a, **kw):
        before = {k: f.launches for k, f in self.w.items()}
        out = fn(*a, **kw)
        for k, f in self.w.items():
            self.n[k] += f.launches - before[k]
        return out


def stage_profile(fn, patches: dict) -> dict:
    """One call of ``fn`` under torch.profiler with each ``patches``
    entry ({stage: (owner, attribute)}) wrapped in a record_function
    range of its name.  Returns the wall ms, the card's busy ms (its
    kernels and copies), each stage's share of it (the kernels and
    copies that ran inside the stage's ranges) and the rest ("other"),
    the count of host-side ops recorded and the eight device names of
    most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for name, (owner, attr) in patches.items():
        orig = getattr(owner, attr)

        def wrap(*a, _orig=orig, _name=name, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        # a kernel wrapper counts its launches on the module's name, now
        # this range: they go back to its own count after the pass
        wrap.launches = 0
        setattr(owner, attr, wrap)
        saved.append((owner, attr, orig, wrap))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
    finally:
        for owner, attr, orig, wrap in saved:
            setattr(owner, attr, orig)
            if hasattr(orig, "launches"):
                orig.launches += wrap.launches
    # the device timeline holds each range as an annotation span (named
    # after the stage) beside the kernels and copies; each kernel counts
    # for the stage whose span holds its start, else for "other"
    import bisect
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            r = (e.time_range.start, e.time_range.end, e.name)
            (spans if e.name in patches else kernels).append(r)
    spans.sort()
    starts = [a for a, _, _ in spans]
    stages = dict.fromkeys(list(patches) + ["other"], 0.0)
    by_name: dict[str, float] = {}
    for a, b, name in kernels:
        i = bisect.bisect_right(starts, a) - 1
        stage = spans[i][2] if i >= 0 and a < spans[i][1] else "other"
        stages[stage] += (b - a) / 1e3
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    n_cpu_ops = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU)
    return dict(wall_ms=wall, busy_ms=busy, stages_ms=stages,
                cpu_ops=n_cpu_ops,
                top=[(name[:60], round(ms, 3)) for name, ms in top])


def _stage_patches() -> dict:
    from close_kmers_tpu_torch.core import device_family as DF
    from close_kmers_tpu_torch.core import device_score as DS
    from close_kmers_tpu_torch.ops import best_call as BC
    from close_kmers_tpu_torch.parallel import sharding as SH
    return {"encode": (SH, "encode_windows"),
            "route (owner map, sort, send buffers)": (SH, "_route_send"),
            "probe": (SH, "_probe_local_windows"),
            "family rows (row_gather)": (DF, "_gather_fams"),
            "exchange all_to_all": (SH.Mesh, "all_to_all"),
            "exchange all_gather": (SH.Mesh, "all_gather"),
            "exchange psum": (SH.Mesh, "psum"),
            "home (outputs to the caller)": (SH.Mesh, "home"),
            "scan": (DS, "_scan_score"),
            "best_call": (BC, "best_call"),
            "rollup": (DF, "rollup_from_fams")}


def phase_sharded(TF, ds, eng, dfs, dbf, offsets, lengths, params, ds_deep,
                  db_deep, d_off, d_len, wrappers, card) -> dict:
    """Phase 4, sharded: the query corpus and its family universe
    range-sharded over four entries on card 0, meshes (1, 4) and (2, 2),
    routed and replicated: serve_step_sharded on all 65,536 proteins with
    family rows (best pack equal to DeviceScorer.best_batch_packed, rollup
    rows parsed equal to DeviceFamilyScorer.rollup), ShardedEngine.
    probe_compact equal to FastAnnotator's, probe_routed equal to
    probe_sharded at the default and at a forced-overflow capacity; the
    step's proteins/s against best_batch_packed's (interleaved), one pass
    profiled by stage, the launches of a pass; the deep DB on (1, 4)
    through each shard's sub blocks.  Returns the phase's numbers and the
    sharded calls' own launches."""
    import torch
    from close_kmers_tpu_torch.parallel import sharding as SH
    dev0 = torch.device("cuda", 0)
    count = _Counted({k: wrappers[k] for k in SHARD_KERNELS})
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, N_QUERY, BATCH)]
    fam_np = dfs.fdb.fam.cpu().numpy()
    t0 = time.time()
    want_best = [ds.best_batch_packed(o, n, params).cpu() for o, n in chunks]
    want_roll = [dfs.rollup(o, n, fams_per_seq_cap=SHARD_CAP)
                 for o, n in chunks]
    log(f"phase 4 sharded: single-card references (best packs, rollups) "
        f"for {N_QUERY} proteins in {time.time() - t0:.1f} s")
    out = dict(rates={}, profiles={}, per_pass={})

    def single_pass():
        return [ds.best_batch_packed(o, n, params).cpu().numpy()
                for o, n in chunks]

    for shape in SHARD_MESHES:
        mesh = SH.make_mesh(*shape, devices=[dev0] * 4)
        t0 = time.time()
        se = SH.ShardedEngine(dbf, mesh)
        sdb = se.sdb
        fam_sh = SH.shard_fam_table(fam_np, sdb)
        torch.cuda.synchronize()
        check(sdb.payload_wide is not None,
              f"the {shape} shards did not take payload-wide rows")
        log(f"phase 4 sharded {shape}: {sdb.n_shards} shards of <= {sdb.m:,}"
            f" rows, payload-wide {sdb.payload_wide.shape}, family rows "
            f"{fam_sh.shape}, built and placed in {time.time() - t0:.1f} s")
        for routed in (True, False):
            mode = "routed" if routed else "replicated"
            n_ovf = 0
            for i, (o, n) in enumerate(chunks):
                best, ovf, drop, rows = count(
                    SH.serve_step_sharded, sdb, o, n, params=params,
                    fam_shards=fam_sh, cap_seq=SHARD_CAP, routed=routed)
                check(torch.equal(best.cpu(), want_best[i]),
                      f"sharded {shape} {mode} best pack differs from "
                      f"best_batch_packed at chunk {i}")
                got = TF.DeviceFamilyScorer.finish_rollup_rows(
                    rows.cpu().numpy(), SHARD_CAP)
                check(got is not None, f"sharded {shape} {mode} rollup "
                      f"overflowed {SHARD_CAP} families a row at chunk {i}")
                check(all(
                    np.array_equal(_bits(a), _bits(b))
                    for a, b in zip(got, want_roll[i])),
                    f"sharded {shape} {mode} rollup differs from "
                    f"DeviceFamilyScorer.rollup at chunk {i}")
                check(int(drop.sum()) == 0,
                      f"sharded {shape} {mode} dropped windows")
                n_ovf += int(ovf.sum())
            se.routed = routed
            for i, (o, n) in enumerate(chunks[:2]):
                hg = count(se.probe_compact, o, n)
                hw = eng.fa.probe_compact(o, n)
                check(all(np.array_equal(_bits(hg[k]), _bits(hw[k]))
                          for k in hw),
                      f"ShardedEngine {shape} {mode} probe_compact differs "
                      f"from FastAnnotator's at chunk {i}")
            log(f"phase 4 sharded {shape} {mode}: all {N_QUERY} proteins' "
                f"best packs equal best_batch_packed, rollups equal "
                f"DeviceFamilyScorer.rollup, probe_compact equal on "
                f"{2 * BATCH}; {n_ovf} windows took the overflow fallback")
        o, n = chunks[0]
        rep = count(SH.probe_sharded, sdb, o, n)
        for kw in ({}, dict(capacity_factor=0.5, ov_frac=1.0)):
            rt = count(SH.probe_routed, sdb, o, n, **kw)
            check(all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                                  else a, b.view(torch.int32)
                                  if b.is_floating_point() else b)
                      for a, b in zip(rep[:5], rt[:5])),
                  f"probe_routed {kw} differs from probe_sharded on {shape}")
            check(int(rt[8].sum()) == 0, f"probe_routed {kw} dropped")
            if kw:
                check(int(rt[7].sum()) > 0,
                      "the forced capacity took no overflow fallback")
                log(f"phase 4 sharded {shape}: probe_routed at capacity "
                    f"factor 0.5 ({int(rt[7].sum())} windows through the "
                    f"fallback) and at the default equal probe_sharded")

        def sharded_pass(routed, fams):
            def run():
                return [SH.serve_step_sharded(
                    sdb, o, n, params=params,
                    fam_shards=fam_sh if fams else None,
                    cap_seq=SHARD_CAP, routed=routed)[0].cpu().numpy()
                    for o, n in chunks]
            return run

        passes = {"best_batch_packed": single_pass,
                  "sharded routed": sharded_pass(True, False),
                  "sharded replicated": sharded_pass(False, False)}
        spent = {k: [] for k in passes}
        for fn in passes.values():
            fn()                                            # warm-up
        for _ in range(3):
            for name, fn in passes.items():
                torch.cuda.synchronize()
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                spent[name].append(time.time() - t0)
        rates = {k: N_QUERY / sorted(v)[1] for k, v in spent.items()}
        out["rates"][shape] = rates
        log(f"phase 4 sharded {shape}: proteins/s (median of 3, "
            f"interleaved, upload to the [B, 9] pack home, no family "
            f"rows) {json.dumps({k: round(v) for k, v in rates.items()})};"
            f" passes (s) {json.dumps(spent)}; {card}")
        for routed in (True, False):
            mode = "routed" if routed else "replicated"
            before = {k: wrappers[k].launches for k in SHARD_KERNELS}
            sharded_pass(routed, True)()
            out["per_pass"][(shape, mode)] = {
                k: wrappers[k].launches - before[k] for k in SHARD_KERNELS}
            prof = stage_profile(sharded_pass(routed, True),
                                 _stage_patches())
            out["profiles"][(shape, mode)] = prof
            log(f"phase 4 sharded {shape} {mode}: one pass with family "
                f"rows profiled: wall {prof['wall_ms']:.1f} ms, card busy "
                f"{prof['busy_ms']:.2f} ms, by stage (device ms) "
                f"{json.dumps({k: round(v, 3) for k, v in prof['stages_ms'].items()})}; "
                f"{prof['cpu_ops']} host-side ops recorded; top device "
                f"names {json.dumps(prof['top'])}; "
                f"launches a pass {json.dumps(out['per_pass'][(shape, mode)])}")
        del se, sdb, fam_sh
        torch.cuda.empty_cache()

    mesh = SH.make_mesh(1, 4, devices=[dev0] * 4)
    t0 = time.time()
    sdb = SH.ShardedDB.from_db(db_deep, mesh)
    torch.cuda.synchronize()
    check(sdb.sub_blocks is not None and sdb.payload_wide is None,
          "the deep DB's shards did not take sub blocks")
    log(f"phase 4 sharded deep (1, 4): sub blocks {sdb.sub_blocks.shape} "
        f"(sub_w {sdb.sub_w}), header {sdb.sub_header.shape}, built and "
        f"placed in {time.time() - t0:.1f} s")
    before = wrappers["probe_select"].launches
    for routed in (True, False):
        for a in range(0, DEEP_SHARD_CHUNKS * BATCH, BATCH):
            o = np.ascontiguousarray(d_off[a:a + BATCH])
            n = np.ascontiguousarray(d_len[a:a + BATCH])
            # the spelled queries' windows mostly fall in the last shard
            # (random residues), past any uniform capacity: the drop-free
            # one, and the default's drops counted
            best, _, drop = count(SH.serve_step_sharded, sdb, o, n,
                                  params=params, routed=routed,
                                  capacity_factor=None)
            want = ds_deep.best_batch_packed(o, n, params).cpu()
            check(torch.equal(best.cpu(), want) and int(want[:, 0].sum())
                  and int(drop.sum()) == 0,
                  f"deep sharded best pack differs at chunk {a // BATCH}")
    o = np.ascontiguousarray(d_off[:BATCH])
    n = np.ascontiguousarray(d_len[:BATCH])
    out["deep_default_drops"] = int(count(
        SH.probe_routed, sdb, o, n)[8].sum())
    out["deep_probe_launches"] = wrappers["probe_select"].launches - before
    log(f"phase 4 sharded deep (1, 4): {DEEP_SHARD_CHUNKS * BATCH} spelled "
        f"proteins routed (drop-free capacity) and replicated equal "
        f"best_batch_packed on the single-card sub_blocks table; at the "
        f"default capacity one batch drops {out['deep_default_drops']} "
        f"windows (the skew the ShardedEngine ladder re-dispatches)")
    del sdb
    torch.cuda.empty_cache()
    out["nccl"] = phase_nccl(SH, dbf, chunks, want_best, params, count)
    out["launches"] = count.n
    return out


def phase_nccl(SH, dbf, chunks, want_best, params, count) -> str:
    """Phase 4, sharded: a one-rank NCCL process group (multihost.
    initialize at a free localhost port, pod_mesh (1, 1)) runs the routed
    and replicated serving steps on the query DB; the best packs equal
    best_batch_packed's.  Returns the group's backend."""
    import torch
    import torch.distributed as dist
    from close_kmers_tpu_torch.parallel import multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    check(multihost.initialize("cuda:0", f"127.0.0.1:{port}", 1, 0),
          "multihost.initialize brought up no group")
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"the card's group runs {backend}")
        mesh = multihost.pod_mesh("cuda:0", 1, 1)
        t0 = time.time()
        sdb = SH.ShardedDB.from_db(dbf, mesh)
        for routed in (True, False):
            for i, (o, n) in enumerate(chunks[:2]):
                best = count(SH.serve_step_sharded, sdb, o, n, params=params,
                             routed=routed)[0]
                check(torch.equal(best.cpu(), want_best[i]),
                      f"the NCCL group's {'routed' if routed else 'replicated'}"
                      f" best pack differs at chunk {i}")
        torch.cuda.synchronize()
        log(f"phase 4 sharded: one-rank {backend} group, mesh {mesh.shape}: "
            f"routed and replicated steps on {2 * BATCH} proteins equal "
            f"best_batch_packed ({time.time() - t0:.1f} s with the table "
            f"build)")
        del sdb
    finally:
        dist.destroy_process_group()
    return backend


def phase_sharded_golden() -> None:
    """Phase 4, sharded: the golden conversations through kser contexts
    whose engine probes the DB over four table shards on card 0: every
    conversation replicated, /lookup and /query best calls routed."""
    from close_kmers_tpu_torch.cli.kser import load_server_context
    from close_kmers_tpu_torch.parallel.sharding import ShardedEngine
    data = os.path.join(GOLDEN, "data")
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    servers = []
    try:
        for routed, names in ((False, list(GOLDEN_CONVS)),
                              (True, ["lookup", "query_best"])):
            srv = _Server(load_server_context(
                data, batch_size=64, n_shards=4, routed=routed,
                device="cuda:0"))
            servers.append(srv)
            fa = srv.ctx.engine.fa
            check(isinstance(fa, ShardedEngine) and fa.routed == routed
                  and fa.mesh.shape == {"data": 1, "table": 4},
                  "the sharded context did not build a sharded engine")
            for name in names:
                with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
                    want = f.read()
                reqs = GOLDEN_CONVS[name](body)
                got = b"".join(_http(srv.port, r) for r in (
                    [reqs] if isinstance(reqs, bytes) else reqs))
                check(got == want, f"sharded golden conversation {name} "
                      f"({'routed' if routed else 'replicated'}) differs")
            log(f"phase 4 sharded: golden {', '.join(names)} byte-identical "
                f"through a 4-shard {'routed' if routed else 'replicated'} "
                f"kser context on the card")
    finally:
        for srv in servers:
            srv.close()


def main(argv: list[str]) -> int:
    """``argv``: optional ``--compare LABEL=DIR`` pairs, each a tree (e.g.
    the parent commit unpacked by ``git archive``) whose best_call kernel
    and wrapper phase 2 times in turns with this tree's."""
    if len(argv) % 2 or any(f != "--compare" or "=" not in v
                            for f, v in zip(argv[::2], argv[1::2])):
        print("usage: chip_smoke.py [--compare LABEL=DIR ...]",
              file=sys.stderr)
        return 2
    trees = dict(v.split("=", 1) for v in argv[1::2])
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from close_kmers_tpu_torch import params as P
        from close_kmers_tpu_torch.db import family_db, signature_db
        from close_kmers_tpu_torch.native import api as native
        from close_kmers_tpu_torch.ops import encoder, translate
        from close_kmers_tpu_torch.core import device_family as TF
        from close_kmers_tpu_torch.core import engine as T
        from close_kmers_tpu_torch.core import genome as TG
        from close_kmers_tpu_torch.core import matrix as TM
        from close_kmers_tpu_torch.ops import scan_score as S
        from close_kmers_tpu_torch.core.api import KmerEngine
        from close_kmers_tpu_torch.core.device_score import DeviceScorer
        from close_kmers_tpu_torch.core import family as TFam
        from close_kmers_tpu_torch.ops import _build
        from close_kmers_tpu_torch.ops.best_call import best_call
        from close_kmers_tpu_torch.ops import gather_exp as gx
        from close_kmers_tpu_torch.ops.family_group import family_group
        from close_kmers_tpu_torch.ops.probe_select import (famwide_select,
                                                            probe_select)
        from close_kmers_tpu_torch.ops.row_gather import row_gather
        from close_kmers_tpu_torch.ops.scan_score import scan_score
        from close_kmers_tpu_torch.scripts import gather_exp as GX
        from close_kmers_tpu_torch.utils.device import (
            gpu_name_and_power_limit, resolve_device)
    except ImportError as e:
        print(f"the port is not importable next to this script: {e}",
              file=sys.stderr)
        return 1
    check(sys.modules.get("jax") is None, "jax was imported")
    check(not any(m.split(".")[0] == "close_kmers_tpu" for m in sys.modules),
          "the JAX package was imported")
    # the port's host-side modules, in one namespace for the phases below
    host = types.SimpleNamespace(
        EngineParams=P.EngineParams, SignatureDB=signature_db.SignatureDB,
        encoder=encoder, family_db=family_db, native=native, params=P,
        translate=translate)
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = gpu_name_and_power_limit()
    t_start = time.time()
    wrappers = {"probe_select": probe_select, "scan_score": scan_score,
                "row_gather": row_gather, "famwide_select": famwide_select,
                "family_group": family_group, "dma_gather": gx.dma_gather,
                "vgather": gx.vgather, "hbmstream": gx.hbmstream,
                "dmaflush": gx.dmaflush, "best_call": best_call}

    # -- phase 1: device and build
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")
    t0 = time.time()
    _build.build(force=True, verbose=True)
    log(f"phase 1: nvcc built {_build.LIB} in {time.time() - t0:.1f} s")

    # -- set-up: the real-size DBs, family universe and queries (host)
    t0 = time.time()
    db, offsets, lengths, src_rng = build_corpus(host)
    dbf, mapping = make_family_universe(host, db, src_rng)
    log(f"set-up: corpus + DB of {len(db):,} kmers (max bucket "
        f"{db.max_bucket}) and {len(mapping.families):,} families built "
        f"on the host in {time.time() - t0:.1f} s")
    params = host.EngineParams()
    t0 = time.time()
    ds = DeviceScorer(db, device)
    eng = KmerEngine(dbf, device)
    torch.cuda.synchronize()
    log(f"set-up: two payload-wide tables {tuple(ds.ddb.payload_wide.shape)} "
        f"built and uploaded in {time.time() - t0:.1f} s")
    t0 = time.time()
    dfs = eng._device_family_scorer(mapping)
    torch.cuda.synchronize()
    check(dfs is not None and dfs.famwide is not None,
          "no famwide family scorer for the full-width corpus")
    log(f"set-up: family table {tuple(dfs.fdb.fam.shape)} and famwide rows "
        f"{tuple(dfs.famwide.shape)} (W={dfs.fam_w}, D={dfs.fam_d}) built "
        f"and uploaded in {time.time() - t0:.1f} s")
    t0 = time.time()
    db_deep = GX.deep_db()
    t1 = time.time()
    d_off, d_len = spelled_queries(db_deep, N_QUERY, np.random.default_rng(5))
    log(f"set-up: deep DB of {len(db_deep):,} keys over "
        f"{GX.EXP_DEEP_SPAN:,} hi buckets (max bucket {db_deep.max_bucket}) "
        f"in {t1 - t0:.1f} s and {N_QUERY} spelled queries in "
        f"{time.time() - t1:.1f} s, built on the host")
    t0 = time.time()
    ds_deep = DeviceScorer(db_deep, device)
    eng_deep = KmerEngine(db_deep, device)
    torch.cuda.synchronize()
    check(ds_deep.ddb.tier == eng_deep.fa.ddb.tier == "sub_blocks",
          f"the deep DB took the {ds_deep.ddb.tier} tier, not sub_blocks")
    log(f"set-up: two sub_blocks tables (header "
        f"{tuple(ds_deep.ddb.sub_header.shape)}, blocks "
        f"{tuple(ds_deep.ddb.sub_blocks.shape)}, sub_w {ds_deep.ddb.sub_w}) "
        f"built and uploaded in {time.time() - t0:.1f} s")
    t0 = time.time()
    genome = synth_genome(np.random.default_rng(4), offsets[:, :PROT_LEN],
                          GENOME_BASES)
    g_digits, g_n = TG.bucketed_digits(genome)
    log(f"set-up: genome of {len(genome):,} bp (scripts/dna_bench.py "
        f"synth_genome, seed 4) in {time.time() - t0:.1f} s")

    # -- phase 2: kernels against their plain versions, tiers against the
    # payload-wide probe
    off_d = torch.from_numpy(offsets[:BATCH]).to(device)
    len_d = torch.from_numpy(lengths[:BATCH]).to(device)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    d_off_b = torch.from_numpy(d_off[:BATCH]).to(device)
    d_len_b = torch.from_numpy(d_len[:BATCH]).to(device)
    compare = {k: best_call_tree(v, k) for k, v in trees.items()}
    kernels = phase_kernels(
        T, ds.ddb, off_d, len_d, params, flush,
        scan_calls(T, S, ds_deep.ddb, d_off_b, d_len_b, params), compare)
    reads, n_orfs, fq_chunk = make_reads(host, eng, offsets)
    kernels.update(phase_family_kernels(T, TF, dfs, off_d, len_d, fq_chunk,
                                        flush))
    kernels["probe_select"]["sub_blocks"] = phase_sub_select(
        T, ds_deep.ddb, d_off_b, d_len_b, flush)
    kernels["probe_select"]["genome"], kernels["scan_score"]["genome"] = \
        phase_genome_kernels(T, TG, S, eng.fa.ddb,
                             torch.from_numpy(g_digits).to(device), g_n,
                             params, flush)
    m_hi, m_lo, m_valid = T.encode_windows(
        torch.from_numpy(offsets[:MATRIX_P]).to(device),
        torch.from_numpy(lengths[:MATRIX_P]).to(device))
    kernels["probe_select"]["matrix"] = time_probe(
        (m_hi.reshape(-1), m_lo.reshape(-1), m_valid.reshape(-1)),
        eng.fa.ddb.payload_wide, eng.fa.ddb.wide_w, eng.fa.ddb.n, flush,
        "one matrix chunk's windows")[1]
    del m_hi, m_lo, m_valid
    del flush
    kernels.update(phase_gather_kernels(device))
    log(f"phase 2: all {len(kernels)} kernels equal their plain versions")
    tiers = phase_tiers(T, db, ds.ddb, off_d, len_d)
    log(f"phase 2: all {len(tiers)} tier probes equal the payload-wide probe")

    # -- the main path, counted (and its peak device memory)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- phase 3: golden server on the card
    phase_golden(device)
    log("phase 3: golden conversations byte-identical on the card")

    # -- phase 4: real size
    rate_ds, rate_eng, best_q = phase_query(host, T, ds, eng, db, offsets,
                                            lengths, params, "query", card)
    n_over = phase_overflow(host, T, ds, db, offsets, lengths, params)
    phase_tpu_engine(host, T, TFam, db, dbf, mapping, offsets, lengths,
                     params, device)
    rate_fam, _spent = phase_family(TF, eng, mapping, offsets, lengths,
                                    params, device)
    rate_reads, rate_orfs = phase_reads(eng, mapping, reads, n_orfs, params)
    gen = phase_genome(host, T, TG, eng, db, genome, params)
    mat = phase_matrix(host, TM, eng, db, offsets, lengths, src_rng)
    before = probe_select.launches
    rate_deep, rate_deep_eng, best_d = phase_query(
        host, T, ds_deep, eng_deep, db_deep, d_off, d_len, params, "deep",
        card)
    sub_launches = probe_select.launches - before

    # -- the sharded serving path, its counts set to 0 just before it and
    # read just after (then added back to the main path's)
    saved = {name: fn.launches for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.launches = 0
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    shard = phase_sharded(TF, ds, eng, dfs, dbf, offsets, lengths, params,
                          ds_deep, db_deep, d_off, d_len, wrappers, card)
    phase_sharded_golden()
    shard_peak = torch.cuda.max_memory_allocated()
    shard_counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, fn in wrappers.items():
        fn.launches += saved[name]
    log(f"phase 4 sharded: {time.time() - t0:.1f} s; launches on the "
        f"sharded path: {json.dumps(shard_counts)}, of them by the sharded "
        f"calls alone {json.dumps(shard['launches'])}; probe_select on the "
        f"deep DB's shard sub blocks {shard['deep_probe_launches']}; peak "
        f"device memory {shard_peak} B ({shard_peak / 2**30:.2f} GiB); the "
        f"exchange between table shards is device-local copies on one card, "
        f"not NCCL; {card}")
    for name in SHARD_KERNELS:
        check(shard["launches"][name] > 0,
              f"{name} was never launched on the sharded path")
    check(shard["deep_probe_launches"] > 0,
          "probe_select never ran on the shards' sub blocks")
    del ds_deep, eng_deep
    torch.cuda.empty_cache()
    log(f"phase 4: gather_exp experiments ({', '.join(GX.EXPERIMENTS)})")
    exp = GX.run(GX.EXPERIMENTS, device, deep=db_deep)
    kept = phase_build_db()
    peak = max(peak_before, torch.cuda.max_memory_allocated())
    log(f"phase 4: peak device memory {peak} B ({peak / 2**30:.2f} GiB)")

    # -- phase 5: the main path went through every kernel
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"phase 5: launches on the main path: {launches}; probe_select on "
        f"the deep DB's sub_blocks path: {sub_launches}; on the genome path "
        f"(one genome) probe_select {gen['launches'][0]}, scan_score "
        f"{gen['launches'][1]}; on the matrix path (one request) "
        f"probe_select {mat['launches']}; best_call a 65,536-protein pass "
        f"{best_q['launches']} (query), {best_d['launches']} (deep)")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    check(sub_launches > 0, "probe_select never ran on the sub_blocks path")
    check(min(gen["launches"]) > 0 and mat["launches"] > 0,
          "the genome or matrix path missed a kernel")
    log(f"all phases passed in {time.time() - t_start:.1f} s; "
        f"DeviceScorer {rate_ds:.0f} proteins/s, KmerEngine {rate_eng:.0f} "
        f"proteins/s, family best-match {rate_fam:.0f} proteins/s, "
        f"/fq_lookup {rate_reads:.0f} reads/s ({rate_orfs:.0f} ORF "
        f"proteins/s), genome {gen['mbp_s']:.2f} Mbp/s ({gen['rounds']} "
        f"fixpoint rounds), matrix {mat['proteins_s']:.0f} proteins/s, "
        f"deep DB (sub_blocks) DeviceScorer {rate_deep:.0f} / "
        f"KmerEngine {rate_deep_eng:.0f} proteins/s, deep_sub "
        f"{exp['deep_sub'] * 1e3:.4f} ms / deep_bin "
        f"{exp['deep_bin'] * 1e3:.4f} ms per {GX.N_IDX} windows, tier probes "
        f"(ms, peak B) {tiers}; device best-call (query / deep) "
        f"{best_q['device_arrays']:.0f} / {best_d['device_arrays']:.0f} "
        f"proteins/s to arrays (slim pack + native "
        f"{best_q['slim_arrays']:.0f} / {best_d['slim_arrays']:.0f}), "
        f"best_calls_batch {best_q['device_objects']:.0f} / "
        f"{best_d['device_objects']:.0f} to BestCalls (slim pack + native + "
        f"finish_best_call {best_q['slim_objects']:.0f} / "
        f"{best_d['slim_objects']:.0f}), {n_over} overflow rows through the "
        f"fallback; build_db "
        f"kept {kept} kmers; sharded step proteins/s "
        f"{json.dumps({str(k): {n: round(r) for n, r in v.items()} for k, v in shard['rates'].items()})}"
        f" ({shard['nccl']} one-rank group equal); peak {peak} B on {card}")

    records = [dict(kernels[k], launches=launches[k],
                    **({"sharded_launches": shard["launches"][k]}
                       if k in SHARD_KERNELS else {})) for k in wrappers]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
