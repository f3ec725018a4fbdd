#!/usr/bin/env python3
"""Smoke run of the torch port's /query (with device best-call), family,
genome, /matrix, probe-gather, TpuEngine, sharded serving,
build_signature_kmers and PATRIC-scale paths on one NVIDIA card, and a
randomized parity fuzz of its serving kernels.

    python3 chip_smoke.py [--compare LABEL=DIR ...] [--scale-keys N]
                          [--scale-only DBS] [--sweep-cap GB] [--budgets]
                          [--fuzz-rounds N] [--gather-exp NAMES|all]

Builds the CUDA kernels from ``close_kmers_tpu_torch/csrc`` (one nvcc per
source, in parallel) and drives the port's main paths on the card, phase
by phase; any failure exits non-zero and prints no result.  It needs one
card, and exits 1 without one.

1. Device and build: the card's name and power limit (nvidia-smi), then
   ``nvcc`` builds the kernels for sm_90a (build seconds printed).
2. Kernels against their plain torch versions, exact equality, times
   from CUDA events: probe_select (on the DB's payload-wide rows, built
   by name: the auto-ladder takes the binary search) and scan_score on
   one 4096 x 300-aa batch against the real-size DB of phase 4;
   probe_search, the auto-ladder's probe, on the same batch, on the deep
   cell's batch, on the genome's tile windows and on one /matrix chunk,
   by launch warm and L2 flushed, with its bound (each window's bytes,
   its bucket pair, the distinct 32-B lo sectors its search reads and a
   hit's payload row), in turns with its first design (one thread a
   window, n_steps halvings) and any ``--compare`` tree's kernel, and on
   the query cell with its decomposition (ck_probe_search_exp: pair +
   payload alone, the first design at 128/256/512 threads a block and
   with 2-4 windows a thread, a quarter-warp k-ary design, and the first
   design on the windows sorted by hi); row_gather, famwide_select
   and family_group on the same batch against the family universe of
   phase 4 (D = 3), family_group also on the first chunk of phase 4's
   /fq_lookup ORF batch and on both sides of its route limit (W*D =
   8192 fused, 8193 sorted); probe_select again on the deep DB's sub
   blocks (built by name); and
   best_call on the query and deep batches' scan outputs (as the scan
   lays them out), also at B in {1, 33, 4097} x W+1 in BC_WIDTHS (1 to
   1,017), on column slices of wider rows and on rows of 0-63 calls
   (overflow flags past 32), timed as called and by launch alone, L2
   flushed, beside the launch floor (a one-element fill_), its bound the
   emit bytes once, 12 B a call it reduces and 36 B a row written, and
   the wrapper's host cost split into its parts; with ``--compare
   LABEL=DIR`` (e.g. the parent commit unpacked by ``git archive``) that
   tree's best_call kernel and wrapper are timed in turns with this
   one's (and its probe_search kernel wherever probe_search is timed,
   here and in the scale phase); dmaflush beside index_copy_ of its
   blocks; and
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
   kernels at its own inputs (phase 4's 5-Mbp genome): probe_search on
   its 10,143,744 tile windows, and
   scan_score on its 9,984 x 1,016 scan inputs chained (init as the
   fixpoint builds it, pos0, final_flush) with emit and state-only, each
   timed as the path calls it and by launch alone, L2 flushed, with its
   bound.
   Each kernel's record carries its bound (the
   bytes it must move over 3.35 TB/s; for vgather the longer of its
   shared-memory bytes over the SMs' bank rate and its 64-bit adds over
   their INT32 rate, both in the record) and, where one PyTorch call
   computes the same function, that call's time; the genome and matrix
   shapes sit in the records' ``genome`` and ``matrix`` fields.
   Tiers: the 20.5M-kmer DB of phase 4 built in each probe tier by
   ``DeviceDB.from_db`` flags (the six variants of
   tests/test_engine.py::test_probe_layout_parity), one table at a time;
   each tier's probe of the batch must equal the auto-ladder's probe
   (ms per batch and peak memory printed).  Tier sweeps: gather_exp's
   deep DB (~306 keys a bucket) and its keys over 16,000 and 4,000 hi
   buckets, each tier that fits the card and the host built by name,
   one at a time, timed on 4,096 spelled proteins' 1,245,184 windows,
   equal to the binary search; a tier that does not fit is printed
   with its bytes.
3. The golden server on the card: the port's kser context on
   tests/golden/data with device="cuda", and the version / query /
   query_details / query_best / lookup / lookup_best / wadd / xmatrix
   (/add then /matrix) / yfq / zfq_gz conversations over a socket, byte
   for byte against
   tests/golden/*.resp; then a second context forced onto the device
   family program (device_family_min = 0), whose four /lookup modes and
   /fq_lookup must give the first context's bytes; then a kser process
   under --torch-profile-dir on the card: the /query conversation, SIGINT,
   and its Chrome trace must hold a kernel of csrc/*.cu.
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
     proteins through KmerEngine.best_family_matches_padded on the card
     gate's path (the two gathers) and on famwide rows forced beside it,
     interleaved, the fused programs' packs equal on every chunk, and a
     4096-protein sample equal to the host path (native.family_scores
     and the scalar find_best_family_match).
   * reads: 20,000 synthetic 150-bp reads (scripts/fq_bench.py's
     synth_reads, seed 3 as bench.py) through the /fq_lookup path
     (server.http.process_reads: batch_orf_arrays,
     best_family_matches_padded(as_arrays=True), best-frame reduction);
     a 1,000-read sample equal to the host path's output.
   * deep: scripts/gather_exp.py deepcmp's DB (20M random keys over
     64,000 hi buckets, ~312 per bucket, PATRIC density), on the
     auto-ladder's tier (the binary search); 65,536 proteins spelled
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
     it runs but the scale family and gsort15m (``--gather-exp``),
     deepcmp on the deep DB (deep_sub, the sub_blocks tier, equal to
     deep_bin on 2.49M windows), probepal's kernel held to the plain
     probe_select on its rows in phase 2; then gather_scale_exp (bitmap,
     small, payload, compact and filtered gathers at N = 10M, and
     whether the bitmap prefilter pays at 8% density).
   * build_db: cli/build_db.main on 20,000 annotated proteins in 20
     genome files (each function's protein point-mutated in every
     genome), --min-reps-required 5, recall and validation with
     --device cuda, and the same CLI with --device cpu, in two processes
     at the same time: byte-identical files and lines.
   * sharded (parallel/sharding.py): the query DB and its family table
     range-sharded over four entries on card 0 (every shard on the binary
     search), meshes (1, 4) and (2, 2), routed and replicated:
     serve_step_sharded on all 65,536 proteins with family rows, each
     best pack equal to
     DeviceScorer.best_batch_packed and each rollup (parsed) to
     DeviceFamilyScorer.rollup; ShardedEngine.probe_compact equal to
     FastAnnotator's; probe_routed equal to probe_sharded at the default
     capacity and at a forced-overflow one; the step's proteins/s beside
     best_batch_packed's (interleaved, median of 3), one pass profiled by
     stage (torch.profiler ranges: encode, route, probe, family rows,
     exchange, scan, best_call, rollup), the kernels' launches a pass;
     the deep DB on (1, 4) through each shard's sub blocks (the JAX
     module's per-shard layouts, jax_layouts=True); the golden
     conversations through 4-shard kser contexts (all replicated,
     /lookup and /query best calls routed); a one-rank NCCL group
     (multihost.initialize, pod_mesh (1, 1)) whose routed and replicated
     steps equal the single-card pack.  Its launch counts are set to 0
     just before it and read just after: the five kernels of the path
     (probe_search, scan_score, row_gather, family_group, best_call) must
     each have launched in the sharded calls themselves.
   * scale (its own path: the counts set to 0 just before it and read
     just after): two DBs of --scale-keys (default
     210,000,000, make_scale_db's --target-kmers and BENCH_SCALE.json's
     208M point) made on the card by scripts/make_scale_db.scale_db
     from a seed, uniform residues and the --aa-bias skew, 2,000
     functions; each prints its keys, max bucket, max sub-bucket, the
     tier each gate set picks and every tier's table bytes; probe_search
     on 4,096 spelled proteins' 1,245,184 windows against its plain
     version and numpy searchsorted over all keys, beside
     torch.searchsorted + equality; every tier that fits timed on those
     windows (six planes equal to the binary search's; a tier left out
     printed with its bytes); 65,536 spelled proteins through
     DeviceScorer.best_batch_packed on the port's pick (from_db with no
     flags) and on the JAX gates' pick (its flags), interleaved, as
     proteins/s, the packs equal and a 4,096-protein sample's best calls
     equal to native best-call over the searchsorted reference; on the
     skewed DB probe_search's decomposition as on the query cell; then
     the family phase (scale_family): make_scale_db.scale_mapping (the
     JAX scale serve's universe, 1-3 families a key), KmerEngine(db) with
     its default gates, which must take the device family program; the
     65,536 proteins through best_family_matches_padded in rounds (on the
     uniform DB famwide rows forced beside the two gathers, interleaved,
     their packs equal on every chunk, their kernels in turns), one pass
     profiled (the card's busy share), a 4,096-protein sample equal to
     the host path, the build seconds, table bytes and peak device and
     host memory; probe_search, scan_score, best_call, row_gather and
     family_group must each launch on this path.  Then
     a synthetic binary table of 3,200,000 buckets x 341 keys
     (1,091,200,000 keys, 22 GB, made on the card): 1,245,184 windows
     into buckets that start past 2^30, where the kernel and its plain
     version must equal the analytic idx and rows (a ``--compare`` tree's
     wrong windows are counted: a midpoint that wraps misses there).
     ``--scale-only uniform,skewed`` runs phase 1 and this phase alone
     (``deep`` adds the deep DBs' tier sweeps before it).
   * fuzz (its own path, counted alone): ``--fuzz-rounds`` (default
     40) rounds of scripts/fuzz_parity from seed 1000 on the card, fresh
     random DBs against the oracle (TpuEngine, DeviceScorer, the native
     scorer, device best-call with rows past 32 calls, one forced JAX
     tier a round, the sharded step on four entries of card 0, family
     rounds every third seed with famwide rows forced where they fit,
     wide rounds of 4,096 mutated proteins every fifth against the
     searchsorted reference), then one round on its edge DB (buckets of
     12, 13, 25 and 26 keys); a mismatch fails the run.  Its coverage
     line must show hits in buckets of 12 and 13 keys and in pivot
     buckets, fallback rows, routed overflow, famwide and wide rounds,
     and probe_search, probe_select, scan_score, best_call, row_gather,
     family_group and famwide_select must each launch in it.
   ``--gather-exp NAMES`` (comma-separated, or ``all``) runs, alone, those
   gather_exp experiments and gather_scale_exp.
   ``--budgets`` runs, alone, what the family and routed budgets rest on:
   famwide against two-gather end to end and by kernel and the chunk
   sweep on the query cell and the uniform scale DB, the per-shard tiers
   and the routed capacity sweep on the query, deep and skewed scale DBs
   (``budgets``).
   ``--tier-e2e N`` runs, alone, the query DB's /query (device pack and
   slim pack + native), genome and /matrix rates on payload_wide and the
   binary search in turns, N rounds (``tier_e2e``); ``--port-root DIR``
   imports the port from another tree for it, e.g. the parent commit
   unpacked by git archive, one process a tree.
5. The main path (phases 3-4 up to build_db) is counted alone: its
   counters set to 0 just before phase 3 and read after build_db, before
   the sharded, scale and fuzz paths, which are counted alone in turn.
   Every kernel must have launched on the main path (probe_select there
   only in gather_exp's deepcmp and probepal: /query, the genome and
   /matrix probe through the binary search); the deep DB's, the genome's (with
   scan_score) and the matrix's probe kernel (probe_search) on their
   own paths.  The kernels line gives
   each kernel's main-path count as ``launches``, beside
   ``sharded_launches``, ``scale_launches`` and ``fuzz_launches``.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
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
    copy = GX.flush_by_index_copy(dst, buf, rpd)
    check(torch.equal(copy(), gx.dmaflush_plain(dst, buf, rpd)),
          "index_copy_ of the blocks differs from dmaflush's plain version")
    hold("dmaflush", "scripts/gather_exp.py:216",
         f"{GX.FLUSH_DMAS} copies of {rpd} x 128 int32",
         lambda: gx.dmaflush(dst, buf, rpd),
         lambda: gx._launch_dmaflush(dst, buf, rpd),
         lambda: gx.dmaflush_plain(dst, buf, rpd), 10,
         bound(nbytes(dst, buf) + GX.FLUSH_DMAS * rpd * 128 * 4), copy,
         "out.index_copy_(0, dst, blocks) (the blocks made beforehand)")
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
    table at a time; each tier's probe of the batch must equal the probe
    of ``ddb``, the auto-ladder's pick.  Returns {label: (ms, peak bytes
    above the resident tensors)}."""
    import torch
    check(ddb.tier == T.card_tier(db), f"the corpus DB took {ddb.tier}")
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
        table = d.table_bytes()
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
            f"to the {ddb.tier} probe")
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


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources: the names
    its kernels carry in a profiler trace (the ``ck_*`` C entry points
    launch them)."""
    import re
    csrc = os.path.join(REPO, "close_kmers_tpu_torch", "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names.update(pat.findall(fh.read()))
    return names


def phase_kser_profile() -> dict:
    """kser --torch-profile-dir on the card: the server process on the
    golden data dir (--device cuda), the /query golden conversation
    byte for byte, SIGINT; its Chrome trace must exist, be named on its
    stderr and hold a kernel of the port's CUDA sources.  Returns the
    trace's kernel events by name (the port's)."""
    import shutil
    import signal
    import subprocess
    out = os.path.join(REPO, "close_kmers_tpu_torch", ".build",
                       "chip_smoke_trace")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    port_file = os.path.join(out, "port")
    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, "-m", "close_kmers_tpu_torch.cli.kser", "0",
         os.path.join(GOLDEN, "data"), "--device", "cuda",
         "--listen-port-file", port_file, "--torch-profile-dir", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while not (os.path.exists(port_file)
                   and open(port_file).read().strip()):
            if p.poll() is not None:
                raise SmokeFailure(f"kser --torch-profile-dir exited: "
                                   f"{p.communicate()[1][-2000:]}")
            check(time.time() - t0 < 300, "kser did not start listening")
            time.sleep(0.2)
        with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
            body = f.read()
        with open(os.path.join(GOLDEN, "query.resp"), "rb") as f:
            want = f.read()
        got = _http(int(open(port_file).read()), GOLDEN_CONVS["query"](body))
        check(got == want, "the profiled server's /query differs from the "
              "golden bytes")
        p.send_signal(signal.SIGINT)
        _, err = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    traces = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"kser wrote {traces} into {out}")
    path = os.path.join(out, traces[0])
    check(f"trace written to {path}" in err, "kser did not name its trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = port_kernel_names()
    seen: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            for k in ours:
                if k in e.get("name", ""):
                    seen[k] = seen.get(k, 0) + 1
    check(seen, "the kser trace names none of the port's kernels")
    log(f"phase 3: kser --torch-profile-dir on the card: /query golden "
        f"bytes identical, SIGINT, trace {os.path.getsize(path)} B "
        f"({len(events)} events) with the port's kernels "
        f"{json.dumps(seen)}; {time.time() - t0:.1f} s")
    shutil.rmtree(out)
    return seen


def reference_calls(host, T, db, offsets, lengths, params, max_calls=64):
    """Independent CPU reference for a sample: hits by a numpy
    searchsorted over the DB keys, scored by native.score_batch (at most
    ``max_calls`` calls a sequence): fuzz_parity's ``reference_calls``."""
    from close_kmers_tpu_torch.scripts.fuzz_parity import reference_calls
    return reference_calls(db, offsets, lengths, params, max_calls)


def use_scorer(eng, mapping, dfs) -> None:
    """Put ``dfs`` in ``eng``'s scorer cache for ``mapping``: the engine's
    family entry points then run the family program through it."""
    eng._family_scorers[mapping] = (mapping.fam_csr(), dfs)


def family_pass(eng, mapping, offsets, lengths):
    """One pass of the /lookup?find_best_match=1 path over all of
    ``offsets``: best_family_matches_padded to arrays, genus filter off
    (as scripts/scale_1e9_serve.py runs it)."""
    return eng.best_family_matches_padded(offsets, lengths, mapping,
                                          genus_filter=False,
                                          as_arrays=True)


def family_rounds(eng, mapping, paths: dict, offsets, lengths,
                  rounds: int = 3):
    """All proteins through :func:`family_pass` with each path's scorer
    ({path: DeviceFamilyScorer}) in the engine's cache, in turns (the
    order reversed every other round, after a pass of each that also
    holds their answers equal), synced.  The engine's own scorer is back
    in its cache after.  Returns ({path: [seconds]}, the first path's
    answers as BestMatch objects)."""
    import torch
    own = eng._family_scorers.get(mapping)
    answers = None
    for name, sc in paths.items():
        use_scorer(eng, mapping, sc)
        got = list(family_pass(eng, mapping, offsets, lengths))
        check(answers is None or got == answers,
              f"family best matches on the {name} path differ")
        answers = answers or got
    names = list(paths)
    spent = {k: [] for k in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            use_scorer(eng, mapping, paths[name])
            torch.cuda.synchronize()
            t0 = time.time()
            family_pass(eng, mapping, offsets, lengths)
            torch.cuda.synchronize()
            spent[name].append(time.time() - t0)
    eng._family_scorers[mapping] = own
    return spent, answers


def median(xs) -> float:
    return float(np.median(xs))


def packs_equal(TF, scorers: dict, offsets, lengths, params,
                label: str) -> dict:
    """The fused family program (score_family_packed, the slim calls and
    the global rollup pack, at the first scorer's sticky caps) on each of
    ``scorers`` ({path: scorer}) over every BATCH chunk: the packs equal
    between paths on every chunk and parse without overflow.  Returns
    each path's seconds (upload to packs, synced; the second of two
    rounds)."""
    import torch
    from close_kmers_tpu_torch.core.device_score import DeviceScorer
    first = next(iter(scorers.values()))
    ccap, gps = first.bm_calls_per_seq, first.bm_groups_per_seq
    fold_calls, fold_rows = first.pack_flags(offsets.shape[1])
    unpack = (DeviceScorer.unpack_dense2 if fold_calls
              else DeviceScorer.unpack_dense3)
    for _ in range(2):                   # the first round warms each path
        spent = dict.fromkeys(scorers, 0.0)
        for a in range(0, len(offsets), BATCH):
            c_off, c_len = offsets[a:a + BATCH], lengths[a:a + BATCH]
            packs = {}
            for name, sc in scorers.items():
                torch.cuda.synchronize()
                t0 = time.time()
                calls, call_cap, rows, _, id_check = sc.score_family_packed(
                    c_off, c_len, params, ccap, -gps * BATCH,
                    slim_calls=True)
                torch.cuda.synchronize()
                spent[name] += time.time() - t0
                packs[name] = (calls.cpu(), rows.cpu())
                id_check.raise_if_bad()
            (fc, fr), *rest = packs.values()
            check(all(torch.equal(fc, c) and torch.equal(fr, r)
                      for c, r in rest),
                  f"{label}: the {' and '.join(scorers)} packs differ at "
                  f"chunk {a}")
            check(unpack(fc.numpy(), BATCH, call_cap) is not None
                  and TF.DeviceFamilyScorer.finish_rollup_global(
                      fr.numpy(), BATCH, gps * BATCH, folded=fold_rows)
                  is not None, f"{label}: packs overflowed at chunk {a}")
    return spent


def family_kernel_turns(T, fw, tg, off_d, len_d, flush, label: str) -> dict:
    """famwide against two-gather by kernel on one BATCH of ``off_d``:
    famwide_select on ``fw``'s famwide rows, and probe_search on ``tg``'s
    binary-search tables followed by row_gather on its family table (the
    ids probe_search gives), each by launch alone, in turns, L2 flushed
    (ms).  The two paths' family rows must be equal."""
    import torch
    from close_kmers_tpu_torch.ops import probe_search as PSr
    from close_kmers_tpu_torch.ops import probe_select as PS
    from close_kmers_tpu_torch.ops import row_gather as RG
    hi, lo, valid = (x.reshape(-1) for x in T.encode_windows(off_d, len_d))
    ddb = tg.ddb
    check(ddb.tier == "binary_search", f"{label}: the two-gather path "
          f"probes through {ddb.tier}")
    fargs = (hi, lo, valid, fw.famwide, fw.fam_w, fw.fam_d, T.FUSED_LO_BITS)
    fw_out = PS.famwide_outputs(hi.numel(), fw.fam_d, hi.device)
    sargs = (hi, lo, valid, ddb.bucket_pair, ddb.lo, ddb.payload, ddb.n,
             ddb.n_steps)
    s_out = PSr.search_outputs(hi.shape, hi.device)
    rows = ddb.search_rows
    PSr._launch(*sargs, s_out, rows)
    idx = s_out[5]
    table = tg.fdb.fam
    g_out = torch.empty((idx.numel(), table.shape[1]), dtype=torch.int32,
                        device=hi.device)
    g_bad = torch.empty(1, dtype=torch.int32, device=hi.device)
    RG._launch(table, idx, g_out, g_bad)
    PS._launch_famwide(*fargs, fw_out)
    torch.cuda.synchronize()
    check(int(g_bad[0]) == 0 and torch.equal(fw_out[3], g_out),
          f"{label}: famwide and two-gather family rows differ")

    def two_gather():
        PSr._launch(*sargs, s_out, rows)
        RG._launch(table, idx, g_out, g_bad)

    turns = cuda_ms_cold_turns({
        "famwide_select": lambda: PS._launch_famwide(*fargs, fw_out),
        "probe_search + row_gather": two_gather,
        "probe_search": lambda: PSr._launch(*sargs, s_out, rows),
        "row_gather": lambda: RG._launch(table, idx, g_out, g_bad)},
        20, flush)
    log(f"{label}: by launch, in turns, L2 flushed, {hi.numel()} windows "
        f"(ms): " + ", ".join(f"{k} {v:.4f}" for k, v in turns.items()))
    return turns


def phase_family(TF, eng, mapping, other, offsets, lengths, params, card):
    """Phase 4, family: all queries through best_family_matches_padded on
    the engine's own path (the card gate's pick) and on ``other`` (the
    other path's scorer) in interleaved rounds, the fused programs' packs
    equal on every chunk, and a sample against the host path."""
    dfs = eng._device_family_scorer(mapping)
    want_fw = TF.DeviceFamilyDB.card_famwide(eng.db, dfs.fdb.d)
    check((dfs.famwide is not None) == want_fw,
          "the card gate's family path is not the engine's")
    own = "famwide" if want_fw else "two-gather"
    paths = {own: dfs, ("two-gather" if want_fw else "famwide"): other}
    spent, ms = family_rounds(eng, mapping, paths, offsets, lengths)
    rates = {k: N_QUERY / median(v) for k, v in spent.items()}
    placed = sum(1 for m in ms if m.gfam_id)
    check(len(ms) == N_QUERY and placed > N_QUERY // 2,
          f"only {placed} of {len(ms)} proteins placed in a family")
    log(f"phase 4: family best-match: {N_QUERY} proteins, {placed} placed; "
        f"the engine's path {own}; proteins/s (median of 3, interleaved) "
        f"{json.dumps({k: round(v) for k, v in rates.items()})}; passes "
        f"(s) {json.dumps(spent)}; {card}")
    fused = packs_equal(TF, paths, offsets, lengths, params, "family cell")
    log(f"phase 4: famwide and two-gather packs equal on all "
        f"{N_QUERY // BATCH} chunks; fused program (upload to packs, "
        f"synced) per {N_QUERY}: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in fused.items()))

    eng.device_family = False
    try:
        t0 = time.time()
        want = eng.best_family_matches_padded(offsets[:SAMPLE],
                                              lengths[:SAMPLE], mapping,
                                              genus_filter=False)
    finally:
        eng.device_family = True
    check(want == ms[:SAMPLE],
          "family best matches differ from the host path on the sample")
    log(f"phase 4: {SAMPLE}-protein family sample equals the host path "
        f"(native.family_scores + find_best_family_match, "
        f"{time.time() - t0:.1f} s)")
    return rates[own], spent


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
    """Phase 2, genome: probe_search on the 5-Mbp genome's tile windows
    (the genome program's probe on ``ddb``, the binary-search tier) and
    scan_score on its scan inputs (9,984 rows x 1,016 windows), chained
    and state-only, each against its plain version.  Returns the two
    records' ``genome`` fields."""
    import torch
    check(ddb.tier == "binary_search", f"the genome probes {ddb.tier}")
    tiles, tlens, pos0, t_of, n_t = TG._genome_tiles(digits, n_true)
    hi, lo, valid = T.encode_windows(tiles, tlens)
    flat = (hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    got, probe = time_search(ddb, flat, flush, "the genome's windows")
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


def probe_kernel(ddb):
    """The wrapper of the kernel that ``ddb``'s tier probes through."""
    from close_kmers_tpu_torch.ops.probe_search import probe_search
    from close_kmers_tpu_torch.ops.probe_select import probe_select
    kernel = {"binary_search": probe_search, "payload_wide": probe_select,
              "sub_blocks": probe_select}.get(ddb.tier)
    check(kernel is not None, f"the {ddb.tier} tier has no kernel")
    return kernel


def phase_genome(host, T, TG, eng, db, genome: str, params) -> dict:
    """Phase 4, genome: the 5-Mbp genome through GenomeAnnotator.calls_of
    (best of passes, Mbp/s), its fixpoint rounds and kernel launches per
    genome, and all six frames' call lists against the native CPU
    reference over translate.six_frame_kguts_offsets."""
    import torch
    from close_kmers_tpu_torch.ops.scan_score import scan_score
    tr = host.translate
    digits = tr._DNA_CHAR[tr._to_bytes(genome)]   # parsed once, as a server
    ga = TG.GenomeAnnotator(eng)
    ga.calls_of(digits, params)                                 # warm-up
    probe = probe_kernel(eng.fa.ddb)
    before = (probe.launches, scan_score.launches)
    per_frame, frames = ga.calls_of(digits, params)
    per_genome = (probe.launches - before[0],
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
        f"{probe.__name__} {per_genome[0]}, scan_score {per_genome[1]}; "
        f"passes "
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
                probe=probe.__name__, launches=per_genome, calls=n_calls,
                profile=prof)


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
    t0 = time.time()
    offs, vals, rank = matrix_csr(db, rng)
    off_m, len_m = offsets[:MATRIX_P], lengths[:MATRIX_P]
    dm = TM.DeviceMatrix(eng, max_deg=3)
    po, pv = dm.stage_csr(offs, vals)
    torch.cuda.synchronize()
    log(f"set-up: matrix CSR of {len(vals):,} pegs built and staged in "
        f"{time.time() - t0:.1f} s")
    dm.count_pairs(off_m, len_m, po, pv, rank)                  # warm-up
    probe = probe_kernel(eng.fa.ddb)
    before = probe.launches
    pairs = dm.count_pairs(off_m, len_m, po, pv, rank)
    launches = probe.launches - before
    passes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        dm.count_pairs(off_m, len_m, po, pv, rank)
        passes.append(time.time() - t0)
    best = min(passes)
    shared = sum(pairs.values())
    log(f"phase 4: matrix: {MATRIX_P} proteins, {len(pairs)} pairs, {shared} "
        f"shared kmer-peg hits; {probe.__name__} launches {launches}; "
        f"passes "
        f"{passes} s; best {best:.4f} s = {MATRIX_P / best:.0f} proteins/s")
    check(launches > 0, f"the matrix path launched no {probe.__name__}")
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
    return dict(proteins_s=MATRIX_P / best, probe=probe.__name__,
                launches=launches,
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


def kernel_tree(root: str, label: str, name: str):
    """Kernel ``name`` (best_call or probe_search) as the tree at ``root``
    has it: its csrc/<name>.cu built alone by nvcc into the port's
    .build/, and its ops/<name>.py loaded as a module of its own that
    launches from that library.  To time another version of the kernel
    and its wrapper (the parent commit's, unpacked by ``git archive``)
    beside this tree's, in one process on one card."""
    import ctypes
    import importlib.util
    import subprocess
    from close_kmers_tpu_torch.ops import _build
    pkg = os.path.join(os.path.abspath(root), "close_kmers_tpu_torch")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, f"{name}_{label}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path,
         os.path.join(pkg, "csrc", f"{name}.cu")],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc failed on {label}'s {name}.cu:\n"
          f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fns = {}

    def kernel(entry, argtypes):
        if entry not in fns:
            fns[entry] = getattr(lib, entry)
            fns[entry].argtypes, fns[entry].restype = argtypes, ctypes.c_int
        return fns[entry]

    spec = importlib.util.spec_from_file_location(
        f"close_kmers_tpu_torch.ops._{name}_{label}",
        os.path.join(pkg, "ops", f"{name}.py"))
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
    (:func:`kernel_tree`), held to the plain version and timed in the
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
SHARD_KERNELS = ("probe_search", "scan_score", "row_gather", "family_group",
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
        check(all(d.tier == "binary_search" for d in sdb.local.values()),
              f"the {shape} shards did not take the binary search")
        log(f"phase 4 sharded {shape}: {sdb.n_shards} shards of <= {sdb.m:,}"
            f" rows, each on the binary search, family rows "
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
    sdb = SH.ShardedDB.from_db(db_deep, mesh, jax_layouts=True)
    torch.cuda.synchronize()
    check(sdb.sub_blocks is not None and sdb.payload_wide is None,
          "the deep DB's shards did not take sub blocks under the JAX "
          "module's gates")
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


# -- the scale phase: PATRIC-scale DBs, the tier gates, probe_search

# scripts/make_scale_db.py's default --target-kmers (BENCH_SCALE.json's
# 208M point); --scale-keys changes it
SCALE_KEYS = 210_000_000
SCALE_DBS = (("uniform", False, 21), ("skewed", True, 22))
# the subset of a scale DB's keys the spelled queries are drawn from (an
# argsort of every key's function would take ~20 s of host time)
SCALE_SPELL_POOL = 4_000_000
# what a plain tier's probe holds above its table, a multiple of one
# gathered row a window (the row, the match plane, the int32 one-hot)
PLAIN_PEAK_ROWS = {"fused_wide": 3.5, "lo_wide": 2.5}
SCALE_KERNELS = ("probe_search", "scan_score", "best_call", "row_gather",
                 "family_group")
# the largest tables a tier sweep builds (besides the picks it is given):
# --sweep-cap in GB sets it
SWEEP_MAX_BYTES = 16 << 30
# hi-bucket spans of the deeper DBs of the tier sweep: gather_exp's deep
# DB's keys over fewer buckets (~1,200 and ~4,900 keys a bucket)
DEEP_SPANS = (16_000, 4_000)


def host_available_bytes() -> int:
    """The host's MemAvailable (/proc/meminfo), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def card_free_bytes() -> int:
    import torch
    return torch.cuda.mem_get_info()[0]


def tier_row_w(T, st, tier: str) -> int:
    W = max(1, st.max_bucket)
    return {"fused_wide": T._lane_pad(1 + 2 * W),
            "lo_wide": T._lane_pad(1 + W)}.get(tier, 0)


def tier_fits(T, st, tier: str, n_windows: int):
    """(fits, why): whether ``tier``'s tables and its probe of
    ``n_windows`` windows fit the card's free memory and its numpy build
    the host's, with 2 GiB to spare on each."""
    need = T.tier_bytes(st, tier)
    peak = int(PLAIN_PEAK_ROWS.get(tier, 0) * n_windows
               * tier_row_w(T, st, tier) * 4)
    card, host = card_free_bytes(), host_available_bytes()
    if need + peak + (2 << 30) > card:
        return False, (f"{need} B of tables + ~{peak} B of probe above "
                       f"them > the card's {card} B free")
    # the numpy tables, the int64 row indices of the build, 2 GiB
    if need + st.n * 24 + (2 << 30) > host:
        return False, (f"{need} B of numpy tables + build scratch > the "
                       f"host's {host} B available")
    return True, ""


def time_tier(T, d, flat, want, label: str) -> dict:
    """One tier's probe of ``flat`` windows against ``want`` (six planes,
    equal bit for bit): ms warm (CUDA events, mean of 10), peak bytes
    above the resident tensors."""
    import torch
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = T.probe_windows(d, *flat)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    max_abs_err(want, got)
    del got
    ms = cuda_ms(lambda: T.probe_windows(d, *flat), 10)
    return dict(ms=ms, bytes=d.table_bytes(), peak=peak)


def tier_sweep(T, db, st, flat, want, label: str, keep: dict) -> dict:
    """``db`` built in each probe tier that fits (:func:`tier_fits`) and
    whose tables stay within SWEEP_MAX_BYTES (the builds of larger ones
    take tens of seconds of the run's time), one table at a time and
    freed after, except the tables in ``keep`` ({tier: DeviceDB}, timed
    as they are); each tier's probe of ``flat`` must equal ``want``.
    Returns {tier: record}; a tier left out has its bytes and why, and is
    printed by name."""
    import torch
    out = {}
    dev = flat[0].device
    for tier in T.TIERS:
        nb = T.tier_bytes(st, tier)
        if tier in keep:
            d = keep[tier]
        else:
            fits, why = tier_fits(T, st, tier, flat[0].numel())
            if fits and nb > SWEEP_MAX_BYTES:
                fits, why = False, (f"{nb} B of tables > the sweep's cap "
                                    f"of {SWEEP_MAX_BYTES} B (--sweep-cap)")
            if not fits:
                out[tier] = dict(left_out=why, bytes=nb)
                log(f"tiers {label}: {tier} left out: {why}")
                continue
            t0 = time.time()
            d = T.DeviceDB.from_numpy(T.tier_tables(db, tier), dev,
                                      copy=False)
            torch.cuda.synchronize()
            log(f"tiers {label}: {tier} built and uploaded in "
                f"{time.time() - t0:.1f} s")
        check(d.tier == tier, f"{tier} built the {d.tier} tier")
        rec = time_tier(T, d, flat, want, f"{label} {tier}")
        check(rec["bytes"] == nb, f"{label} {tier}: {rec['bytes']} B of "
              f"tables, tier_bytes says {nb}")
        out[tier] = rec
        log(f"tiers {label}: {tier}: {rec['ms']:.4f} ms per "
            f"{flat[0].numel()} windows, {rec['bytes']} B of tables, peak "
            f"{rec['peak']} B above them; six planes equal")
        del d
        torch.cuda.empty_cache()
    return out


def search_sectors(ddb, hi, lo, valid) -> int:
    """The distinct 32-B sectors of ``ddb.lo`` each window's lower bound
    reads (the halving search's reads: a step while left < right, then the
    final compare where left < end), summed over the windows."""
    import torch
    from close_kmers_tpu_torch.ops.probe_search import midpoint
    n = ddb.n
    v = valid.reshape(-1)
    hi_c = torch.where(v, hi.reshape(-1), 0).long()
    lo_c = torch.where(v, lo.reshape(-1), -2)
    pair = ddb.bucket_pair[hi_c]
    left, end = pair[:, 0], pair[:, 1]
    right = end.clone()
    sec = torch.full((len(v), ddb.n_steps + 1), -1, dtype=torch.int64,
                     device=hi.device)
    for s in range(ddb.n_steps):
        cont = v & (left < right)
        mid = midpoint(left, right)
        m = mid.clamp(max=n).long()
        sec[:, s] = torch.where(cont, m >> 3, -1)
        go = cont & (ddb.lo[m] < lo_c)
        left, right = (torch.where(go, mid + 1, left),
                       torch.where(cont & ~go, mid, right))
    last = v & (left < end)
    sec[:, -1] = torch.where(last, left.clamp(max=n).long() >> 3, -1)
    sec = torch.sort(sec, dim=1).values
    new = (sec >= 0) & torch.cat(
        [torch.ones_like(sec[:, :1], dtype=torch.bool),
         sec[:, 1:] != sec[:, :-1]], dim=1)
    return int(new.sum())


# other trees' probe_search modules ({label: module}, :func:`kernel_tree`),
# timed in turns with this tree's wherever :func:`time_search` runs;
# --compare sets it
SEARCH_TREES: dict = {}
# the bucket sizes up to which ck_probe_search finds a window in its
# search row alone (12 keys in 16-bit slots, every DB here), in the row
# and one round of 16-B lo chunks (its pivots leave at most 12 keys: 168),
# and past that with halvings between them
ROW_PATHS = (("row", 12), ("row+chunks", 168), ("row+halvings+chunks",
                                                2 ** 31))


def search_variants(args, want, names=None) -> dict:
    """The decomposition's functions (those in ``names``, else all): each
    experiment of ``ck_probe_search_exp`` (pair + payload alone, the first
    design at 128/256/512 threads a block and with 2-4 windows a thread,
    the quarter-warp k-ary design) and the first design at 256 threads on
    the windows sorted by hi (the sort not timed), each held to the plain
    version's planes ``want`` first.  Returns {name: fn}."""
    import torch
    from close_kmers_tpu_torch.ops import probe_search as PSr
    hi, lo, valid, *tabs = args
    fns = {}

    def hold(name, wins, known, want_):
        out = PSr.search_outputs(hi.shape, hi.device)

        def fn():
            PSr.launch_exp(name.replace("sorted_", "first_"), *wins,
                           *tabs[:3], known, *tabs[3:], out)

        fn()
        torch.cuda.synchronize()
        max_abs_err(want_, out)
        fns[name] = fn

    for name in PSr.EXP_VARIANTS:
        if names is None or name in names:
            hold(name, (hi, lo, valid), want[5], want)
    if names is None or "sorted_t256" in names:
        order = torch.argsort(hi, stable=True)
        hold("sorted_t256", [x[order] for x in (hi, lo, valid)],
             want[5][order], [w[order] for w in want])
    return fns


def row_paths(ddb, hi, valid) -> dict:
    """{path: windows}: the valid windows by the path of ck_probe_search
    their bucket's size takes (:data:`ROW_PATHS`)."""
    import torch
    ok = valid & (hi >= 0) & (hi < ddb.bucket_pair.shape[0])
    pair = ddb.bucket_pair[hi[ok].long()]
    size = (pair[:, 1] - pair[:, 0]).contiguous()
    limits = torch.tensor([m for _, m in ROW_PATHS[:-1]], dtype=size.dtype,
                          device=size.device)
    got = torch.bincount(torch.bucketize(size, limits),
                         minlength=len(ROW_PATHS)).tolist()
    return {name: k for (name, _), k in zip(ROW_PATHS, got)}


def search_registers(report: str) -> dict:
    """{kernel<template arguments>: [registers, spill store bytes]} of
    probe_search.cu's kernels in the ``-Xptxas -v`` ``report``."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"entry function '_Z\w*?(row_search_kernel|"
                      r"quarter_kernel|search_thread_kernel)I(\w*?)EEv",
                      line)
        if m:
            args = ",".join(a or b for a, b in
                            re.findall(r"Li(\d+)E|Lb(\d)E", m.group(2) + "E"))
            name = f"{m.group(1)}<{args}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, [None, 0])[0] = int(m.group(1))
            name = None
    return out


def time_search(ddb, flat, flush, label: str, decompose: bool = False,
                hold_trees: bool = True):
    """probe_search on ``ddb``'s binary-search tables against its plain
    version, bit for bit, on the ``flat`` windows: by launch, warm and L2
    flushed, the plain version, and the bound; in turns, L2 flushed
    (``turns``), this kernel, the first design (one thread a window, 256
    a block) and each tree of :data:`SEARCH_TREES` (held to the plain
    version where ``hold_trees``), with ``decompose`` also every
    experiment of :func:`search_variants`.  Returns (the kernel's planes,
    the record's fields)."""
    import torch
    from close_kmers_tpu_torch.ops import probe_search as PSr
    hi, lo, valid = flat
    args = (hi, lo, valid, ddb.bucket_pair, ddb.lo, ddb.payload, ddb.n,
            ddb.n_steps)
    rows = getattr(ddb, "search_rows", None)
    if rows is None:
        rows = PSr.search_rows(ddb.bucket_pair, ddb.lo, ddb.n)
    got = PSr.probe_search(*args, rows)
    torch.cuda.synchronize()
    want = PSr.probe_search_plain(*args)
    err = max_abs_err(want, got)
    n_hit = int(got[0].sum())
    check(n_hit > 0, f"probe_search on {label} found no hits")
    out = PSr.search_outputs(hi.shape, hi.device)
    fns = {"this": lambda: PSr._launch(*args, out, rows)}
    for tree, mod in SEARCH_TREES.items():
        o = mod.search_outputs(hi.shape, hi.device)
        fns[tree] = (lambda m, o_: lambda: m._launch(*args, o_))(mod, o)
        fns[tree]()
        torch.cuda.synchronize()
        if hold_trees:
            max_abs_err(want, o)
    fns.update(search_variants(args, want,
                               None if decompose else ["first_t256"]))
    turns = cuda_ms_cold_turns(fns, 20, flush)
    rec = dict(
        max_abs_err=err,
        ms=cuda_ms_cold(fns["this"], 20, flush),
        warm_ms=cuda_ms(fns["this"], 20),
        plain_ms=cuda_ms(lambda: PSr.probe_search_plain(*args), 3),
        windows=hi.numel(), hits=n_hit, n_steps=ddb.n_steps, turns=turns,
        row_paths=row_paths(ddb, hi, valid))
    # each window's 9 B in and 21 B out, the bucket pair of each valid
    # window, the 32-B lo sectors its search reads, a hit's payload row
    n_valid = int(valid.sum())
    rec["sectors"] = search_sectors(ddb, hi, lo, valid)
    rec.update(bound(hi.numel() * (9 + 21) + n_valid * 8
                     + rec["sectors"] * 32 + n_hit * 16))
    log(f"probe_search on {label}: {hi.numel()} windows ({n_valid} valid, "
        f"{n_hit} hits), n_steps {ddb.n_steps}, valid windows by their "
        f"bucket's path {rec['row_paths']}: launch alone "
        f"{rec['ms']:.4f} ms L2 flushed, {rec['warm_ms']:.4f} ms warm; "
        f"plain {rec['plain_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms "
        f"({rec['sectors']} distinct 32-B lo sectors); max_abs_err {err}; "
        f"in turns, L2 flushed (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in turns.items()))
    return got, rec


def probe_search_record(T, db, ddb, flat, flush, label: str,
                        decompose: bool = False) -> dict:
    """:func:`time_search` on ``ddb`` (the binary-search tier of ``db``,
    with the decomposition where ``decompose``),
    the kernel's planes also against numpy searchsorted over all of
    ``db.keys``, beside torch.searchsorted of the windows' int64 codes in
    the keys plus the equality test (the library call)."""
    import torch
    got, rec = time_search(ddb, flat, flush, label, decompose)
    hi, lo, valid = flat
    h, lw, v = (x.cpu().numpy() for x in flat)
    codes = h.astype(np.int64) * 8000 + lw
    i = np.searchsorted(db.keys, codes)
    hit = v & (i < len(db)) & (db.keys[np.minimum(i, len(db) - 1)] == codes)
    g = [x.cpu().numpy() for x in got]
    check(np.array_equal(g[0], hit), f"{label}: found differs from numpy "
          f"searchsorted")
    check(np.array_equal(g[5], np.where(hit, i, len(db))),
          f"{label}: idx differs from numpy searchsorted")
    rows = i[hit]
    for plane, col in ((g[1], db.fi), (g[2], db.oi), (g[3], db.avg_off)):
        check(np.array_equal(plane[hit], col[rows]) and
              (plane[~hit] == plane[~hit][:1]).all(),
              f"{label}: payload differs from the DB's columns")
    check(np.array_equal(g[4][hit].view(np.int32),
                         db.wt[rows].view(np.int32)), f"{label}: wt differs")
    keys_d = torch.from_numpy(db.keys).to(hi.device)
    codes_d = torch.where(valid, hi.long() * 8000 + lo, -1)

    def library():
        j = torch.searchsorted(keys_d, codes_d)
        return keys_d[j.clamp(max=len(db) - 1)] == codes_d

    check(torch.equal(library().cpu(), torch.from_numpy(hit)),
          f"{label}: torch.searchsorted disagrees")
    rec.update(library_call="torch.searchsorted(keys, codes) + equality",
               library_ms=cuda_ms_cold(library, 20, flush))
    log(f"probe_search on {label}: equal to numpy searchsorted over "
        f"{len(db):,} keys; torch.searchsorted + equality "
        f"{rec['library_ms']:.4f} ms L2 flushed")
    return rec


def scale_spelled(db, n: int, seed: int):
    """``n`` spelled proteins (:func:`spelled_queries`) drawn from a random
    SCALE_SPELL_POOL of ``db``'s keys."""
    rng = np.random.default_rng(seed)
    pool = np.sort(rng.integers(0, len(db), size=min(SCALE_SPELL_POOL,
                                                     len(db))))
    sub = types.SimpleNamespace(fi=db.fi[pool], keys=db.keys[pool])
    return spelled_queries(sub, n, rng)


def scale_e2e(host, T, db, ds_card, ds_jax, offsets, lengths, params,
              card: str, label: str) -> dict:
    """All queries through DeviceScorer.best_batch_packed in batches of
    BATCH on the port's pick and on the JAX pick, interleaved (3 passes
    each, median); the packs must be equal, and a SAMPLE's best calls
    equal native.best_call_batch over the searchsorted reference."""
    import torch
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, len(offsets), BATCH)]

    def run(ds):
        return [ds.best_batch_packed(o, n, params).cpu().numpy()
                for o, n in chunks]

    packs = {"card": run(ds_card), "jax": run(ds_jax)}
    check(all(np.array_equal(a, b) for a, b in zip(packs["card"],
                                                   packs["jax"])),
          f"{label}: best packs differ between the two tiers")
    spent = {"card": [], "jax": []}
    for r in range(3):
        for k in (("card", "jax") if r % 2 == 0 else ("jax", "card")):
            torch.cuda.synchronize()
            t0 = time.time()
            run({"card": ds_card, "jax": ds_jax}[k])
            torch.cuda.synchronize()
            spent[k].append(time.time() - t0)
    rates = {k: len(offsets) / sorted(v)[1] for k, v in spent.items()}
    pack = np.concatenate(packs["card"])[:SAMPLE]
    check(not pack[:, 8].any(), f"{label}: a sample row overflowed")
    fo = db.function_of
    got = ds_card.finish_best_batch(pack, fo)
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(
        host, T, db, offsets[:SAMPLE], lengths[:SAMPLE], params)
    nf, ofi, ocnt, owt = host.native.best_call_batch(n_ref, cs, ce, cc, cf,
                                                     cw)
    want = [T.finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s], fo)
            for s in range(len(nf))]
    check(all(vars(g) == vars(w) for g, w in zip(got, want)),
          f"{label}: best calls differ from the native reference")
    named = sum(1 for w in want if w.function)
    check(named > SAMPLE // 2, f"{label}: only {named} sample proteins "
          f"have a best call")
    log(f"scale {label}: best_batch_packed on {len(offsets)} spelled "
        f"proteins: port's pick ({ds_card.ddb.tier}) {rates['card']:.0f} "
        f"proteins/s, JAX pick ({ds_jax.ddb.tier}) {rates['jax']:.0f} "
        f"proteins/s (median of 3, interleaved, upload to the pack home); "
        f"packs equal; {SAMPLE}-protein sample equal to native best-call "
        f"on the searchsorted reference ({int(n_ref.sum())} calls, {named} "
        f"named); {card}")
    return dict(rates, passes=spent)


def host_peak_bytes() -> int:
    """This process's peak resident set so far (getrusage's ru_maxrss, in
    KiB on Linux), in bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def scale_family(T, TF, db, offsets, lengths, params, flush, card: str,
                 label: str) -> dict:
    """The family phase on a scale DB: make_scale_db.scale_mapping over
    ``db`` (the JAX scale serve's universe), ``KmerEngine(db, card)``
    with the default device_family_min, whose gates must send the
    mapping to the device family program; all proteins through
    best_family_matches_padded (the /lookup?find_best_match=1 path, to
    arrays, genus filter off) in rounds, one pass profiled (the card's
    busy share), a SAMPLE equal to the host path (the same engine with
    device_family off: compact hits, native.family_scores,
    find_best_family_match).  Where the DB's buckets allow famwide rows
    (the uniform DB) the other path is forced beside the engine's:
    rounds interleaved, the packs equal on every chunk, and famwide
    against two-gather by kernel.  Records the build seconds, the family
    table's bytes, peak device memory and the process's peak host RSS."""
    import torch
    from close_kmers_tpu_torch.core.api import KmerEngine
    from close_kmers_tpu_torch.core.engine import FUSED_BUCKET_MAX
    from close_kmers_tpu_torch.scripts.make_scale_db import scale_mapping
    dev = flush.device
    t0 = time.time()
    mapping = scale_mapping(db)
    t_map = time.time() - t0
    t0 = time.time()
    eng = KmerEngine(db, dev)
    torch.cuda.synchronize()
    t_eng = time.time() - t0
    gate = eng.family_gate(mapping)
    check(gate is None, f"scale {label}: the device family path was "
          f"refused: {gate}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    dfs = eng._device_family_scorer(mapping)
    torch.cuda.synchronize()
    t_scorer = time.time() - t0
    check(dfs is not None, f"scale {label}: no device family scorer")
    own = "two-gather" if dfs.famwide is None else "famwide"
    table_b = nbytes(dfs.fdb.fam) + (nbytes(dfs.famwide)
                                     if dfs.famwide is not None else 0)
    log(f"scale {label} family: scale_mapping {t_map:.1f} s "
        f"({len(mapping.families):,} families, D {dfs.fdb.d}), KmerEngine "
        f"{t_eng:.1f} s, the engine's scorer ({own}) {t_scorer:.1f} s: "
        f"{json.dumps({k: round(v, 2) for k, v in dfs.build_seconds.items()})}"
        f"; family tables {table_b} B; the engine's gates pass "
        f"(device_family_min {eng.device_family_min})")
    paths = {own: dfs}
    rec = dict(map_s=t_map, engine_s=t_eng, scorer_s=t_scorer,
               build_s=dfs.build_seconds, table_bytes=table_b, path=own)
    other = None
    if TF.DeviceFamilyDB.famwide_packs(db) \
            and db.max_bucket <= FUSED_BUCKET_MAX:
        t0 = time.time()
        other = TF.DeviceFamilyScorer(db, mapping, dev, ddb=eng.fa.ddb,
                                      famwide=dfs.famwide is None)
        torch.cuda.synchronize()
        name = "famwide" if other.famwide is not None else "two-gather"
        paths[name] = other
        rec["forced"] = dict(path=name, s=time.time() - t0,
                             build_s=other.build_seconds,
                             table_bytes=nbytes(other.famwide)
                             if other.famwide is not None else 0)
        log(f"scale {label} family: the {name} path forced beside it in "
            f"{rec['forced']['s']:.1f} s "
            f"({json.dumps({k: round(v, 2) for k, v in other.build_seconds.items()})}"
            f"; {rec['forced']['table_bytes']} B of famwide rows)")
    spent, ms = family_rounds(eng, mapping, paths, offsets, lengths)
    rates = {k: len(offsets) / median(v) for k, v in spent.items()}
    placed = sum(1 for m in ms if m.gfam_id)
    check(placed > len(ms) // 2, f"scale {label}: only {placed} of "
          f"{len(ms)} proteins placed")
    if other is not None:
        rec["fused_s"] = packs_equal(TF, paths, offsets, lengths, params,
                                     f"scale {label}")
        off_d = torch.from_numpy(offsets[:BATCH]).to(dev)
        len_d = torch.from_numpy(lengths[:BATCH]).to(dev)
        fw, tg = ((dfs, other) if own == "famwide" else (other, dfs))
        rec["kernels"] = family_kernel_turns(
            T, fw, tg, off_d, len_d, flush, f"scale {label} family")
    prof = device_share(lambda: family_pass(eng, mapping, offsets, lengths))
    eng.device_family = False
    try:
        t0 = time.time()
        want = eng.best_family_matches_padded(offsets[:SAMPLE],
                                              lengths[:SAMPLE], mapping,
                                              genus_filter=False)
        t_host = time.time() - t0
    finally:
        eng.device_family = True
    check(want == ms[:SAMPLE], f"scale {label}: family best matches differ "
          f"from the host path on the sample")
    peak = torch.cuda.max_memory_allocated()
    rec.update(rates=rates, passes=spent, placed=placed, profile=prof,
               peak_device_bytes=peak, resident_bytes=eng.fa.ddb.table_bytes()
               + table_b, peak_host_bytes=host_peak_bytes(),
               host_sample_s=t_host)
    log(f"scale {label} family: {len(ms)} proteins, {placed} placed; "
        f"proteins/s (median of 3, interleaved) "
        f"{json.dumps({k: round(v) for k, v in rates.items()})}; passes (s) "
        f"{json.dumps(spent)}"
        + (f"; packs equal on every chunk, fused program per pass (s) "
           f"{json.dumps(rec['fused_s'])}" if other is not None else "")
        + f"; one pass profiled: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']} ms, top {json.dumps(prof['top'])}; "
        f"{SAMPLE}-protein sample equal to the host path ({t_host:.1f} s); "
        f"peak device memory {peak} B (tables {rec['resident_bytes']} B), "
        f"the process's peak host RSS so far {rec['peak_host_bytes']} B; "
        f"{card}")
    del eng, dfs, other, paths, mapping
    torch.cuda.empty_cache()
    return rec


def phase_scale(host, T, n_keys: int, which, params, flush, card: str):
    """The scale phase: for each scale DB of ``which`` (SCALE_DBS names),
    ``n_keys`` keys made on the card by make_scale_db.scale_db, its
    statistics and each gate set's pick; probe_search against its plain
    version and numpy searchsorted on 1,245,184 windows (BATCH spelled
    proteins); every tier that fits timed on the same windows; the
    65,536-protein best-call pass on the port's pick and the JAX pick;
    then, its tables freed, the family phase (:func:`scale_family`).
    Returns {label: results}."""
    import torch
    from close_kmers_tpu_torch.core import device_family as TF
    from close_kmers_tpu_torch.scripts.make_scale_db import scale_db
    dev = flush.device
    out = {}
    for label, aa_bias, seed in SCALE_DBS:
        if label not in which:
            continue
        t0 = time.time()
        db = scale_db(n_keys, aa_bias=aa_bias, seed=seed, device=dev)
        t_gen = time.time() - t0
        t0 = time.time()
        st = T.tier_stats(db)
        pick, jpick = T.card_tier(db), T.flag_tier(st)
        nbytes_ = {t: T.tier_bytes(st, t) for t in T.TIERS}
        log(f"scale {label}: {len(db):,} keys made on the card in "
            f"{t_gen:.1f} s (stats {time.time() - t0:.1f} s): max bucket "
            f"{st.max_bucket}, max sub {st.max_sub}, {st.n_sub:,} sub-"
            f"buckets, fi max {st.fi_max}; the port picks {pick}, "
            f"the JAX gates {jpick}; table bytes {json.dumps(nbytes_)}")
        t0 = time.time()
        offsets, lengths = scale_spelled(db, N_QUERY, seed)
        off_b = torch.from_numpy(offsets[:BATCH]).to(dev)
        len_b = torch.from_numpy(lengths[:BATCH]).to(dev)
        flat = T.encode_windows(off_b, len_b)
        log(f"scale {label}: {N_QUERY} spelled queries in "
            f"{time.time() - t0:.1f} s")
        t0 = time.time()
        ddb_bin = T.DeviceDB.from_db(db, dev)
        torch.cuda.synchronize()
        check(ddb_bin.tier == pick == "binary_search",
              f"{label}: from_db built {ddb_bin.tier}")
        log(f"scale {label}: the port's pick (from_db, no flags) built and "
            f"uploaded in {time.time() - t0:.1f} s")
        rec = probe_search_record(T, db, ddb_bin, tuple(
            x.reshape(-1) for x in flat), flush, f"the {label} scale DB",
            decompose=label == "skewed")
        want = T.probe_windows(ddb_bin, *flat)
        t0 = time.time()
        keep = {"binary_search": ddb_bin}
        if jpick not in keep:
            keep[jpick] = T.DeviceDB.from_db(db, dev,
                                             **T.JAX_TIER_FLAGS[jpick])
        torch.cuda.synchronize()
        check(keep[jpick].tier == jpick, f"{label}: the JAX flags built "
              f"{keep[jpick].tier}")
        log(f"scale {label}: the JAX pick (from_db, its flags) built and "
            f"uploaded in {time.time() - t0:.1f} s")
        tiers = tier_sweep(T, db, st, flat, want, f"scale {label}", keep)
        from close_kmers_tpu_torch.core.device_score import DeviceScorer
        e2e = scale_e2e(host, T, db, DeviceScorer(db, dev, keep[pick]),
                        DeviceScorer(db, dev, keep[jpick]), offsets, lengths,
                        params, card, label)
        del keep, ddb_bin, want, flat, off_b, len_b
        torch.cuda.empty_cache()
        fam = scale_family(T, TF, db, offsets, lengths, params, flush, card,
                           label)
        out[label] = dict(keys=len(db), stats=dataclasses.asdict(st),
                          card_tier=pick, jax_tier=jpick, tiers=tiers,
                          e2e=e2e, probe_search=rec, family=fam)
        del db
    return out


def deep_sweeps(T, GX, dev, keep_deep: dict) -> dict:
    """The tier sweep on deep DBs of PATRIC density: gather_exp's deep DB
    (its EXP_DEEP_KEYS keys over EXP_DEEP_SPAN hi buckets, whose tables
    ``keep_deep`` holds, {tier: DeviceDB}, the binary search among them) and the same keys over each
    span of DEEP_SPANS, deeper buckets and sub-buckets; BATCH spelled
    proteins' windows each.  Returns {label: (stats, picks, sweep)}."""
    import torch
    out = {}
    for span in (GX.EXP_DEEP_SPAN, *DEEP_SPANS):
        label = f"deep {span}"
        db = GX.deep_db(hi_span=span)
        st = T.tier_stats(db)
        off, ln = spelled_queries(db, BATCH, np.random.default_rng(span))
        flat = T.encode_windows(torch.from_numpy(off).to(dev),
                                torch.from_numpy(ln).to(dev))
        keep = (keep_deep if span == GX.EXP_DEEP_SPAN else
                {"binary_search": T.DeviceDB.from_db(db, dev)})
        want = T.probe_windows(keep["binary_search"], *flat)
        picks = (T.card_tier(db), T.flag_tier(st))
        log(f"tiers {label}: {len(db):,} keys, max bucket {st.max_bucket}, "
            f"max sub {st.max_sub}, {st.n_sub:,} sub-buckets; the port "
            f"picks {picks[0]}, the JAX gates {picks[1]}")
        out[label] = (dataclasses.asdict(st), picks,
                      tier_sweep(T, db, st, flat, want, label, keep))
        del db, flat, want
        torch.cuda.empty_cache()
    return out


# the synthetic binary table past 2^30 keys: BIG_BUCKETS buckets of
# BIG_DEPTH keys, bucket h holding lo = BIG_STRIDE * k for k < BIG_DEPTH
# (n = 1,091,200,000; lo 4.4 GB, payload 17.5 GB)
BIG_BUCKETS = 3_200_000
BIG_DEPTH = 341
BIG_STRIDE = 23
BIG_FIRST = 1 << 30      # the windows' buckets start at or above it


def big_table(dev):
    """The synthetic table, made on the card with torch: lo_arr as above
    (the sentinel -1 at n), payload row i = (i, i + 1, -i, i) and row n
    the miss row (-1, -1, 0, 0), bucket h = [341h, 341h + 341); n_steps
    as from_db sets it."""
    import math
    import torch
    n = BIG_BUCKETS * BIG_DEPTH
    lo_arr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    keys = torch.arange(BIG_DEPTH, dtype=torch.int32, device=dev) * BIG_STRIDE
    lo_arr[:n].view(BIG_BUCKETS, BIG_DEPTH).copy_(
        keys.expand(BIG_BUCKETS, BIG_DEPTH))
    lo_arr[n] = -1
    payload = torch.empty((n + 1, 4), dtype=torch.int32, device=dev)
    r = torch.arange(n + 1, dtype=torch.int32, device=dev)
    payload[:, 0] = r
    payload[:, 3] = r
    payload[:, 2] = r.neg_()
    payload[:, 1] = r.neg_().add_(1)
    del r
    payload[n] = torch.tensor([-1, -1, 0, 0], dtype=torch.int32, device=dev)
    start = torch.arange(BIG_BUCKETS, dtype=torch.int32,
                         device=dev) * BIG_DEPTH
    pair = torch.stack([start, start + BIG_DEPTH], dim=1).contiguous()
    return types.SimpleNamespace(
        bucket_pair=pair, lo=lo_arr, payload=payload, n=n,
        n_steps=max(1, math.ceil(math.log2(BIG_DEPTH + 1))))


def phase_big_table(flush, card: str) -> dict:
    """probe_search on :func:`big_table`: 1,245,184 windows into buckets
    that start at or above 2^30 (6 in 8 planted keys, 1 in 8 a lo between
    two keys, 1 in 8 invalid); the kernel equal to its plain version (in
    :func:`time_search`) and both to the analytic idx and payload rows.
    Each tree of :data:`SEARCH_TREES` runs the same windows, and its
    windows that differ from the analytic planes are counted (a tree
    whose midpoint wraps misses there).  Returns the record."""
    import torch
    from close_kmers_tpu_torch.ops import probe_search as PSr
    dev = flush.device
    t0 = time.time()
    tab = big_table(dev)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    rng = np.random.default_rng(12)
    nw = BATCH * 304
    h0 = -(-BIG_FIRST // BIG_DEPTH)        # the first bucket at >= 2^30
    h = rng.integers(h0, BIG_BUCKETS, size=nw)
    k = rng.integers(0, BIG_DEPTH, size=nw)
    kind = rng.integers(0, 8, size=nw)
    lo = BIG_STRIDE * k + np.where(kind == 6, rng.integers(1, BIG_STRIDE,
                                                           size=nw), 0)
    valid = kind != 7
    hit = kind < 6
    n = tab.n
    want_idx = np.where(hit, h * BIG_DEPTH + k, n)
    want_rows = np.where(hit[:, None], np.stack(
        [want_idx, want_idx + 1, -want_idx, want_idx], axis=1),
        np.array([-1, -1, 0, 0]))
    flat = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (h.astype(np.int32), lo.astype(np.int32), valid))

    def wrong(planes) -> int:
        g = [x.cpu().numpy() for x in planes]
        rows = np.stack([g[1], g[2], g[3], g[4].view(np.int32)], axis=1)
        bad = ((g[0] != hit) | (g[5] != want_idx)
               | (rows != want_rows).any(axis=1))
        return int(bad.sum())

    got, rec = time_search(tab, flat, flush, "the 1.09e9-key table",
                           hold_trees=False)
    check(wrong(got) == 0, "probe_search (and its plain version) differ "
          "from the analytic planes on the 1.09e9-key table")
    rec["trees_wrong"] = {}
    for tree, mod in SEARCH_TREES.items():
        out = mod.search_outputs(flat[0].shape, dev)
        mod._launch(*flat, tab.bucket_pair, tab.lo, tab.payload, n,
                    tab.n_steps, out)
        torch.cuda.synchronize()
        rec["trees_wrong"][tree] = wrong(out)
    rec.update(keys=n, first_start=h0 * BIG_DEPTH, build_s=t_build)
    log(f"probe_search on {n:,} keys (buckets of {BIG_DEPTH} starting at "
        f"{h0 * BIG_DEPTH:,} and above, table made on the card in "
        f"{t_build:.1f} s): the kernel and the plain version equal the "
        f"analytic idx and rows on all {nw:,} windows ({int(hit.sum()):,} "
        f"planted keys); windows wrong by tree: "
        f"{json.dumps(rec['trees_wrong'])}; {card}")
    del tab, got, flat
    torch.cuda.empty_cache()
    return rec


FUZZ_ROUNDS = 40
FUZZ_SEED0 = 1000        # fuzz_parity's own first seed
# the serving kernels the fuzz phase must launch
FUZZ_KERNELS = ("probe_search", "probe_select", "scan_score", "best_call",
                "row_gather", "family_group", "famwide_select")


def phase_fuzz(wrappers, rounds: int, device, card: str) -> dict:
    """The fuzz phase, a path of its own (every kernel's count set to 0
    just before it and read just after): ``rounds`` rounds of
    ``scripts/fuzz_parity`` from seed FUZZ_SEED0 on the card (family
    rounds, wide rounds of one 4,096-protein serving batch) and one round
    on its edge DB; a mismatch raises.  The coverage must show hits in
    buckets of exactly 12 and 13 keys and in pivot buckets, rows through
    the best-call fallback, routed overflow windows, family rounds that
    read forced famwide rows, and wide rounds, and every kernel of
    FUZZ_KERNELS must have launched.  Returns the phase's seconds, coverage and counts."""
    from close_kmers_tpu_torch.scripts import fuzz_parity as FZ
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.time()
    cov = FZ.run(rounds, FUZZ_SEED0, device, edge=True)
    spent = time.time() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    log(cov.line())
    log(f"phase 4 fuzz: {cov.rounds} rounds ({rounds} from seed "
        f"{FUZZ_SEED0}, then the edge DB) with no mismatch in {spent:.1f} s;"
        f" launches in the phase: {json.dumps(counts)}; {card}")
    check(cov.hits["12"] > 0 and cov.hits["13"] > 0,
          "the fuzz phase met no hit in a bucket of 12 or 13 keys")
    check(cov.hits["14-25"] + cov.hits["26+"] > 0,
          "the fuzz phase met no hit in a pivot bucket")
    check(cov.fallback_rows > 0, "no fuzz row took the best-call fallback")
    check(cov.routed_overflow > 0, "no fuzz window took the routed overflow")
    check(cov.family_rounds > 0 and cov.famwide_rounds > 0,
          "the fuzz phase ran no family round with famwide rows")
    check(cov.wide_rounds > 0, "the fuzz phase ran no wide round")
    for name in FUZZ_KERNELS:
        check(counts[name] > 0, f"{name} was never launched in the fuzz "
              f"phase")
    return dict(seconds=spent, rounds=cov.rounds, counts=counts,
                coverage=dataclasses.asdict(cov))


def probepal_parity(device) -> dict:
    """probepal's kernel against the plain probe_select on its rows: the
    experiment's shapes (N_IDX windows into N_ROWS rows of 128 ints,
    distinct lo slots a row), the six planes bit for bit.  The launch
    goes through ``_launch_probe`` and counts nowhere."""
    import torch
    from close_kmers_tpu_torch.ops import probe_select as PS
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    gen = torch.Generator(device=device).manual_seed(11)
    tbl = GX.distinct_lo_rows(gen, GX.N_ROWS, 128, GX.WD, device)
    idx = torch.randint(0, GX.N_ROWS, (GX.N_IDX,), generator=gen,
                        device=device, dtype=torch.int32)
    lo_q = torch.randint(0, 100, (GX.N_IDX,), generator=gen, device=device,
                         dtype=torch.int32)
    valid = torch.ones(GX.N_IDX, dtype=torch.bool, device=device)
    got = PS.probe_outputs(GX.N_IDX, device)
    PS._launch_probe(idx, lo_q, valid, tbl, GX.WD, GX.N_ROWS, got)
    want = PS.probe_select_plain(idx, lo_q, valid, tbl, GX.WD, GX.N_ROWS)
    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
          "probepal: the probe_select kernel differs from its plain "
          "version on the experiment's rows")
    found = int(want[0].sum())
    check(found > 0, "probepal's windows found nothing")
    log(f"phase 2: probepal's probe_select kernel equals its plain version "
        f"on {GX.N_IDX:,} windows into {GX.N_ROWS:,} rows of 128 ints "
        f"({found:,} found)")
    return dict(windows=GX.N_IDX, rows=GX.N_ROWS, found=found,
                max_abs_err=0)


def gather_exp_names(spec: str | None) -> list:
    """The experiments a run takes: every one but GX.FLAGGED by default;
    ``--gather-exp all`` every one, else the comma-separated names."""
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    if spec is None:
        return [e for e in GX.EXPERIMENTS if e not in GX.FLAGGED]
    return list(GX.EXPERIMENTS) if spec == "all" else spec.split(",")


def gather_exp_only(args, device, kind: str, card: str,
                    t_start: float) -> int:
    """``--gather-exp NAMES``: the named gather_exp experiments (deepcmp
    on its deep DB, probepal held to its plain version first) and
    gather_scale_exp, alone; prints their record, the nvidia-smi line and
    the device line."""
    import torch
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    from close_kmers_tpu_torch.scripts import gather_scale_exp as GS
    names = gather_exp_names(args.gather_exp)
    rec = {}
    if "probepal" in names:
        rec["probepal_parity"] = probepal_parity(device)
    exp = GX.run(names, device,
                 deep=GX.deep_db() if "deepcmp" in names else None)
    scale = GS.run(device)
    log(f"gather_exp experiments and gather_scale_exp in "
        f"{time.time() - t_start:.1f} s on {card}")
    print(json.dumps({"gather_exp_ms": {k: v * 1e3 for k, v in exp.items()},
                      "gather_scale": scale, **rec}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_scale(host, T, wrappers, n_keys: int, which, params, device,
              card: str):
    """:func:`phase_scale` and :func:`phase_big_table` as a path of its
    own: every kernel's count set to 0 just before it and read just
    after; the kernels of SCALE_KERNELS must each have launched in it.
    Returns (its results, the big table's record, its counts)."""
    import torch
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    scale = phase_scale(host, T, n_keys, which, params, flush, card)
    big = phase_big_table(flush, card)
    del flush
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4 scale: {time.time() - t0:.1f} s; launches on the scale "
        f"path: {json.dumps(counts)}; peak device memory {peak} B "
        f"({peak / 2**30:.2f} GiB); {card}")
    for name in SCALE_KERNELS:
        check(counts[name] > 0, f"{name} was never launched on the scale "
              f"path")
    return scale, big, counts


def family_summary(fam: dict) -> dict:
    """The scale family phase's record without its passes and profile's
    top names: proteins/s, build seconds, bytes, peaks, busy share."""
    prof = fam["profile"]
    return dict(
        path=fam["path"], proteins_s={k: round(v) for k, v in
                                      fam["rates"].items()},
        map_s=fam["map_s"], engine_s=fam["engine_s"],
        build_s=fam["build_s"], table_bytes=fam["table_bytes"],
        forced=fam.get("forced"), kernels=fam.get("kernels"),
        peak_device_bytes=fam["peak_device_bytes"],
        peak_host_bytes=fam["peak_host_bytes"],
        busy_share=(prof["busy_ms"] / prof["wall_ms"]
                    if prof["busy_ms"] is not None else None))


def scale_record(scale: dict, big: dict) -> dict:
    """probe_search's kernel record: the skewed scale DB's numbers (the
    DB the port's ladder sends to the binary search), the other DBs' and
    the 1.09e9-key table's (``past_2e30``) beside them."""
    label = "skewed" if "skewed" in scale else next(iter(scale))
    rec = dict(name="probe_search", route="cuda",
               source="close_kmers_tpu_torch/csrc/probe_search.cu",
               replaces="close_kmers_tpu/core/engine.py:603",
               db=label, **scale[label]["probe_search"])
    rec.update({k: v["probe_search"] for k, v in scale.items()
                if k != label}, past_2e30=big)
    return rec


def scale_only(host, T, wrappers, args, params, device, kind: str,
               card: str, t_start: float) -> int:
    """``--scale-only``: the scale phase alone on the DBs named (with
    ``deep``, the deep DBs' tier sweeps before it), then its kernel
    record, the nvidia-smi line and the device line."""
    import torch
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    if "deep" in args.scale_only:
        deep_sweeps(T, GX, device, {"binary_search": T.DeviceDB.from_db(
            GX.deep_db(), device)})
        torch.cuda.empty_cache()
    scale, big, counts = run_scale(host, T, wrappers, args.scale_keys,
                                   args.scale_only, params, device, card)
    log(f"scale phase passed in {time.time() - t_start:.1f} s: "
        + json.dumps({k: dict(stats=v["stats"], card_tier=v["card_tier"],
                              jax_tier=v["jax_tier"],
                              e2e={t: round(r) for t, r in v["e2e"].items()
                                   if t != "passes"},
                              family=family_summary(v["family"]))
                      for k, v in scale.items()}))
    print(json.dumps({"kernels": [dict(scale_record(scale, big),
                                       launches=counts["probe_search"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the family and routed budgets' sweeps (--budgets): rows a chunk and
# chunks in flight of best_family_matches_padded, and the routed probe's
# capacity factor (None: a device's full window count, drop-free)
FAMILY_CHUNK_ROWS = (4096, 8192, 16384, 65536)
FAMILY_IN_FLIGHT = (2, 4, 8)
CAPACITY_FACTORS = (2.0, 4.0, 8.0, None)


def chunk_sweep(eng, mapping, offsets, lengths, card: str, label: str,
                rounds: int = 3) -> dict:
    """All proteins through :func:`family_pass` at each FAMILY_CHUNK_ROWS
    x FAMILY_IN_FLIGHT setting (the engine's ``_chunk_rows`` and
    FAMILY_MATCH_GROUP set on the instance), in turns, the order reversed
    every other round, after a pass of each.  Returns {"rows x in
    flight": [seconds]} and the engine's own setting."""
    import torch
    own = (eng._chunk_rows(len(offsets), offsets.shape[1]),
           eng.FAMILY_MATCH_GROUP)
    settings = [(r, g) for r in FAMILY_CHUNK_ROWS for g in FAMILY_IN_FLIGHT]

    def run(r, g):
        eng._chunk_rows = lambda B0, L: r
        eng.FAMILY_MATCH_GROUP = g
        try:
            family_pass(eng, mapping, offsets, lengths)
        finally:
            del eng._chunk_rows, eng.FAMILY_MATCH_GROUP

    for r, g in settings:
        run(r, g)
    spent = {f"{r} x {g}": [] for r, g in settings}
    for k in range(rounds):
        for r, g in settings if k % 2 == 0 else settings[::-1]:
            torch.cuda.synchronize()
            t0 = time.time()
            run(r, g)
            torch.cuda.synchronize()
            spent[f"{r} x {g}"].append(time.time() - t0)
    log(f"{label} chunk sweep ({len(offsets)} proteins, the engine's own "
        f"{own[0]} x {own[1]}; median s of {rounds}, interleaved): "
        + json.dumps({k: round(median(v), 4) for k, v in spent.items()})
        + f"; passes {json.dumps(spent)}; {card}")
    return dict(own=f"{own[0]} x {own[1]}", passes=spent)


def family_budgets(T, TF, eng, mapping, offsets, lengths, params, flush,
                   card: str, label: str) -> dict:
    """famwide against two-gather on one DB: both scorers (forced, the
    engine's table shared), all proteins through :func:`family_pass` in
    eleven interleaved rounds, the packs equal on every chunk, the
    kernels by launch (:func:`family_kernel_turns`); then the chunk sweep
    on the two-gather path."""
    import torch
    dev = flush.device
    t0 = time.time()
    paths = {name: TF.DeviceFamilyScorer(eng.db, mapping, dev,
                                         ddb=eng.fa.ddb, famwide=fw)
             for name, fw in (("famwide", True), ("two-gather", False))}
    torch.cuda.synchronize()
    check(paths["famwide"].famwide is not None,
          f"{label}: no famwide rows")
    log(f"{label} budgets: both family scorers built in "
        f"{time.time() - t0:.1f} s (famwide rows "
        f"{tuple(paths['famwide'].famwide.shape)})")
    spent, _ = family_rounds(eng, mapping, paths, offsets, lengths,
                             rounds=11)
    log(f"{label} budgets: famwide against two-gather end to end "
        f"({len(offsets)} proteins, median s of 11, interleaved): "
        + json.dumps({k: round(median(v), 4) for k, v in spent.items()})
        + f"; passes {json.dumps(spent)}; {card}")
    fused = packs_equal(TF, paths, offsets, lengths, params, label)
    off_d = torch.from_numpy(offsets[:BATCH]).to(dev)
    len_d = torch.from_numpy(lengths[:BATCH]).to(dev)
    turns = family_kernel_turns(T, paths["famwide"], paths["two-gather"],
                                off_d, len_d, flush, f"{label} budgets")
    use_scorer(eng, mapping, paths["two-gather"])
    sweep = chunk_sweep(eng, mapping, offsets, lengths, card, label)
    eng._family_scorers.pop(mapping, None)
    del paths
    torch.cuda.empty_cache()
    return dict(e2e=spent, fused_s=fused, kernels=turns, chunks=sweep)


def sharded_budgets(SH, db, offsets, lengths, params, dev, card: str,
                    label: str) -> dict:
    """The routed and per-shard budgets on one DB over mesh (1, 4) on
    [cuda:0] * 4, all proteins in BATCH chunks through serve_step_sharded
    (no family rows): the card's layout (every shard on the binary
    search) against the JAX module's per-shard layouts where they differ,
    replicated and routed drop-free, in interleaved rounds, the best
    packs equal; then on the card's layout the routed step at each of
    CAPACITY_FACTORS: its dropped windows and seconds a pass.  ``dev``:
    the one device of the four entries."""
    import torch
    mesh = SH.make_mesh(1, 4, devices=[dev] * 4)
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, len(offsets), BATCH)]
    t0 = time.time()
    sdbs = {"card": SH.ShardedDB.from_db(db, mesh)}
    jx = SH.ShardedDB.from_db(db, mesh, jax_layouts=True)
    tiers = {k: sorted({d.tier for d in v.local.values()})
             for k, v in (("card", sdbs["card"]), ("jax", jx))}
    if tiers["jax"] != tiers["card"]:
        sdbs["jax"] = jx
    del jx
    torch.cuda.synchronize()
    log(f"{label} sharded budgets: shards built in {time.time() - t0:.1f} s;"
        f" per-shard tiers {json.dumps(tiers)}")

    def step(sdb, routed, cf):
        def run():
            out = [SH.serve_step_sharded(sdb, o, n, params=params,
                                         routed=routed, capacity_factor=cf)
                   for o, n in chunks]
            return ([b.cpu() for b, _, _ in out],
                    sum(int(d.sum()) for _, _, d in out))
        return run

    want, _ = step(sdbs["card"], False, None)()
    runs = {f"{k} {mode}": step(v, mode == "routed", None)
            for k, v in sdbs.items() for mode in ("replicated", "routed")}
    runs.update({f"card routed cf {cf}": step(sdbs["card"], True, cf)
                 for cf in CAPACITY_FACTORS if cf is not None})
    drops = {}
    for name, fn in runs.items():
        got, drops[name] = fn()
        if not drops[name]:
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{label}: {name} best packs differ")
    names = list(runs)
    spent = {k: [] for k in names}
    for r in range(3):
        for name in names if r % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.time()
            runs[name]()
            torch.cuda.synchronize()
            spent[name].append(time.time() - t0)
    log(f"{label} sharded budgets ({len(offsets)} proteins, mesh (1, 4) on "
        f"card 0; median s of 3, interleaved): "
        + json.dumps({k: round(median(v), 4) for k, v in spent.items()})
        + f"; windows dropped a pass {json.dumps(drops)}; passes "
        f"{json.dumps(spent)}; {card}")
    del sdbs, runs
    torch.cuda.empty_cache()
    return dict(tiers=tiers, passes=spent, drops=drops)


def budgets(host, T, TF, params, device, kind: str, card: str,
            t_start: float) -> int:
    """``--budgets``: the measurements the family and routed budgets rest
    on, alone.  The query cell (bench.py's corpus and family universe)
    and the uniform scale DB with its scale_mapping: famwide against
    two-gather end to end and by kernel, and the chunk sweep
    (:func:`family_budgets`); the query DB, the deep DB and the skewed
    scale DB: the per-shard tiers and the capacity sweep
    (:func:`sharded_budgets`).  Prints one JSON record of it all, the
    nvidia-smi line and the device line."""
    import torch
    from close_kmers_tpu_torch.core.api import KmerEngine
    from close_kmers_tpu_torch.parallel import sharding as SH
    from close_kmers_tpu_torch.scripts import gather_exp as GX
    from close_kmers_tpu_torch.scripts.make_scale_db import (scale_db,
                                                             scale_mapping)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    out = {}
    db, offsets, lengths, src_rng = build_corpus(host)
    dbf, mapping = make_family_universe(host, db, src_rng)
    eng = KmerEngine(dbf, device)
    out["query family"] = family_budgets(T, TF, eng, mapping, offsets,
                                         lengths, params, flush, card,
                                         "query cell")
    del eng, mapping
    dev0 = torch.device("cuda", 0)
    out["query sharded"] = sharded_budgets(SH, dbf, offsets, lengths, params,
                                           dev0, card, "query DB")
    del db, dbf
    db_deep = GX.deep_db()
    d_off, d_len = spelled_queries(db_deep, N_QUERY, np.random.default_rng(5))
    out["deep sharded"] = sharded_budgets(SH, db_deep, d_off, d_len, params,
                                          dev0, card, "deep DB")
    del db_deep
    for label, aa_bias, seed in SCALE_DBS:
        db = scale_db(SCALE_KEYS, aa_bias=aa_bias, seed=seed, device=device)
        s_off, s_len = scale_spelled(db, N_QUERY, seed)
        if label == "uniform":
            eng = KmerEngine(db, device)
            out["uniform family"] = family_budgets(
                T, TF, eng, scale_mapping(db), s_off, s_len, params, flush,
                card, "uniform 210M")
            del eng
        else:
            out[f"{label} sharded"] = sharded_budgets(
                SH, db, s_off, s_len, params, dev0, card, f"{label} 210M")
        del db
        torch.cuda.empty_cache()
    log(f"budgets measured in {time.time() - t_start:.1f} s")
    print(json.dumps({"budgets": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tier_e2e(args, kind: str) -> int:
    """``--tier-e2e N``: the query DB's end-to-end rates on the
    payload_wide and binary-search tiers (forced by the JAX flags, which
    every tree of the port takes) and on from_db's own pick, N rounds in
    turns, the order reversed every other round: 65,536 proteins through
    best_batch_packed (the device pack, to arrays) and through the slim
    pack + native best-call, the 5-Mbp genome through
    GenomeAnnotator.calls_of, and the 2,048-protein /matrix request
    through DeviceMatrix.count_pairs.  Every reading is printed; the
    tiers' packs, genome calls and matrix pairs must be equal.  With
    ``--port-root DIR`` the port is imported from DIR (e.g. the parent
    commit unpacked by git archive), so that two trees' rates can be read
    in turns, one process each."""
    import copy
    import torch
    root = os.path.abspath(args.port_root or REPO)
    sys.path.insert(0, root)
    from close_kmers_tpu_torch import params as P
    from close_kmers_tpu_torch.core import engine as T
    from close_kmers_tpu_torch.core import genome as TG
    from close_kmers_tpu_torch.core import matrix as TM
    from close_kmers_tpu_torch.core.device_score import DeviceScorer
    from close_kmers_tpu_torch.db import signature_db
    from close_kmers_tpu_torch.native import api as native
    from close_kmers_tpu_torch.ops import _build, encoder, translate
    from close_kmers_tpu_torch.utils.device import (
        gpu_name_and_power_limit, resolve_device)
    check(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(T.__file__)))) == root, f"the port was imported from {T.__file__}, not {root}")
    host = types.SimpleNamespace(SignatureDB=signature_db.SignatureDB,
                                 encoder=encoder, native=native,
                                 translate=translate)
    card = gpu_name_and_power_limit()
    device = resolve_device("cuda")
    t0 = time.time()
    _build.build(force=True)
    db, offsets, lengths, src_rng = build_corpus(host)
    params = P.EngineParams()
    forced = {"payload_wide": dict(wide=True, wide_payload=True),
              "binary_search": dict(wide=False, fused=False, sub=False,
                                    wide_lo=False)}
    base = DeviceScorer(db, device)
    auto = base.ddb.tier
    scorers = {}
    for tier, flags in forced.items():
        scorers[tier] = copy.copy(base)
        scorers[tier].ddb = (base.ddb if tier == auto else
                             T.DeviceDB.from_db(db, device, **flags))
        check(scorers[tier].ddb.tier == tier, f"{tier} built "
              f"{scorers[tier].ddb.tier}")
    check(auto in scorers, f"from_db picked {auto}")
    genome = synth_genome(np.random.default_rng(4), offsets[:, :PROT_LEN],
                          GENOME_BASES)
    digits = translate._DNA_CHAR[translate._to_bytes(genome)]
    offs, vals, rank = matrix_csr(db, src_rng)
    off_m, len_m = offsets[:MATRIX_P], lengths[:MATRIX_P]
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, N_QUERY, BATCH)]
    slim = base.slim_mode()
    unpack = {2: base.unpack_dense2, 3: base.unpack_dense3}[slim]

    def best(ds):
        return [ds.best_batch_packed(o, n, params).cpu().numpy()
                for o, n in chunks]

    def slim_native(ds):
        out = []
        for o, n in chunks:
            cap = 2
            while True:
                pk, cap_n = ds.score_batch_packed(o, n, params,
                                                  calls_per_seq_cap=cap,
                                                  slim=slim)
                dense = unpack(pk.cpu().numpy(), len(o), cap_n)
                if dense is not None:
                    break
                cap *= 4
            n_calls, cc, cf, cw = dense
            out.append(native.best_call_batch(n_calls, None, None, cc, cf,
                                              cw))
        return out

    progs = {}
    for tier, ds in scorers.items():
        ga, dm = TG.GenomeAnnotator(ds), TM.DeviceMatrix(ds, max_deg=3)
        po, pv = dm.stage_csr(offs, vals)
        progs[tier] = dict(
            best=lambda ds=ds: best(ds),
            slim_native=lambda ds=ds: slim_native(ds),
            genome=lambda ga=ga: ga.calls_of(digits, params),
            matrix=lambda dm=dm, po=po, pv=pv: dm.count_pairs(
                off_m, len_m, po, pv, rank))
    work = {"best": N_QUERY, "slim_native": N_QUERY,
            "genome": len(genome) / 1e6, "matrix": MATRIX_P}
    outs = {tier: {k: fn() for k, fn in p.items()}       # warm-up, kept
            for tier, p in progs.items()}
    a, b = (outs[t] for t in forced)
    check(all(np.array_equal(x, y) for x, y in zip(a["best"], b["best"])),
          "tier e2e: the tiers' best packs differ")
    check(all(all(np.array_equal(x, y) for x, y in zip(u, v))
              for u, v in zip(a["slim_native"], b["slim_native"])),
          "tier e2e: the tiers' native best calls differ")
    check(np.array_equal(a["genome"][0], b["genome"][0])
          and a["genome"][1] == b["genome"][1],
          "tier e2e: the tiers' genome calls differ")
    check(a["matrix"] == b["matrix"], "tier e2e: the tiers' matrix pairs "
          "differ")
    del outs, a, b
    log(f"tier e2e: {root}: {len(db):,} keys, from_db picks {auto}; "
        f"set-up {time.time() - t0:.1f} s; every tier's packs, best calls, "
        f"genome calls and matrix pairs equal")
    spent = {t: {k: [] for k in work} for t in progs}
    order = list(progs)
    for r in range(args.tier_e2e):
        for tier in (order if r % 2 == 0 else order[::-1]):
            for k, fn in progs[tier].items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                spent[tier][k].append(time.perf_counter() - t1)
    rates = {t: {k: [work[k] / s for s in v] for k, v in d.items()}
             for t, d in spent.items()}
    medians = {t: {k: float(np.median(v)) for k, v in d.items()}
               for t, d in rates.items()}
    profiles = {t: {k: device_share(progs[t][k]) for k in ("genome",
                                                           "matrix")}
                for t in progs}
    log(f"tier e2e: every reading (best and slim_native proteins/s, genome "
        f"Mbp/s, matrix proteins/s), {args.tier_e2e} rounds in turns: "
        f"{json.dumps(rates)}")
    log(f"tier e2e: one genome pass and one matrix request profiled: "
        f"{json.dumps(profiles)}")
    print(json.dumps({"tier_e2e": dict(root=root, auto=auto,
                                       medians=medians)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def parse_args(argv: list[str]):
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke run of the torch port on one NVIDIA card.")
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="a tree (e.g. the parent commit unpacked by git "
                         "archive) whose best_call kernel and wrapper "
                         "phase 2 times in turns with this tree's, and "
                         "whose probe_search kernel every probe_search "
                         "timing (phase 2, the scale phase, the 1.09e9-key "
                         "table) runs in turns with this tree's")
    ap.add_argument("--scale-keys", type=int, default=SCALE_KEYS,
                    help="keys of each scale-phase DB (default "
                         f"{SCALE_KEYS:,})")
    ap.add_argument("--sweep-cap", type=float, default=SWEEP_MAX_BYTES / 2**30,
                    metavar="GB", help="the largest tables a tier sweep "
                    "builds beside the gates' picks (default "
                    f"{SWEEP_MAX_BYTES / 2**30:g} GB)")
    ap.add_argument("--scale-only", default=None, metavar="DBS",
                    help="run phase 1 and the scale phase alone, on the "
                         "comma-separated scale DBs named (uniform, "
                         "skewed), and with deep the deep DBs' tier "
                         "sweeps first")
    ap.add_argument("--tier-e2e", type=int, default=None, metavar="ROUNDS",
                    help="run the query DB's end-to-end rates on its tiers "
                         "alone, ROUNDS rounds in turns (see tier_e2e)")
    ap.add_argument("--port-root", default=None, metavar="DIR",
                    help="with --tier-e2e: import the port from DIR")
    ap.add_argument("--budgets", action="store_true",
                    help="run phase 1 and the family and routed budgets' "
                         "measurements alone (see budgets)")
    ap.add_argument("--fuzz-rounds", type=int, default=FUZZ_ROUNDS,
                    metavar="N", help="rounds of the fuzz phase (default "
                    f"{FUZZ_ROUNDS}; 0 leaves the phase out)")
    ap.add_argument("--gather-exp", default=None, metavar="NAMES",
                    help="run phase 1 and the comma-separated gather_exp "
                         "experiments (or all) with gather_scale_exp "
                         "alone; by default the main path runs every "
                         "experiment but the scale family and gsort15m")
    args = ap.parse_args(argv)
    if args.port_root is not None and args.tier_e2e is None:
        ap.error("--port-root goes with --tier-e2e")
    if any("=" not in v for v in args.compare):
        ap.error("--compare takes LABEL=DIR")
    names = ["deep"] + [label for label, _, _ in SCALE_DBS]
    if args.scale_only is not None:
        args.scale_only = args.scale_only.split(",")
        if (not set(args.scale_only) <= set(names)
                or set(args.scale_only) <= {"deep"}):
            ap.error(f"--scale-only names DBs of {names}, a scale DB "
                     f"among them")
    return args


def main(argv: list[str]) -> int:
    """``argv``: see :func:`parse_args`."""
    global SWEEP_MAX_BYTES
    args = parse_args(argv)
    trees = dict(v.split("=", 1) for v in args.compare)
    SWEEP_MAX_BYTES = int(args.sweep_cap * 2**30)
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.tier_e2e is not None:
        return tier_e2e(args, torch.cuda.get_device_name(0))
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
        from close_kmers_tpu_torch.ops.probe_search import probe_search
        from close_kmers_tpu_torch.ops.probe_select import (famwide_select,
                                                            probe_select)
        from close_kmers_tpu_torch.ops.row_gather import row_gather
        from close_kmers_tpu_torch.ops.scan_score import scan_score
        from close_kmers_tpu_torch.scripts import gather_exp as GX
        from close_kmers_tpu_torch.scripts import gather_scale_exp as GS
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
                "dmaflush": gx.dmaflush, "best_call": best_call,
                "probe_search": probe_search}

    # -- phase 1: device and build
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")
    t0 = time.time()
    _build.build(force=True, verbose=True)
    log(f"phase 1: nvcc built {_build.LIB} in {time.time() - t0:.1f} s; "
        f"probe_search's kernels (template arguments: registers, spill "
        f"bytes): {json.dumps(search_registers(_build.ptxas_report))}")
    SEARCH_TREES.update({k: kernel_tree(v, k, "probe_search")
                         for k, v in trees.items()})
    params = host.EngineParams()
    if args.budgets:
        return budgets(host, T, TF, params, device, kind, card, t_start)
    if args.scale_only is not None:
        return scale_only(host, T, wrappers, args, params, device, kind,
                          card, t_start)
    if args.gather_exp is not None:
        return gather_exp_only(args, device, kind, card, t_start)

    # -- set-up: the real-size DBs, family universe and queries (host)
    t0 = time.time()
    db, offsets, lengths, src_rng = build_corpus(host)
    dbf, mapping = make_family_universe(host, db, src_rng)
    log(f"set-up: corpus + DB of {len(db):,} kmers (max bucket "
        f"{db.max_bucket}) and {len(mapping.families):,} families built "
        f"on the host in {time.time() - t0:.1f} s")
    t0 = time.time()
    ds = DeviceScorer(db, device)
    eng = KmerEngine(dbf, device)
    torch.cuda.synchronize()
    check(ds.ddb.tier == eng.fa.ddb.tier == T.card_tier(db),
          f"the query DB took the {ds.ddb.tier} tier")
    log(f"set-up: two {ds.ddb.tier} tables of {ds.ddb.table_bytes()} B "
        f"built and uploaded in {time.time() - t0:.1f} s")
    t0 = time.time()
    dfs = eng._device_family_scorer(mapping)
    torch.cuda.synchronize()
    check(dfs is not None, "no device family scorer for the full-width "
          "corpus")
    # the other path's scorer beside the engine's: famwide rows forced
    # where the card gate takes the two gathers, and the other way round
    other = TF.DeviceFamilyScorer(dbf, mapping, device, ddb=eng.fa.ddb,
                                  famwide=dfs.famwide is None)
    dfs_fw, dfs_tg = (dfs, other) if dfs.famwide is not None \
        else (other, dfs)
    torch.cuda.synchronize()
    log(f"set-up: family table {tuple(dfs.fdb.fam.shape)} (the engine's "
        f"path: {'famwide' if dfs is dfs_fw else 'two-gather'}, "
        f"{json.dumps({k: round(v, 2) for k, v in dfs.build_seconds.items()})}"
        f" s) and famwide rows {tuple(dfs_fw.famwide.shape)} "
        f"(W={dfs_fw.fam_w}, D={dfs_fw.fam_d}) built and uploaded in "
        f"{time.time() - t0:.1f} s")
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
    check(ds_deep.ddb.tier == eng_deep.fa.ddb.tier == T.card_tier(db_deep),
          f"the deep DB took the {ds_deep.ddb.tier} tier")
    log(f"set-up: two {ds_deep.ddb.tier} tables of "
        f"{ds_deep.ddb.table_bytes()} B (n_steps {ds_deep.ddb.n_steps}) "
        f"built and uploaded in {time.time() - t0:.1f} s")
    t0 = time.time()
    genome = synth_genome(np.random.default_rng(4), offsets[:, :PROT_LEN],
                          GENOME_BASES)
    g_digits, g_n = TG.bucketed_digits(genome)
    log(f"set-up: genome of {len(genome):,} bp (scripts/dna_bench.py "
        f"synth_genome, seed 4) in {time.time() - t0:.1f} s")

    # -- phase 2: kernels against their plain versions, tiers against the
    # auto-ladder's probe
    off_d = torch.from_numpy(offsets[:BATCH]).to(device)
    len_d = torch.from_numpy(lengths[:BATCH]).to(device)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    d_off_b = torch.from_numpy(d_off[:BATCH]).to(device)
    d_len_b = torch.from_numpy(d_len[:BATCH]).to(device)
    compare = {k: kernel_tree(v, k, "best_call") for k, v in trees.items()}
    # probe_select's tiers, built by name: the query DB's payload-wide
    # rows and the deep DB's sub blocks
    pw = T.DeviceDB.from_numpy(T.tier_tables(db, "payload_wide"), device,
                               copy=False)
    sub_deep = T.DeviceDB.from_numpy(T.tier_tables(db_deep, "sub_blocks"),
                                     device, copy=False)
    kernels = phase_kernels(
        T, pw, off_d, len_d, params, flush,
        scan_calls(T, S, ds_deep.ddb, d_off_b, d_len_b, params), compare)
    del pw
    reads, n_orfs, fq_chunk = make_reads(host, eng, offsets)
    kernels.update(phase_family_kernels(T, TF, dfs_fw, off_d, len_d,
                                        fq_chunk, flush))
    kernels["famwide_select"]["turns"] = family_kernel_turns(
        T, dfs_fw, dfs_tg, off_d, len_d, flush, "query cell family")
    kernels["probe_select"]["sub_blocks"] = phase_sub_select(
        T, sub_deep, d_off_b, d_len_b, flush)
    # probe_search at the main path's shapes: the query cell, the deep
    # cell, the genome's tile windows, one matrix chunk
    search_recs = {
        label: time_search(d.ddb, tuple(x.reshape(-1) for x in
                                        T.encode_windows(o, n)),
                           flush, f"the {label} cell's windows",
                           decompose=label == "query")[1]
        for label, d, o, n in (("query", ds, off_d, len_d),
                               ("deep", ds_deep, d_off_b, d_len_b))}
    search_recs["genome"], kernels["scan_score"]["genome"] = \
        phase_genome_kernels(T, TG, S, eng.fa.ddb,
                             torch.from_numpy(g_digits).to(device), g_n,
                             params, flush)
    m_hi, m_lo, m_valid = T.encode_windows(
        torch.from_numpy(offsets[:MATRIX_P]).to(device),
        torch.from_numpy(lengths[:MATRIX_P]).to(device))
    search_recs["matrix"] = time_search(
        eng.fa.ddb, (m_hi.reshape(-1), m_lo.reshape(-1), m_valid.reshape(-1)),
        flush, "one matrix chunk's windows")[1]
    del m_hi, m_lo, m_valid
    del flush
    kernels.update(phase_gather_kernels(device))
    kernels["probe_select"]["probepal"] = probepal_parity(device)
    log(f"phase 2: all {len(kernels) + 1} kernels equal their plain versions "
        f"(probe_search's scale-DB record comes with the scale phase)")
    tiers = phase_tiers(T, db, ds.ddb, off_d, len_d)
    log(f"phase 2: all {len(tiers)} tier probes equal the {ds.ddb.tier} "
        f"probe")
    deep_tiers = deep_sweeps(T, GX, device, {"binary_search": ds_deep.ddb,
                                             "sub_blocks": sub_deep})
    del sub_deep
    log(f"phase 2: tier sweeps of {len(deep_tiers)} deep DBs: every tier "
        f"built equals the binary search")

    # -- the main path, counted (and its peak device memory)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- phase 3: golden server on the card
    phase_golden(device)
    log("phase 3: golden conversations byte-identical on the card")
    phase_kser_profile()

    # -- phase 4: real size
    rate_ds, rate_eng, best_q = phase_query(host, T, ds, eng, db, offsets,
                                            lengths, params, "query", card)
    n_over = phase_overflow(host, T, ds, db, offsets, lengths, params)
    phase_tpu_engine(host, T, TFam, db, dbf, mapping, offsets, lengths,
                     params, device)
    rate_fam, _spent = phase_family(TF, eng, mapping, other, offsets,
                                    lengths, params, card)
    rate_reads, rate_orfs = phase_reads(eng, mapping, reads, n_orfs, params)
    gen = phase_genome(host, T, TG, eng, db, genome, params)
    mat = phase_matrix(host, TM, eng, db, offsets, lengths, src_rng)
    deep_probe, deep_tier = probe_kernel(ds_deep.ddb), ds_deep.ddb.tier
    before = deep_probe.launches
    rate_deep, rate_deep_eng, best_d = phase_query(
        host, T, ds_deep, eng_deep, db_deep, d_off, d_len, params, "deep",
        card)
    deep_launches = deep_probe.launches - before
    exp_names = gather_exp_names(None)
    log(f"phase 4: gather_exp experiments ({', '.join(exp_names)})")
    before = probe_select.launches
    exp = GX.run(exp_names, device, deep=db_deep)
    gx_select = probe_select.launches - before
    kernels["probe_select"]["probepal"]["ms"] = exp["probepal"] * 1e3
    log("phase 4: gather_scale_exp")
    gscale = GS.run(device)
    kept = phase_build_db()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4: peak device memory {peak} B ({peak / 2**30:.2f} GiB)")

    # -- the sharded serving path, its counts set to 0 just before it and
    # read just after
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    shard = phase_sharded(TF, ds, eng, dfs, dbf, offsets, lengths, params,
                          ds_deep, db_deep, d_off, d_len, wrappers, card)
    phase_sharded_golden()
    shard_peak = torch.cuda.max_memory_allocated()
    shard_counts = {name: fn.launches for name, fn in wrappers.items()}
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

    # -- the scale path, its counts set to 0 just before it and read just
    # after
    del ds, eng, dfs, dfs_fw, dfs_tg, other, mapping
    torch.cuda.empty_cache()
    scale, big, scale_counts = run_scale(
        host, T, wrappers, args.scale_keys,
        [label for label, _, _ in SCALE_DBS], params, device, card)
    kernels["probe_search"] = dict(scale_record(scale, big), **search_recs)

    # -- the fuzz phase, its counts set to 0 just before it and read just
    # after
    fuzz = (phase_fuzz(wrappers, args.fuzz_rounds, device, card)
            if args.fuzz_rounds > 0 else None)
    fuzz_counts = fuzz["counts"] if fuzz else dict.fromkeys(wrappers, 0)

    # -- phase 5: the main path went through every kernel
    log(f"phase 5: launches on the main path: {launches}, probe_select "
        f"among them {gx_select} by gather_exp's deepcmp (deep_sub, the "
        f"deep DB's sub blocks forced by the JAX flags) and probepal, and "
        f"none on /query, "
        f"the genome or /matrix (the binary search); "
        f"{deep_probe.__name__} on the deep DB's {deep_tier} path: "
        f"{deep_launches}; on the genome path (one genome) "
        f"{gen['probe']} {gen['launches'][0]}, scan_score "
        f"{gen['launches'][1]}; on the matrix path (one request) "
        f"{mat['probe']} {mat['launches']}; best_call a 65,536-protein pass "
        f"{best_q['launches']} (query), {best_d['launches']} (deep)")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    check(deep_launches > 0, f"{deep_probe.__name__} never ran on the deep "
          f"DB's path")
    check(min(gen["launches"]) > 0 and mat["launches"] > 0,
          "the genome or matrix path missed a kernel")
    log(f"all phases passed in {time.time() - t_start:.1f} s; "
        f"DeviceScorer {rate_ds:.0f} proteins/s, KmerEngine {rate_eng:.0f} "
        f"proteins/s, family best-match {rate_fam:.0f} proteins/s, "
        f"/fq_lookup {rate_reads:.0f} reads/s ({rate_orfs:.0f} ORF "
        f"proteins/s), genome {gen['mbp_s']:.2f} Mbp/s ({gen['rounds']} "
        f"fixpoint rounds), matrix {mat['proteins_s']:.0f} proteins/s, "
        f"deep DB ({deep_tier}) DeviceScorer {rate_deep:.0f} / "
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
        f" ({shard['nccl']} one-rank group equal); gather_scale_exp: "
        f"the prefilter {'pays' if gscale['pays'] else 'does not pay'} at 8% "
        f"(filtered {gscale['filtered'] * 1e3:.2f} + bitmap "
        f"{gscale['bitmap'] * 1e3:.2f} ms against payload "
        f"{gscale['payload'] * 1e3:.2f}); fuzz "
        + (f"{fuzz['rounds']} rounds in {fuzz['seconds']:.1f} s"
           if fuzz else "left out") + "; scale DBs "
        f"{json.dumps({k: dict(keys=v['keys'], card_tier=v['card_tier'], jax_tier=v['jax_tier'], proteins_s={t: round(r) for t, r in v['e2e'].items() if t != 'passes'}, family_proteins_s={t: round(r) for t, r in v['family']['rates'].items()}) for k, v in scale.items()})}"
        f"; peak {peak} B on {card}")

    # launches: the main path's own; the sharded and scale paths' beside
    records = [dict(kernels[k], launches=launches[k],
                    sharded_launches=shard_counts[k],
                    scale_launches=scale_counts[k],
                    fuzz_launches=fuzz_counts[k]) for k in wrappers]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
