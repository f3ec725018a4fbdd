"""One rank of a multi-process run of the sharded serving step, torch
port of ``scripts/multiproc_worker.py``.

    python -m close_kmers_tpu_torch.scripts.multiproc_worker \\
        <rank> <world> <port> [--n-data N] [--midsize]

Each process joins a gloo process group of ``world`` ranks on the CPU
(rendezvous at 127.0.0.1:<port>), takes its entry of the (n_data,
world / n_data) mesh, and runs over two DB shapes, a shallow-bucket one
(payload-wide shard rows) and a deep-bucket one (sub-bucket shard
blocks), or with ``--midsize`` over a 10M-key one with uneven hi
occupancy:

* ``probe_sharded`` against the single-device probe (``TpuEngine``);
* ``serve_step_sharded``, replicated and routed, with family rows,
  against the same step on a one-process 1 x 1 mesh (where every
  collective is the identity), so that any divergence of the
  cross-process collectives shows as a byte difference;
* ``probe_routed`` at the default capacity against ``probe_sharded``,
  and the routed ``ShardedEngine.probe_compact`` against the
  single-device compact probe.

Every rank holds the whole of each global output; it checks the whole
array and prints ``rank <r> [<label>/<layout>]: OK``; exit 0 = parity.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def build_db(rng, deep: bool):
    """scripts/multiproc_worker.py's DB shapes: deep = ~60 hi buckets
    over 8k keys (depth ~130, past the wide-row bound: sub-bucket
    blocks), else 30k keys over the whole hi space."""
    from ..db.signature_db import SignatureDB
    from ..params import LO_CARD
    if deep:
        n = 8_000
        his = rng.integers(1_000_000, 1_000_060, size=n, dtype=np.int64)
    else:
        n = 30_000
        his = rng.integers(0, 3_200_000, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=n, dtype=np.int64))
    return SignatureDB(
        keys,
        rng.integers(0, 50, size=len(keys)).astype(np.int32),
        rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
    )


def build_midsize():
    """A 10M-key DB over two disjoint hi ranges (the low one ~4x denser
    per bucket than the high tail): the JAX worker's synthetic mid-size
    shape."""
    from ..db.signature_db import SignatureDB
    from ..params import HI_CARD, LO_CARD
    rng = np.random.default_rng(7)
    lows = rng.integers(0, HI_CARD // 8, size=8_000_000, dtype=np.int64)
    highs = rng.integers(HI_CARD - HI_CARD // 32, HI_CARD,
                         size=2_000_000, dtype=np.int64)
    his = np.concatenate([lows, highs])
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=len(his),
                                    dtype=np.int64))
    return SignatureDB(
        keys,
        rng.integers(0, 500, size=len(keys)).astype(np.int32),
        rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
    )


def family_table(rng, db) -> np.ndarray:
    """A degree-1-3 kmer->family table over the DB's rows, densified as
    DeviceFamilyDB lays it out."""
    from ..core.device_family import DeviceFamilyDB
    from ..db.family_db import KmerFamilyMapping
    n = len(db)
    deg = rng.integers(1, 4, size=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    vals = np.repeat(db.fi * 3, deg) + (np.arange(offs[-1]) % 3) \
        .astype(np.int32)
    mapping = KmerFamilyMapping()
    mapping._fam_csr = (db.keys, offs, vals.astype(np.int32))
    return DeviceFamilyDB._dense_fam(db, mapping)[0]


def _same(a, b) -> bool:
    """Bit-for-bit equality of two tensors or arrays (floats by bits)."""
    a, b = (torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x)
                                       else x)) for x in (a, b))
    if a.dtype == torch.float32:
        a = a.view(torch.int32)
    if b.dtype == torch.float32:
        b = b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def run_case(rank, mesh, mesh_local, db, rng, label: str) -> str:
    from ..core.engine import FastAnnotator, TpuEngine
    from ..ops import encoder as E
    from ..params import EngineParams
    from ..parallel.multihost import addressable_rows, replicate_to_global
    from ..parallel.sharding import (ShardedDB, ShardedEngine, probe_routed,
                                     probe_sharded, serve_step_sharded,
                                     shard_fam_table)

    def expect(cond, what):
        if not cond:
            raise AssertionError(f"rank {rank} [{label}]: {what}")

    keys = db.keys
    B, L = 64, 128
    seqs = []
    for _ in range(B):
        frags = [E.decode_kmer(int(keys[rng.integers(0, len(keys))]))
                 for _ in range(rng.integers(1, 12))]
        seqs.append("".join(frags)[:L - 9])
    fa = FastAnnotator(db, "cpu")
    offsets, lengths = fa.pad_batch(seqs, pad_to=L)
    offsets, lengths = replicate_to_global(mesh, offsets, lengths)
    fam_np = family_table(rng, db)

    t0 = time.time()
    sdb = ShardedDB.from_db(db, mesh)
    fam = shard_fam_table(fam_np, sdb)
    got = probe_sharded(sdb, offsets, lengths)
    t_probe = time.time() - t0
    rf, rfi, roi, rav, rwt = TpuEngine(db, "cpu").probe_padded(offsets,
                                                               lengths)
    want = (rf.astype(np.int32), np.where(rf, rfi, 0), np.where(rf, roi, 0),
            rav, rwt)
    n_checked = 0
    for j, (g, w) in enumerate(zip(got, want)):
        expect(_same(g, w), f"probe plane {j} differs")
        for idx, rows in addressable_rows(mesh, g, "data"):
            expect(_same(rows, w[idx]), f"probe plane {j} rows {idx}")
            n_checked += 1

    sdb1 = ShardedDB.from_db(db, mesh_local)
    fam1 = shard_fam_table(fam_np, sdb1)
    t0 = time.time()
    for routed, params in ((False, EngineParams()),
                           (True, EngineParams(min_hits=3, max_gap=150))):
        out = serve_step_sharded(sdb, offsets, lengths, params=params,
                                 fam_shards=fam, cap_seq=8, routed=routed,
                                 capacity_factor=None)
        ref = serve_step_sharded(sdb1, offsets, lengths, params=params,
                                 fam_shards=fam1, cap_seq=8, routed=routed,
                                 capacity_factor=None)
        for name, j in (("best pack", 0), ("rollup rows", 3)):
            expect(_same(out[j], ref[j]),
                   f"{'routed' if routed else 'replicated'} {name} differs")
            n_checked += 1
        expect(int(out[2].sum()) == 0, "the drop-free step dropped windows")
    t_step = time.time() - t0

    routed = probe_routed(sdb, offsets, lengths)
    for j in range(5):
        expect(_same(routed[j], got[j]), f"routed probe plane {j} differs")
    se = ShardedEngine(db, mesh, routed=True)
    hg = se.probe_compact(offsets, lengths)
    hw = fa.probe_compact(offsets, lengths)
    for k in ("pos", "fi", "oi", "avg_off", "code", "row_off", "wt"):
        expect(_same(hg[k], hw[k]), f"routed probe_compact {k} differs")
    layout = ("sub" if sdb.sub_blocks is not None
              else "wide" if sdb.payload_wide is not None else "bin")
    return (f"rank {rank} [{label}/{layout}]: OK ({n_checked} blocks, "
            f"probe {t_probe:.1f}s, serving steps {t_step:.1f}s)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, world, port = int(argv[0]), int(argv[1]), argv[2]
    n_data = int(argv[argv.index("--n-data") + 1]) \
        if "--n-data" in argv else 1
    from ..parallel import multihost
    from ..parallel.sharding import make_mesh
    multihost.initialize("cpu", f"127.0.0.1:{port}", world, rank)
    try:
        mesh = multihost.pod_mesh("cpu", n_data, world // n_data)
        mesh_local = make_mesh(1, 1, devices=["cpu"])
        if "--midsize" in argv:
            cases = [("midsize", build_midsize(), np.random.default_rng(44))]
        else:
            cases = []
            for label, seed, deep in (("shallow", 42, False),
                                      ("deep", 43, True)):
                rng = np.random.default_rng(seed)
                cases.append((label, build_db(rng, deep), rng))
        for label, db, rng in cases:
            print(run_case(rank, mesh, mesh_local, db, rng, label),
                  flush=True)
        print(f"rank {rank}: OK ({world} ranks, mesh {mesh.shape})",
              flush=True)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
