"""Dry run of the sharded serving step on a mesh of devices, torch port
of ``__graft_entry__.dryrun_multichip``.

    python -m close_kmers_tpu_torch.parallel.dryrun [N]

builds an N-entry ("data", "table") mesh over the first N cards (default:
every card), a tiny DB and family table, and runs one routed and one
replicated serving step.  Where JAX falls back to virtual CPU devices
when it finds too few, this raises: a CPU mesh is asked for by passing
its devices.
"""

from __future__ import annotations

import sys

import numpy as np


# Copied from __graft_entry__.py::_tiny_db (numpy).
def _tiny_db(n_kmers=512, n_funcs=16, seed=0):
    from ..db.signature_db import SignatureDB
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 20 ** 8, size=n_kmers * 2,
                                  dtype=np.int64))[:n_kmers]
    return SignatureDB(
        keys,
        rng.integers(0, n_funcs, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
    )


# Copied from __graft_entry__.py::_tiny_batch (numpy).
def _tiny_batch(rng, B, L):
    offsets = rng.integers(0, 20, size=(B, L), dtype=np.int64).astype(
        np.uint8)
    lengths = np.full(B, L - 1, dtype=np.int32)
    return offsets, lengths


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one full sharded serving step, routed and replicated, on an
    ``n_devices``-entry mesh (2 x n/2 when n is even, else 1 x n) over
    ``devices`` (default: the first n_devices cards; raises when the
    machine has fewer)."""
    from .sharding import (ShardedDB, make_mesh, serve_step_sharded,
                           shard_fam_table)
    if devices is not None and len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for a mesh of "
                         f"{n_devices}")
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_data, n_devices // n_data, devices=devices)

    db = _tiny_db()
    sdb = ShardedDB.from_db(db, mesh)
    # a tiny kmer->family table, so that the step includes the family
    # rollup (row gather + psum merge + grouping)
    fam_np = np.full((len(db) + 1, 2), -1, dtype=np.int32)
    fam_np[:len(db), 0] = db.fi
    fam_np[: len(db) // 2, 1] = db.fi[: len(db) // 2] + 1
    fam_sh = shard_fam_table(fam_np, sdb)
    rng = np.random.default_rng(2)

    # 1) the ROUTED serving step, at the drop-free capacity (the tiny
    #    random queries' hi distribution is skewed against the shards)
    B = 2 * n_devices
    offsets, lengths = _tiny_batch(rng, B, 64)
    best, _n_ovf, n_drop, fam_rows = serve_step_sharded(
        sdb, offsets, lengths, fam_shards=fam_sh, cap_seq=64, routed=True,
        capacity_factor=None)
    if best.shape != (B, 9) or fam_rows.shape != (B, 1 + 4 * 64):
        raise AssertionError(f"routed step shapes {tuple(best.shape)}, "
                             f"{tuple(fam_rows.shape)}")
    if int(n_drop.sum()):
        raise AssertionError("the drop-free routed step dropped windows")

    # 2) the replicated-probe serving step
    offsets, lengths = _tiny_batch(rng, 2 * n_data, 64)
    best, _n_ovf, _n_drop, fam_rows = serve_step_sharded(
        sdb, offsets, lengths, fam_shards=fam_sh, cap_seq=64,
        routed=False)
    if best.shape != (2 * n_data, 9) \
            or fam_rows.shape != (2 * n_data, 1 + 4 * 64):
        raise AssertionError(f"replicated step shapes {tuple(best.shape)},"
                             f" {tuple(fam_rows.shape)}")


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun ok on {n} card(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
