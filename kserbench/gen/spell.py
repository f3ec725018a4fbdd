# Rewritten from chip_smoke.py at commit 8a7e9d7b116deea5496cfc89e97fd59b7681397e (spelled_queries and scale_spelled: runs of one function's DB kmers, drawn from a random pool of the DB's keys).
"""Runs of one function's DB kmers, from which the traffic spells the
hits of its proteins.

:func:`function_pool` draws a random ``POOL_KEYS`` of the DB's rows
(with replacement) and sorts them by function, as the scale phase's
spelled queries did; :func:`spell` gives each run one function, drawn
uniformly from those in the pool, and its kmers uniformly from that
function's rows."""

from __future__ import annotations

import dataclasses

import numpy as np

POOL_KEYS = 4_000_000


@dataclasses.dataclass
class FunctionPool:
    keys: np.ndarray    # int64: pool keys sorted by function (stable)
    first: np.ndarray   # int64 [F]: each function's first pool row
    count: np.ndarray   # int64 [F]: its pool rows


def function_pool(db, rng) -> FunctionPool:
    rows = np.sort(rng.integers(0, len(db), size=min(POOL_KEYS, len(db))))
    fi = db.fi[rows]
    order = np.argsort(fi, kind="stable")
    fi_sorted = fi[order]
    funcs = np.unique(fi_sorted)
    first = np.searchsorted(fi_sorted, funcs)
    count = np.searchsorted(fi_sorted, funcs, side="right") - first
    return FunctionPool(db.keys[rows[order]], first, count)


def spell(pool: FunctionPool, m: np.ndarray, rng) -> np.ndarray:
    """For runs of ``m`` kmers each, their codes back to back: run r's
    ``m[r]`` kmers all of one function."""
    f = rng.integers(0, len(pool.first), size=len(m))
    f_rep = np.repeat(f, m)
    pick = pool.first[f_rep] + (rng.random(len(f_rep))
                                * pool.count[f_rep]).astype(np.int64)
    return pool.keys[pick]
