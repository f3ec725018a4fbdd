"""The one traffic generator: a traffic file's parameters and the run's
seed in, the pool of request bodies out.

A traffic file (``kserbench/traffic/<name>.json``) states a closed loop
of ``clients`` that each send a request, wait for the whole answer and
send the next.  Each request is a FASTA body of proteins:

* ``request_proteins`` [lo, hi]: proteins a request, uniform;
* ``length`` {median, sigma, min, max}: protein lengths, lognormal,
  clipped;
* ``spelled_share``: the share of proteins that carry a run of one
  function's DB kmers back to back (so that calls form), covering a
  share ``spelled_cover`` [lo, hi] (uniform) of the protein; the other
  residues, and every residue of the other proteins, are drawn at the
  natural amino-acid frequencies;
* ``pool_requests``: requests made; the clients take them in turn and
  start over when they are used up;
* ``warmup_proteins``: the size of each client's one warm-up request
  (client k takes entry min(k, last)).  The first holds the pool's
  longest proteins (their lengths, spelled runs and covers) and one of
  ``length.max``: the widest batch and the heaviest the pool has, so
  that the program's sticky per-batch caps (the family program's calls
  and groups a sequence) reach in set-up what the window needs, for
  every seed alike; the others are drawn like the pool's proteins;
* ``fasta_width``: residues a FASTA line (0: one line a protein).

Every seed gets the same sizes: the request sizes, lengths, spelled
flags and cover shares are drawn from ``shape_seed`` alone; the run's
seed permutes which request and which protein gets which, and draws the
residues and the DB kmers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scale_db import AA_FREQ, ALPHA, K, DBArrays
from .spell import function_pool, spell

POW20 = 20 ** np.arange(K - 1, -1, -1, dtype=np.int64)
# residues at AA_FREQ: a uniform 16-bit draw through this table
AA_TABLE = ALPHA[np.searchsorted(np.cumsum(AA_FREQ)[:-1],
                                 (np.arange(1 << 16) + 0.5) / (1 << 16),
                                 side="right")]


@dataclasses.dataclass
class Request:
    """One request: its proteins (ids and residues) and its body."""
    ids: list
    starts: np.ndarray    # int64 [n]: each protein's offset into residues
    lengths: np.ndarray   # int64 [n]
    body: bytes


@dataclasses.dataclass
class Pool:
    requests: list        # Request, in the order the clients take them
    warmup: list          # Request, one a client
    residues: np.ndarray  # uint8: every protein's letters back to back

    def seq(self, req: Request, i: int) -> bytes:
        a = int(req.starts[i])
        return self.residues[a:a + int(req.lengths[i])].tobytes()


def _shapes(traffic: dict, n_requests: int, rng) -> tuple:
    """Request sizes and, for every protein, (length, spelled, cover)."""
    lo, hi = traffic["request_proteins"]
    sizes = rng.integers(lo, hi + 1, size=n_requests)
    n = int(sizes.sum())
    ln = traffic["length"]
    lengths = np.clip(np.rint(ln["median"] * np.exp(
        ln["sigma"] * rng.standard_normal(n))), ln["min"],
        ln["max"]).astype(np.int64)
    spelled = rng.random(n) < traffic["spelled_share"]
    c0, c1 = traffic["spelled_cover"]
    cover = rng.uniform(c0, c1, size=n)
    return sizes, lengths, spelled, cover


def _lines(residues: np.ndarray, starts, lengths, width: int):
    """Every protein's sequence as FASTA lines of ``width`` residues (one
    line where ``width`` is 0), back to back in one array, and each
    protein's [start, end) in it.  The proteins lie back to back in
    ``residues`` from ``starts``."""
    width = width or int(lengths.max(initial=1))
    n_lines = -(-lengths // width)
    before = np.cumsum(n_lines) - n_lines     # newlines before a protein
    k = np.arange(int(n_lines.sum())) - np.repeat(before, n_lines)
    ends_at = np.repeat(starts, n_lines) + np.minimum(
        (k + 1) * width, np.repeat(lengths, n_lines))
    out = np.insert(residues, ends_at, ord("\n"))
    begins = starts + before
    return out, begins, begins + lengths + n_lines


def _fasta(ids: list, block: bytes, begins, ends) -> bytes:
    return b"".join(b">" + sid.encode() + b"\n" + block[a:b]
                    for sid, a, b in zip(ids, begins.tolist(),
                                         ends.tolist()))


def make_pool(traffic: dict, db: DBArrays, seed: int) -> Pool:
    """The request pool of ``traffic`` over ``db`` for ``seed``."""
    shape_rng = np.random.default_rng(traffic["shape_seed"])
    sizes, lengths, spelled, cover = _shapes(
        traffic, traffic["pool_requests"], shape_rng)
    warm = traffic["warmup_proteins"]
    w_sizes = np.array([warm[min(k, len(warm) - 1)]
                        for k in range(traffic["clients"])])
    n_top = int(w_sizes[0])
    w_len, w_spelled, w_cover = _shapes(
        dict(traffic, request_proteins=[1, 1]), int(w_sizes.sum()),
        shape_rng)[1:]
    top = np.argsort(-lengths, kind="stable")[:n_top]
    w_len[:n_top], w_spelled[:n_top], w_cover[:n_top] = (
        lengths[top], spelled[top], cover[top])
    w_len[0] = traffic["length"]["max"]

    rng = np.random.default_rng([seed, 0x7AFF1C])
    sizes = sizes[rng.permutation(len(sizes))]
    perm = rng.permutation(len(lengths))
    lengths = np.concatenate([lengths[perm], w_len])
    spelled = np.concatenate([spelled[perm], w_spelled])
    cover = np.concatenate([cover[perm], w_cover])
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    total = int(lengths.sum())
    residues = AA_TABLE[rng.integers(0, len(AA_TABLE), size=total,
                                     dtype=np.uint16)]

    # the spelled runs: m back-to-back kmers of one function each, at a
    # random offset inside the protein
    idx = np.nonzero(spelled)[0]
    m = np.maximum(1, (cover[idx] * lengths[idx] / K).astype(np.int64))
    m = np.minimum(m, lengths[idx] // K)
    keep = m > 0
    idx, m = idx[keep], m[keep]
    off = (rng.random(len(idx)) * (lengths[idx] - K * m + 1)).astype(
        np.int64)
    pool = function_pool(db, rng)
    codes = spell(pool, m, rng)
    letters = ALPHA[(codes[:, None] // POW20) % 20].reshape(-1)
    run_start = np.repeat(starts[idx] + off, m * K)
    within = np.arange(int((m * K).sum())) - np.repeat(
        np.cumsum(m * K) - m * K, m * K)
    residues[run_start + within] = letters

    block, begins, ends = _lines(residues, starts, lengths,
                                 traffic["fasta_width"])
    block = block.tobytes()
    requests = []
    first = 0
    for r, n in enumerate(sizes.tolist()):
        ids = [f"fig|{r + 1}.1.peg.{i + 1}" for i in range(n)]
        sl = slice(first, first + n)
        requests.append(Request(ids, starts[sl], lengths[sl], _fasta(
            ids, block, begins[sl], ends[sl])))
        first += n
    warmup = []
    for k, n in enumerate(w_sizes.tolist()):
        ids = [f"warm|{k + 1}.peg.{i + 1}" for i in range(n)]
        sl = slice(first, first + n)
        warmup.append(Request(ids, starts[sl], lengths[sl], _fasta(
            ids, block, begins[sl], ends[sl])))
        first += n
    return Pool(requests, warmup, residues)
