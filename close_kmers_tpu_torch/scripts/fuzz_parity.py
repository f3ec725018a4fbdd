"""Randomized parity fuzzer: the port's serving paths on fresh random DBs
against the CPU oracle.  Port of ``scripts/fuzz_parity.py``.

    python -m close_kmers_tpu_torch.scripts.fuzz_parity [--rounds N]
        [--seed0 S] [--device cuda|cpu]

Each round draws its inputs from its seed in the JAX script's numpy order
(:func:`round_inputs`): a fresh random DB (deep or shallow buckets),
adversarial proteins (fragment mosaics, random residues, ambiguity runs,
back-to-back kmers, boundary lengths) and an EngineParams sweep.  For
one seed they are the JAX round's, bit for bit; the port's own draws
come after them.  :func:`one_round` then holds, against
``core.oracle.process_aa_seq`` and ``find_best_call`` (the JAX round's
checks):

* ``TpuEngine.process_batch``: hits, calls, weighted scores as f32, OTU
  tallies;
* ``DeviceScorer.score_batch``'s packed calls;
* ``FastAnnotator.probe_compact`` -> ``native.score_batch`` ->
  ``native.best_call_batch`` -> ``finish_best_call``;

and the card's own paths:

* device best-call: ``best_calls_batch`` and ``finish_best_batch`` of
  ``best_batch_packed``, with rows past 32 calls through the fallback
  (rows built from the DB's kmers join the batch, so every round has
  some);
* one forced JAX tier (payload_wide, sub_blocks, lo_wide, fused_wide in
  turn, by ``DeviceDB.from_db`` flags; a tier whose tables pass
  FORCED_MAX_BYTES yields to the next): ``probe_windows`` equal to the
  binary search's six planes on every window;
* the sharded step on meshes (1, 4) and (2, 2) whose entries all repeat
  the round's device: ``serve_step_sharded`` best packs against
  ``best_batch_packed``, ``ShardedEngine.probe_compact`` (routed from a
  capacity that drops, through its re-dispatch ladder, and replicated)
  against ``FastAnnotator.probe_compact``, ``probe_routed`` at the
  default, a forced-overflow and the drop-free capacity against
  ``probe_sharded``;
* ``family`` rounds: a random kmer->family mapping (1-3 families a key),
  ``KmerEngine.best_family_matches_padded`` on the device program (two
  gathers, then famwide rows forced) equal to the host path;
* ``wide`` rounds: the round's proteins point-mutated and tiled to one
  serving batch, so every kernel runs many blocks: the hits, calls and
  best calls against an independent CPU reference (numpy searchsorted
  hits, ``native.score_batch``), and the forced tier on its windows.

:func:`edge_db` is a DB whose buckets sit on the edges of the search
rows (12 keys in a row, 13 and more by pivots, 25/26 where the pivots'
stride grows); ``one_round(..., db=edge_db(seed))`` fuzzes it.

Every check raises :class:`FuzzMismatch`; ``main`` prints the seed and
the check, then exits 1.  Entry points run on the card unless given
``--device cpu``, where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import logging
import sys
import time

import numpy as np
import torch

from ..core import oracle as O
from ..core.api import KmerEngine
from ..core.device_family import DeviceFamilyDB, DeviceFamilyScorer, fan_out
from ..core.device_score import DeviceScorer
from ..core.engine import (JAX_TIER_FLAGS, DeviceDB, FastAnnotator,
                           TpuEngine, _hit_codes, encode_windows,
                           finish_best_call, flag_tier, probe_windows,
                           tier_bytes, tier_stats)
from ..db.family_db import FamilyData, KmerFamilyMapping
from ..db.signature_db import SignatureDB
from ..native import api as native
from ..ops import encoder as E
from ..params import K, LO_CARD, EngineParams
from ..parallel import sharding as SH
from ..utils.device import resolve_device

TIER_CYCLE = ("payload_wide", "sub_blocks", "lo_wide", "fused_wide")
# largest table a forced tier or forced famwide rows may take: a shallow
# DB's famwide rows over all 3.2M hi buckets are 1.64 GB (128 ints a row)
FORCED_MAX_BYTES = 2 << 30
FAMILY_EVERY = 3       # a family round every FAMILY_EVERY seeds
WIDE_EVERY = 5         # on a card, a wide round every WIDE_EVERY seeds
WIDE_ROWS = 4096       # proteins of a wide round: one serving batch
MUTATION = 0.03        # point-mutation rate of a wide round's copies
OVERFLOW_ROWS = 2      # rows built past the 32-call device cap
SHARD_MESHES = ((1, 4), (2, 2))
# bucket sizes of the search rows' edges (ops/probe_search.py): up to
# NARROW_SLOTS = 12 keys sit in the row, from 13 the row holds pivots at
# (j+1)*s-1, s = size // 13 + 1 (s grows from 2 to 3 between 25 and 26)
SIZE_CLASSES = (("0", 0, 0), ("1-12", 1, 12), ("12", 12, 12),
                ("13", 13, 13), ("14-25", 14, 25), ("26+", 26, 1 << 62))
EDGE_SIZES = (1, 2, 6, 7, 11, 12, 13, 14, 24, 25, 26, 27, 38, 39, 40,
              167, 168, 169)


class FuzzMismatch(AssertionError):
    """A device path differs from the oracle or from its reference."""


def check(cond, what: str) -> None:
    if not cond:
        raise FuzzMismatch(what)


@dataclasses.dataclass
class Coverage:
    """What the rounds met, summed over rounds: windows probed and hits
    by their bucket's size class (SIZE_CLASSES), rows past the device
    call cap that took the best-call fallback, windows through the routed
    overflow fallback, windows the first routed capacities dropped (the
    ladder's re-dispatches), and the rounds of each kind."""

    rounds: int = 0
    seqs: int = 0
    probed: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    hits: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    fallback_rows: int = 0
    routed_overflow: int = 0
    routed_drops: int = 0
    tiers: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    family_rounds: int = 0
    famwide_rounds: int = 0
    wide_rounds: int = 0
    wide_rows: int = 0
    wide_calls: int = 0

    def add_windows(self, db: SignatureDB, hi, valid, found) -> None:
        """Count the valid windows (numpy hi, valid, found) by size class
        of their bucket."""
        size = np.diff(db.bucket_start.astype(np.int64))[hi[valid]]
        hit = found[valid]
        for name, a, b in SIZE_CLASSES:
            m = (size >= a) & (size <= b)
            self.probed[name] += int(m.sum())
            self.hits[name] += int((m & hit).sum())

    def line(self) -> str:
        cls = ", ".join(f"{name} {self.hits[name]}/{self.probed[name]}"
                        for name, _, _ in SIZE_CLASSES)
        return (f"coverage: {self.rounds} rounds, {self.seqs} sequences; "
                f"hit/probed windows by bucket keys {cls} (1-12 in the "
                f"search row, 13+ by pivots); best-call fallback rows "
                f"{self.fallback_rows}; routed overflow windows "
                f"{self.routed_overflow}, routed drops re-dispatched "
                f"{self.routed_drops}; forced tiers {dict(self.tiers)}; "
                f"family rounds {self.family_rounds} (famwide rows read in "
                f"{self.famwide_rounds}); wide rounds {self.wide_rounds} "
                f"({self.wide_rows} rows, {self.wide_calls} calls)")


@dataclasses.dataclass
class RoundInputs:
    """One round's inputs: the DB, whether its buckets were drawn deep
    (None for a DB given), the proteins, the params, and the generator
    after the JAX round's draws (the port's own draws continue from
    it)."""

    db: SignatureDB
    deep: bool | None
    seqs: list
    params: EngineParams
    rng: np.random.Generator


def _draw_queries(rng, db: SignatureDB):
    """The JAX round's proteins and params (scripts/fuzz_parity.py:74-104)
    over ``db``, in its draw order."""
    keys = db.keys

    def rand_seq():
        parts = []
        total = 0
        target = int(rng.integers(0, 260))
        while total < target:
            r = rng.random()
            if r < 0.55:   # DB kmer fragments (possibly overlapping runs)
                k = E.decode_kmer(int(keys[rng.integers(0, len(keys))]))
                parts.append(k[:int(rng.integers(4, 9))])
            elif r < 0.8:
                parts.append("".join(rng.choice(list(E.PROT_ALPHA),
                                                size=int(rng.integers(1, 20)))))
            elif r < 0.9:
                parts.append("".join(rng.choice(list("XxUuBbZz*-"),
                                                size=int(rng.integers(1, 4)))))
            else:          # exact whole kmers back to back (dense runs)
                f = int(rng.integers(0, len(keys)))
                for q in range(int(rng.integers(1, 5))):
                    parts.append(E.decode_kmer(int(keys[min(f + q,
                                                            len(keys) - 1)])))
            total += len(parts[-1])
        return "".join(parts)

    seqs = [rand_seq() for _ in range(int(rng.integers(4, 24)))]
    seqs += ["", "A" * 8, "A" * 9, E.decode_kmer(int(keys[0])) * 3]
    params = EngineParams(
        min_hits=int(rng.integers(1, 7)),
        min_weighted_hits=int(rng.choice([0, 0, 1, 3])),
        max_gap=int(rng.choice([5, 30, 200, 1000])),
        order_constraint=int(rng.integers(0, 2)),
    )
    return seqs, params


def round_inputs(seed: int, db: SignatureDB | None = None) -> RoundInputs:
    """The JAX round's inputs for ``seed`` (scripts/fuzz_parity.py:46-104,
    the same numpy draws in the same order), built with the port's
    SignatureDB.  With ``db`` given the DB draws are skipped and the
    proteins are drawn over it."""
    rng = np.random.default_rng(seed)
    deep = None
    if db is None:
        # random DB shape: sometimes key-space-wide (shallow buckets),
        # sometimes a narrow hi span (deep buckets)
        deep = bool(rng.integers(0, 2))
        n = int(rng.integers(2_000, 40_000))
        if deep:
            h0 = int(rng.integers(0, 3_000_000))
            span = int(rng.integers(50, 2_000))
            his = rng.integers(h0, h0 + span, size=n, dtype=np.int64)
        else:
            his = rng.integers(0, 3_200_000, size=n, dtype=np.int64)
        keys = np.unique(his * LO_CARD + rng.integers(0, LO_CARD, size=n,
                                                      dtype=np.int64))
        n_funcs = int(rng.integers(2, 40))
        db = SignatureDB(
            keys,
            rng.integers(0, n_funcs, size=len(keys)).astype(np.int32),
            rng.integers(-1, 9, size=len(keys)).astype(np.int32),
            rng.integers(0, 500, size=len(keys)).astype(np.int32),
            rng.uniform(0.05, 6.0, size=len(keys)).astype(np.float32),
            functions=[f"fn{i}" for i in range(n_funcs)],
        )
    seqs, params = _draw_queries(rng, db)
    return RoundInputs(db, deep, seqs, params, rng)


def edge_db(seed: int, n_funcs: int = 12) -> SignatureDB:
    """A DB whose buckets have every size of EDGE_SIZES many times over
    (12 keys fill a search row, 13 and more are found by pivots, whose
    stride grows between 25 and 26; 168/169 pass the rows' pivot span),
    their lo codes random and distinct, with a random function, OTU,
    offset and weight a key."""
    rng = np.random.default_rng(seed)
    sizes = np.repeat(np.asarray(EDGE_SIZES, dtype=np.int64), 40)
    rng.shuffle(sizes)
    his = np.sort(rng.choice(3_200_000, size=len(sizes), replace=False))
    keys = np.concatenate([
        h * LO_CARD + np.sort(rng.choice(LO_CARD, size=int(s),
                                         replace=False))
        for h, s in zip(his, sizes)])
    n = len(keys)
    return SignatureDB(
        keys, rng.integers(0, n_funcs, size=n).astype(np.int32),
        rng.integers(-1, 9, size=n).astype(np.int32),
        rng.integers(0, 500, size=n).astype(np.int32),
        rng.uniform(0.05, 6.0, size=n).astype(np.float32),
        functions=[f"fn{i}" for i in range(n_funcs)])


def random_mapping(db: SignatureDB, rng) -> KmerFamilyMapping:
    """A kmer->family mapping over ``db`` in the manner of
    ``scripts/make_scale_db.scale_mapping``: 3 families a function (family
    f of function f // 3, genus f % 5), each key mapped to 1-3 distinct
    families of its own function in a random order, the last of them
    swapped for a family of another function one time in five."""
    n = len(db)
    n_funcs = len(db.functions)
    deg = 1 + rng.integers(0, 3, size=n)
    cand = db.fi[:, None].astype(np.int64) * 3 + np.argsort(
        rng.random((n, 3)), axis=1)
    other = ((db.fi + 1 + rng.integers(0, max(1, n_funcs - 1), size=n))
             % n_funcs) * 3 + rng.integers(0, 3, size=n)
    swap = (rng.random(n) < 0.2) & (n_funcs > 1)
    cand[np.arange(n)[swap], deg[swap] - 1] = other[swap]
    keep = np.arange(3)[None, :] < deg[:, None]
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    mapping = KmerFamilyMapping()
    mapping.families = [
        FamilyData(f"PGF_{f:08d}", f"PLF_{f % 5}_{f:08d}", f % 5,
                   db.functions[f // 3], f, 10, 10)
        for f in range(3 * n_funcs)]
    mapping._bulk_fam = (db.keys, offs, cand[keep].astype(np.int32))
    return mapping


def overflow_rows(db: SignatureDB, params: EngineParams, rng,
                  n_rows: int = OVERFLOW_ROWS, n_runs: int = 34) -> list:
    """Proteins past the device call-stream cap: each row is ``n_runs``
    runs of max(min_hits, 3) whole DB kmers of one function (weight at
    least 1, back to back), consecutive runs of different functions, so
    each run is a call wherever the params let hits 8 residues apart join
    one (max_gap >= 8, no order constraint).  Empty where the DB has
    fewer than two such functions."""
    run = max(params.min_hits, 3)
    ok = db.wt >= 1.0
    funcs = [f for f in np.unique(db.fi[ok])
             if np.count_nonzero(ok & (db.fi == f)) >= run]
    if len(funcs) < 2:
        return []
    pools = {f: db.keys[ok & (db.fi == f)] for f in funcs}
    rows = []
    for _ in range(n_rows):
        parts, prev = [], None
        for _ in range(n_runs):
            f = prev
            while f == prev:
                f = funcs[int(rng.integers(0, len(funcs)))]
            prev = f
            pick = rng.choice(pools[f], size=run, replace=False)
            parts += [E.decode_kmer(int(k)) for k in pick]
        rows.append("".join(parts))
    return rows


def mutated_rows(seqs: list, n_rows: int, rng,
                 rate: float = MUTATION) -> list:
    """``n_rows`` proteins: the round's non-empty proteins in turn, each
    copy with a ``rate`` share of its residues replaced at random."""
    src = [s for s in seqs if s] or ["A" * 9]
    alpha = np.array(list(E.PROT_ALPHA))
    rows = []
    for r in range(n_rows):
        s = np.array(list(src[r % len(src)]))
        hit = rng.random(len(s)) < rate
        s[hit] = alpha[rng.integers(0, len(alpha), size=int(hit.sum()))]
        rows.append("".join(s))
    return rows


def reference_hits(db: SignatureDB, offsets: np.ndarray,
                   lengths: np.ndarray):
    """Independent CPU hits of a padded batch: every window whose eight
    residues are valid and that starts before len - K (kguts.cc:792),
    found by a numpy searchsorted over the DB keys.  Returns (row, pos,
    DB row) of the hits in row-major order."""
    B, L = offsets.shape
    W = L - K
    ok = np.arange(W)[None, :] < lengths[:, None] - K
    bad = offsets >= 20
    for j in range(K):
        ok &= ~bad[:, j:j + W]
    bi, pos, codes = _hit_codes(ok, offsets)
    idx = np.minimum(np.searchsorted(db.keys, codes), max(len(db) - 1, 0))
    hit = db.keys[idx] == codes
    return bi[hit], pos[hit], idx[hit]


def reference_calls(db: SignatureDB, offsets, lengths, params,
                    max_calls: int):
    """``native.score_batch`` over :func:`reference_hits` (at most
    ``max_calls`` calls a protein)."""
    bi, pos, idx = reference_hits(db, offsets, lengths)
    row_off = np.zeros(offsets.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(bi, minlength=offsets.shape[0]), out=row_off[1:])
    return native.score_batch(pos, db.fi[idx], db.oi[idx], db.avg_off[idx],
                              db.wt[idx], row_off, params,
                              max_calls_per_seq=max_calls)


def _bits(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _planes_equal(a, b) -> bool:
    return all(np.array_equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _best_key(b: O.BestCall):
    return (b.function, b.score, b.weighted_score, b.score_offset)


def _oracle(db: SignatureDB, seqs: list, params: EngineParams) -> list:
    out = []
    for s in seqs:
        calls, hits, otu = [], [], O.OtuStats()
        O.process_aa_seq(s, db.lookup, params, calls, hits.append, otu)
        otu.finalize()
        out.append((calls, hits, otu))
    return out


def forced_tier(db: SignatureDB, r: int) -> str | None:
    """The tier a round forces: TIER_CYCLE from position ``r``, the first
    whose JAX flags build tables within FORCED_MAX_BYTES (flags may build
    another tier where the JAX gates inside them say so), as the name of
    its flags; None where none fits."""
    st = tier_stats(db)
    for k in range(len(TIER_CYCLE)):
        name = TIER_CYCLE[(r + k) % len(TIER_CYCLE)]
        if tier_bytes(st, flag_tier(st, **JAX_TIER_FLAGS[name])) \
                <= FORCED_MAX_BYTES:
            return name
    return None


def _check_engine(db, seqs, want, params, device, tag) -> None:
    """The JAX round's TpuEngine check (fuzz_parity.py:120-135)."""
    got = TpuEngine(db, device).process_batch(
        [(f"s{i}", s) for i, s in enumerate(seqs)], params, want_hits=True)
    for i, ((w_calls, w_hits, w_otu), (g_calls, g_hits, g_otu)) in \
            enumerate(zip(want, got)):
        check(len(g_hits) == len(w_hits), f"{tag} TpuEngine hits of seq {i}")
        for a, b in zip(g_hits, w_hits):
            check((a.pos, a.fI, a.oI, a.avg_off, a.code)
                  == (b.pos, b.fI, b.oI, b.avg_off, b.code)
                  and np.float32(a.wt) == np.float32(b.wt),
                  f"{tag} TpuEngine hit at {b.pos} of seq {i}")
        check([(c.start, c.end, c.count, c.fI) for c in g_calls]
              == [(c.start, c.end, c.count, c.fI) for c in w_calls]
              and all(np.float32(a.weighted) == np.float32(b.weighted)
                      for a, b in zip(g_calls, w_calls)),
              f"{tag} TpuEngine calls of seq {i}")
        check(g_otu.otus_by_count == w_otu.otus_by_count,
              f"{tag} TpuEngine OTU tallies of seq {i}")


def _check_scorers(db, fa, ds, want, offsets, lengths, params, tag) -> None:
    """The JAX round's DeviceScorer and native checks
    (fuzz_parity.py:137-158)."""
    n_calls, calls_l = ds.score_batch(offsets, lengths, params)
    for i, (w_calls, _h, _o) in enumerate(want):
        check(int(n_calls[i]) == len(w_calls)
              and all(a[:4] == (b.start, b.end, b.count, b.fI)
                      and np.float32(a[4]) == np.float32(b.weighted)
                      for a, b in zip(calls_l[i], w_calls)),
              f"{tag} DeviceScorer.score_batch calls of seq {i}")
    h = fa.probe_compact(offsets, lengths)
    nb, cs, ce, cc, cf, cw, _v = native.score_batch(
        h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
        params, 512, False)
    nf, ofi, ocnt, owt = native.best_call_batch(nb, cs, ce, cc, cf, cw)
    for i, (w_calls, _h, _o) in enumerate(want):
        got = finish_best_call(int(nf[i]), ofi[i], ocnt[i], owt[i],
                               db.function_of)
        check(_best_key(got) == _best_key(O.find_best_call(
            w_calls, db.function_of)),
            f"{tag} native best call of seq {i}")


def _check_device_best(db, fa, ds, seqs, want, params, cov, tag) -> int:
    """Device best-call (best_batch_packed's pack, finish_best_batch and
    best_calls_batch with its fallback) against the oracle's
    find_best_call, each row's cap flag against its call count.  Returns
    the rows past the cap."""
    offsets, lengths = fa.pad_batch(seqs)
    pack = ds.best_batch_packed(offsets, lengths, params).cpu().numpy()
    fast = DeviceScorer.finish_best_batch(pack, db.function_of,
                                          overflow="ignore")
    full = ds.best_calls_batch(offsets, lengths, db.function_of, params)
    for i, (w_calls, _h, _o) in enumerate(want):
        w = _best_key(O.find_best_call(w_calls, db.function_of))
        check(int(pack[i, 8]) == int(len(w_calls) > 32),
              f"{tag} device call-cap flag of row {i} ({len(w_calls)} calls)")
        check(_best_key(full[i]) == w,
              f"{tag} best_calls_batch of row {i} ({len(w_calls)} calls)")
        check(pack[i, 8] or _best_key(fast[i]) == w,
              f"{tag} finish_best_batch of row {i}")
    over = int(pack[:, 8].sum())
    cov.fallback_rows += over
    return over


def _check_tier(db, tier, ddb_bin, hi, lo, valid, device, tag) -> str:
    """The forced tier's probe_windows against the binary search's six
    planes on the windows (hi, lo, valid)."""
    d = DeviceDB.from_db(db, device, **JAX_TIER_FLAGS[tier])
    check(_planes_equal(probe_windows(d, hi, lo, valid),
                        probe_windows(ddb_bin, hi, lo, valid)),
          f"{tag} the {d.tier} tier (flags of {tier}) differs from the "
          f"binary search")
    return d.tier


@contextlib.contextmanager
def _quiet(logger: str):
    """``logger`` at ERROR for the block: the routed ladder warns at each
    re-dispatch, which the fuzzer forces every round."""
    log = logging.getLogger(logger)
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def _check_sharded(db, fa, ds, offsets, lengths, params, device, seed,
                   cov, tag) -> None:
    """The sharded step over each of SHARD_MESHES, its entries all on
    ``device``, against the single device."""
    B = offsets.shape[0]
    Bp = -(-B // 4) * 4
    o4 = np.concatenate([offsets, np.full((Bp - B, offsets.shape[1]), 20,
                                          np.uint8)])
    n4 = np.concatenate([lengths, np.zeros(Bp - B, np.int32)])
    want_best = ds.best_batch_packed(o4, n4, params).cpu()
    want_hits = fa.probe_compact(offsets, lengths)
    for k, shape in enumerate(SHARD_MESHES):
        mesh = SH.make_mesh(*shape, devices=[device] * 4)
        se = SH.ShardedEngine(db, mesh)
        sdb = se.sdb
        where = f"{tag} mesh {shape}"
        # the step routed on one mesh and replicated on the other, the
        # two swapped from seed to seed
        routed = (k + seed) % 2 == 0
        mode = "routed" if routed else "replicated"
        best, _ovf, drop = SH.serve_step_sharded(sdb, o4, n4, params,
                                                 routed=routed)
        if int(drop.sum()):
            cov.routed_drops += int(drop.sum())
            best, _ovf, drop = SH.serve_step_sharded(
                sdb, o4, n4, params, routed=routed, capacity_factor=None)
            check(int(drop.sum()) == 0, f"{where} serve_step_sharded "
                  f"dropped at the drop-free capacity")
        check(torch.equal(best.cpu(), want_best),
              f"{where} serve_step_sharded {mode} best pack")
        # routed from a capacity that drops (the re-dispatch ladder), and
        # replicated
        se.ROUTED_CAPACITY = 0.25
        for se.routed in (True, False):
            with _quiet(SH.__name__):
                got = se.probe_compact(offsets, lengths)
            check(all(np.array_equal(_bits(got[key]), _bits(want_hits[key]))
                      for key in want_hits),
                  f"{where} ShardedEngine.probe_compact "
                  f"{'routed' if se.routed else 'replicated'}")
        rep = SH.probe_sharded(sdb, o4, n4)
        for kw in ({}, dict(capacity_factor=0.25),
                   dict(capacity_factor=0.5, ov_frac=1.0),
                   dict(capacity_factor=None)):
            rt = SH.probe_routed(sdb, o4, n4, **kw)
            cov.routed_overflow += int(rt[7].sum())
            drops = int(rt[8].sum())
            cov.routed_drops += drops
            check(drops == 0 or kw.get("capacity_factor", 2.0) is not None,
                  f"{where} probe_routed dropped at the drop-free capacity")
            check(drops > 0 or _planes_equal(rep[:7], rt[:7]),
                  f"{where} probe_routed {kw} differs from probe_sharded")


def _check_family(db, offsets, lengths, params, rng, device, cov,
                  tag) -> None:
    """A random mapping's best family matches on the device program (the
    two gathers, then famwide rows forced where they fit) against the
    host path of the same engine."""
    mapping = random_mapping(db, rng)
    kw = dict(kmer_hit_threshold=int(rng.integers(1, 5)),
              allow_ambiguous=bool(rng.integers(0, 2)),
              target_genus_id=int(rng.integers(0, 5)),
              genus_filter=bool(rng.integers(0, 2)))
    eng = KmerEngine(db, device, device_family_min=0)
    check(eng.family_gate(mapping) is None,
          f"{tag} the family gates refused the mapping")
    got = eng.best_family_matches_padded(offsets, lengths, mapping, params,
                                         **kw)
    check(eng._family_scorers[mapping][1].famwide is None,
          f"{tag} the card's family program built famwide rows")
    eng.device_family = False
    want = eng.best_family_matches_padded(offsets, lengths, mapping, params,
                                          **kw)
    eng.device_family = True
    check(got == want, f"{tag} family best matches (two gathers) {kw}")
    cov.family_rounds += 1
    D = fan_out(mapping)
    if DeviceFamilyDB.famwide_packs(db) and db.n_hi * \
            DeviceFamilyDB.famwide_row_w(db, D) * 4 <= FORCED_MAX_BYTES:
        fw = DeviceFamilyScorer(db, mapping, eng.fa.device, ddb=eng.fa.ddb,
                                famwide=True)
        eng._family_scorers[mapping] = (mapping.fam_csr(), fw)
        got = eng.best_family_matches_padded(offsets, lengths, mapping,
                                             params, **kw)
        check(got == want, f"{tag} family best matches (famwide) {kw}")
        # the rows carry no avg_off: under order_constraint the program
        # takes the two gathers beside them
        cov.famwide_rounds += int(not params.order_constraint)


def _check_wide(db, fa, ds, seqs, tier, params, rng, n_rows, device,
                cov, tag) -> None:
    """``n_rows`` mutated copies of the round's proteins against the
    independent CPU reference: compact hits, packed calls, best calls,
    and the forced tier's probe on their windows."""
    rows = mutated_rows(seqs, n_rows, rng)
    offsets, lengths = fa.pad_batch(rows)
    bi, pos, idx = reference_hits(db, offsets, lengths)
    h = fa.probe_compact(offsets, lengths)
    row_off = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(bi, minlength=n_rows), out=row_off[1:])
    check(np.array_equal(h["row_off"], row_off)
          and np.array_equal(h["pos"], pos)
          and np.array_equal(h["fi"], db.fi[idx])
          and np.array_equal(h["oi"], db.oi[idx])
          and np.array_equal(h["avg_off"], db.avg_off[idx])
          and np.array_equal(_bits(h["wt"]), _bits(db.wt[idx]))
          and np.array_equal(h["code"], db.keys[idx]),
          f"{tag} wide batch: probe_compact hits")
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(db, offsets, lengths,
                                                   params, 512)
    n_calls, calls_l = ds.score_batch(offsets, lengths, params)
    for i in range(n_rows):
        check(int(n_calls[i]) == int(n_ref[i])
              and all(c[:4] == (int(cs[i, j]), int(ce[i, j]), int(cc[i, j]),
                                int(cf[i, j]))
                      and np.float32(c[4]) == np.float32(cw[i, j])
                      for j, c in enumerate(calls_l[i])),
              f"{tag} wide batch: calls of row {i}")
    nf, ofi, ocnt, owt = native.best_call_batch(n_ref, cs, ce, cc, cf, cw)
    got = ds.best_calls_batch(offsets, lengths, db.function_of, params)
    for i in range(n_rows):
        w = finish_best_call(int(nf[i]), ofi[i], ocnt[i], owt[i],
                             db.function_of)
        check(vars(got[i]) == vars(w), f"{tag} wide batch: best call of "
              f"row {i}")
    if tier is not None:
        hi, lo, valid = encode_windows(
            torch.from_numpy(offsets).to(device),
            torch.from_numpy(lengths).to(device))
        _check_tier(db, tier, fa.ddb, hi, lo, valid, device,
                    f"{tag} wide batch:")
    cov.wide_rounds += 1
    cov.wide_rows += n_rows
    cov.wide_calls += int(n_ref.sum())


def one_round(seed: int, device, r: int = 0, family: bool = False,
              wide: int = 0, cov: Coverage | None = None,
              db: SignatureDB | None = None) -> dict:
    """One round of seed ``seed`` on ``device`` (see the module's
    docstring); ``r`` picks the forced tier (TIER_CYCLE[r % 4] first),
    ``family`` adds the family checks, ``wide`` the wide batch of that
    many rows, ``db`` replaces the drawn DB (e.g. :func:`edge_db`).
    Raises FuzzMismatch at the first difference; adds to ``cov``.
    Returns the round's summary."""
    device = resolve_device(device)
    cov = cov if cov is not None else Coverage()
    inp = round_inputs(seed, db)
    db, seqs, params, rng = inp.db, inp.seqs, inp.params, inp.rng
    tag = f"seed {seed}:"
    fa = FastAnnotator(db, device)
    ds = DeviceScorer(db, device, ddb=fa.ddb)
    want = _oracle(db, seqs, params)

    _check_engine(db, seqs, want, params, device, tag)
    offsets, lengths = fa.pad_batch(seqs)
    _check_scorers(db, fa, ds, want, offsets, lengths, params, tag)

    # device best-call on the round's proteins, then on rows built past
    # the cap: under the round's params where those join the rows' runs
    # into calls past 32, else under params that do
    over = _check_device_best(db, fa, ds, seqs, want, params, cov, tag)
    built = overflow_rows(db, params, rng)
    if built:
        b_params = params
        b_want = _oracle(db, built, params)
        if max(len(c) for c, _h, _o in b_want) <= 32:
            b_params = dataclasses.replace(params, max_gap=200,
                                           order_constraint=0)
            b_want = _oracle(db, built, b_params)
        over += _check_device_best(db, fa, ds, built, b_want, b_params, cov,
                                   f"{tag} built rows:")

    # the forced tier against the binary search on the round's windows
    off_d = torch.from_numpy(offsets).to(device)
    len_d = torch.from_numpy(lengths).to(device)
    hi, lo, valid = encode_windows(off_d, len_d)
    bin_planes = probe_windows(fa.ddb, hi, lo, valid)
    cov.add_windows(db, hi.cpu().numpy(), valid.cpu().numpy(),
                    bin_planes[0].cpu().numpy())
    tier = forced_tier(db, r)
    built_tier = None
    if tier is not None:
        built_tier = _check_tier(db, tier, fa.ddb, hi, lo, valid, device,
                                 tag)
        cov.tiers[built_tier] += 1

    _check_sharded(db, fa, ds, offsets, lengths, params, device, seed, cov,
                   tag)
    if family:
        _check_family(db, offsets, lengths, params, rng, device, cov, tag)
    if wide:
        _check_wide(db, fa, ds, seqs, tier, params, rng, wide, device,
                    cov, tag)
    cov.rounds += 1
    cov.seqs += len(seqs)
    return dict(seed=seed, deep=inp.deep, keys=len(db),
                max_bucket=db.max_bucket, seqs=len(seqs), tier=built_tier,
                fallback_rows=over, family=family, wide=wide)


def round_line(res: dict, spent: float) -> str:
    kind = {True: "deep", False: "shallow", None: "given"}[res["deep"]]
    return (f"seed {res['seed']}: {kind} DB "
            f"of {res['keys']:,} keys (max bucket {res['max_bucket']}), "
            f"{res['seqs']} sequences, tier forced {res['tier']}, "
            f"{res['fallback_rows']} rows past the call cap"
            + (", family" if res["family"] else "")
            + (f", wide {res['wide']} rows" if res["wide"] else "")
            + f" ok [{spent:.1f} s]")


def round_plan(seed: int, card: bool) -> tuple:
    """What round ``seed`` runs beside the JAX round's checks, a function
    of the seed alone (so ``--rounds 1 --seed0 SEED`` repeats it): the
    position in TIER_CYCLE of its forced tier, a family round every
    FAMILY_EVERY seeds and, on a card, a wide round of WIDE_ROWS rows
    every WIDE_EVERY seeds."""
    return (seed % len(TIER_CYCLE), seed % FAMILY_EVERY == 0,
            WIDE_ROWS if card and seed % WIDE_EVERY == WIDE_EVERY - 1 else 0)


def run(rounds: int, seed0: int, device, edge: bool = False,
        cov: Coverage | None = None) -> Coverage:
    """``rounds`` rounds from ``seed0`` on ``device``, each as
    :func:`round_plan` says; with ``edge`` one more round over
    :func:`edge_db` (a family round, wide on a card).  Prints a line a
    round; raises FuzzMismatch."""
    device = resolve_device(device)
    cov = cov if cov is not None else Coverage()
    card = device.type == "cuda"
    plan = [(seed, *round_plan(seed, card), None)
            for seed in range(seed0, seed0 + rounds)]
    if edge:
        seed = seed0 + rounds
        plan.append((seed, seed % len(TIER_CYCLE), True,
                     WIDE_ROWS if card else 0, edge_db(seed)))
    for seed, r, family, wide, db in plan:
        t0 = time.time()
        res = one_round(seed, device, r, family, wide, cov, db)
        print(round_line(res, time.time() - t0), flush=True)
    return cov


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Randomized parity fuzzer of the port's serving paths.")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; refuses without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cov = Coverage()
    t0 = time.time()
    try:
        run(args.rounds, args.seed0, device, cov=cov)
    except FuzzMismatch as e:
        print(f"MISMATCH: {e}\nrepro: python -m "
              f"close_kmers_tpu_torch.scripts.fuzz_parity --rounds 1 "
              f"--seed0 <the seed above> --device {args.device}", flush=True)
        return 1
    print(cov.line(), flush=True)
    print(f"all {cov.rounds} rounds passed ({cov.seqs} sequences) in "
          f"{time.time() - t0:.1f} s on {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
