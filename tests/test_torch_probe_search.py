"""Port parity for the binary-search probe tier (ops/probe_search.py):
``probe_search_plain``, the ``probe_search`` wrapper on CPU tensors and
``probe_windows`` on a binary-search DeviceDB against the JAX package's
binary tier (``DeviceDB.from_db(sub=False, wide=False, wide_lo=False,
fused=False)``), on DBs with buckets of 0, 1, 2^k - 1, 2^k, 2^k + 1 and
~2,500 keys (n_steps 12), first- and last-slot hits, invalid windows and
tables carried over from the JAX DeviceDB, with its n_steps or fewer;
and on buckets that start at every residue mod 32.  Zero tolerance:
every plane is integer, f32 compared by its int32 bits.  The halving
step's midpoint differs from the JAX tier's on purpose past 2^30 keys
(``test_midpoint_stays_in_int32``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from close_kmers_tpu.core import engine as E
from close_kmers_tpu_torch.core import engine as T
from close_kmers_tpu_torch.ops.probe_search import (NARROW_SLOTS, ROW_W,
                                                    WIDE_SLOTS, midpoint,
                                                    probe_search,
                                                    probe_search_plain,
                                                    search_rows)

from test_torch_cuda import SEARCH_DEPTHS, round_db, search_db
from test_torch_host import as_jax_db

BINARY = dict(sub=False, wide=False, wide_lo=False, fused=False)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module", params=[0, 1, 2])
def searched(request):
    """(db, windows, the JAX DeviceDB, the JAX planes) of search_db."""
    db, hi, lo, valid = search_db(request.param)
    jd = E.DeviceDB.from_db(as_jax_db(db), **BINARY)
    assert jd.lo_wide is None and jd.sub_blocks is None
    want = E.probe_windows(jd, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid))
    return db, (hi, lo, valid), jd, [np.asarray(w) for w in want]


def _torch(wins):
    return [torch.from_numpy(np.ascontiguousarray(w)) for w in wins]


def _assert_planes(want, got):
    assert len(got) == 6
    for k, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(bits(w), bits(g.numpy())), k


def test_plain_matches_jax_binary_tier(searched):
    db, wins, jd, want = searched
    td = T.DeviceDB.from_db(db, "cpu", **BINARY)
    assert td.tier == "binary_search" and td.n_steps == jd.n_steps == 12
    got = probe_search_plain(*_torch(wins), td.bucket_pair, td.lo,
                             td.payload, td.n, td.n_steps)
    _assert_planes(want, got)
    assert 1000 < int(got[0].sum()) < len(wins[0])


def test_wrapper_and_probe_windows_match_jax(searched):
    """On CPU tensors the wrapper runs the plain version (no launch), and
    probe_windows takes it for the binary tier, on 1-d and 2-d
    windows."""
    db, wins, jd, want = searched
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["binary_search"])
    before = probe_search.launches
    _assert_planes(want, probe_search(*_torch(wins), td.bucket_pair, td.lo,
                                      td.payload, td.n, td.n_steps))
    _assert_planes(want, T.probe_windows(td, *_torch(wins)))
    m = len(wins[0]) // 4 * 4
    got2 = T.probe_windows(td, *(w[:m].reshape(4, -1)
                                 for w in _torch(wins)))
    assert got2[0].shape == (4, m // 4)
    _assert_planes([w[:m] for w in want], [g.reshape(-1) for g in got2])
    assert probe_search.launches == before


def test_every_bucket_depth_hits_first_and_last_slot(searched):
    """Each bucket's first and last keys are found at their rows; a lo
    below or above every key of a bucket misses."""
    db, wins, jd, want = searched
    hi, lo, valid = wins
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["binary_search"])
    starts, ends = db.bucket_start[:-1], db.bucket_start[1:]
    full = np.nonzero(ends > starts)[0]
    assert sorted(ends[full] - starts[full]) == sorted(
        d for d in SEARCH_DEPTHS if d)
    rows = np.concatenate([starts[full], ends[full] - 1])
    # search_db's keys avoid lo 0 and 7999: below and above every bucket
    edge_hi = np.concatenate([db.hi[rows], full, full]).astype(np.int32)
    edge_lo = np.concatenate([db.lo[rows], np.zeros(len(full)),
                              np.full(len(full), 7999)]).astype(np.int32)
    got = probe_search_plain(*_torch([edge_hi, edge_lo,
                                      np.ones(len(edge_hi), bool)]),
                             td.bucket_pair, td.lo, td.payload, td.n,
                             td.n_steps)
    jw = E.probe_windows(jd, jnp.asarray(edge_hi), jnp.asarray(edge_lo),
                         jnp.asarray(np.ones(len(edge_hi), bool)))
    _assert_planes([np.asarray(w) for w in jw], got)
    k = len(rows)
    assert got[0][:k].all() and np.array_equal(got[5][:k].numpy(), rows)
    assert not got[0][k:].any() and (got[5][k:] == len(db)).all()


def test_invalid_windows_miss(searched):
    """Invalid windows, whatever their hi and lo (outside the tables
    too), take the miss values."""
    db, (hi, lo, valid), jd, want = searched
    assert (~valid).sum() > 1000 and ((hi < 0) | (hi >= 3_200_000))[
        ~valid].any()
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["binary_search"])
    got = probe_search_plain(*_torch((hi, lo, valid)), td.bucket_pair,
                             td.lo, td.payload, td.n, td.n_steps)
    bad = torch.from_numpy(~valid)
    assert not got[0][bad].any()
    assert (got[1][bad] == -1).all() and (got[2][bad] == -1).all()
    assert (got[3][bad] == 0).all() and (got[4][bad] == 0).all()
    assert (got[5][bad] == len(db)).all()


@pytest.mark.parametrize("n_steps", [None, 0, 3, 7])
def test_from_numpy_carry_over(searched, n_steps):
    """A port DeviceDB carried over from the JAX DeviceDB's arrays probes
    as the JAX one does: with its n_steps, and with fewer, where both
    searches end early and miss the keys past their reach."""
    db, wins, jd, want = searched
    if n_steps is not None:
        jd = dataclasses.replace(jd, n_steps=n_steps)
        want = [np.asarray(w) for w in E.probe_windows(
            jd, *(jnp.asarray(w) for w in wins))]
    fields = {f: (None if getattr(jd, f) is None
                  else np.asarray(getattr(jd, f))) for f in T.DeviceDB.ARRAYS}
    td = T.DeviceDB.from_numpy(dict(fields, n=jd.n, n_steps=jd.n_steps),
                               "cpu")
    assert td.tier == "binary_search"
    got = T.probe_windows(td, *_torch(wins))
    _assert_planes(want, got)
    full = int(np.asarray(
        E.probe_windows(dataclasses.replace(jd, n_steps=12),
                        *(jnp.asarray(w) for w in wins))[0]).sum())
    if n_steps is not None and n_steps < 12:
        assert int(got[0].sum()) < full
    else:
        assert int(got[0].sum()) == full


def test_empty_db():
    """An empty DB: every window misses, n_steps 1."""
    db, hi, lo, valid = search_db(0)
    empty = type(db)(np.zeros(0, np.int64), np.zeros(0, np.int32),
                     np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32))
    jd = E.DeviceDB.from_db(as_jax_db(empty), **BINARY)
    td = T.DeviceDB.from_db(empty, "cpu")
    assert td.tier == "binary_search" and td.n_steps == 1
    want = E.probe_windows(jd, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid))
    got = T.probe_windows(td, *_torch((hi, lo, valid)))
    _assert_planes([np.asarray(w) for w in want], got)
    assert not got[0].any()


def test_wrapper_refuses_bad_inputs():
    db, hi, lo, valid = search_db(0)
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["binary_search"])
    h, l_, v = _torch((hi, lo, valid))
    tabs = (td.bucket_pair, td.lo, td.payload, td.n, td.n_steps)
    with pytest.raises(TypeError):
        probe_search(h.long(), l_, v, *tabs)
    with pytest.raises(TypeError):
        probe_search(h, l_, v.to(torch.int32), *tabs)
    with pytest.raises(ValueError):
        probe_search(h, l_[1:], v, *tabs)
    with pytest.raises(ValueError):
        probe_search(h, l_, v, td.bucket_pair, td.lo[1:], td.payload,
                     td.n, td.n_steps)
    with pytest.raises(ValueError):
        probe_search(h, l_, v, td.bucket_pair.reshape(-1), td.lo,
                     td.payload, td.n, td.n_steps)
    with pytest.raises(ValueError):
        probe_search(h, l_, v, *tabs[:4], -1)
    with pytest.raises(ValueError):
        probe_search(h, l_, v, *tabs[:3], td.n + 1, td.n_steps)


def test_plain_matches_jax_on_bucket_residues():
    """round_db: each depth around the kernel's round limits at a start of
    every residue mod 32 (mod 4 for 2,348-2,349 keys)."""
    db, hi, lo, valid = round_db(3)
    jd = E.DeviceDB.from_db(as_jax_db(db), **BINARY)
    td = T.DeviceDB.from_db(db, "cpu", **BINARY)
    assert td.n_steps == jd.n_steps == 12
    starts = db.bucket_start[:-1][np.diff(db.bucket_start) == 29]
    assert sorted(set(starts % 32)) == list(range(32))
    want = E.probe_windows(jd, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid))
    got = probe_search_plain(*_torch((hi, lo, valid)), td.bucket_pair, td.lo,
                             td.payload, td.n, td.n_steps)
    _assert_planes([np.asarray(w) for w in want], got)
    assert int(got[0].sum()) >= len(db)


EDGE = 2 ** 31 - 1


@pytest.mark.parametrize("left,right", [
    (0, 0), (0, 1), (5, 9), (2 ** 30 - 1, 2 ** 30), (2 ** 30, 2 ** 30 + 341),
    (2 ** 30 + 7, EDGE), (EDGE - 1, EDGE), (EDGE, EDGE), (0, EDGE),
    (1_091_199_659, 1_091_200_000)])
def test_midpoint_stays_in_int32(left, right):
    """The plain version's (and the kernel's) midpoint of int32 left <=
    right, up to 2^31 - 1, equals int64 (left + right) // 2.  The JAX
    tier's (left + right) >> 1 (close_kmers_tpu/core/engine.py:615) wraps
    there; the port differs from it on purpose, and equals it wherever
    the sum stays below 2^31."""
    lt = torch.tensor([left], dtype=torch.int32)
    rt = torch.tensor([right], dtype=torch.int32)
    got = midpoint(lt, rt)
    assert got.dtype == torch.int32
    assert int(got) == (left + right) // 2 == midpoint(left, right)
    wraps = left + right >= 2 ** 31
    assert (int((lt + rt) >> 1) == int(got)) != wraps


def test_midpoint_random_pairs():
    """10,000 random int32 pairs left <= right, half of them near
    2^31 - 1, against int64 (left + right) // 2."""
    rng = np.random.default_rng(9)
    a = np.concatenate([rng.integers(0, EDGE, size=5000),
                        rng.integers(EDGE - 5000, EDGE + 1, size=5000)])
    b = np.concatenate([rng.integers(0, EDGE, size=5000),
                        rng.integers(EDGE - 5000, EDGE + 1, size=5000)])
    left, right = np.minimum(a, b), np.maximum(a, b)
    got = midpoint(torch.from_numpy(left.astype(np.int32)),
                   torch.from_numpy(right.astype(np.int32)))
    assert np.array_equal(got.numpy().astype(np.int64), (left + right) // 2)


def _row_keys_of(rows):
    """Each row's slots as keys: 12 16-bit ones, or 6 32-bit ones where
    bit 31 of end is set; (keys [H, 12] int64, wide [H])."""
    wide = rows[:, 1] < 0
    words = rows[:, 2:].astype(np.int64) & 0xFFFFFFFF
    narrow = np.stack([words & 0xFFFF, words >> 16], axis=2).reshape(-1, 12)
    wide_keys = np.concatenate([rows[:, 2:].astype(np.int64),
                                np.zeros((len(rows), 6), np.int64)], axis=1)
    return np.where(wide[:, None], wide_keys, narrow), wide


@pytest.mark.parametrize("which", ["search", "rounds", "wide"])
def test_search_rows_hold_keys_or_pivots(which):
    """Each bucket's search row: start and end (bit 31 set where its slots
    are 32-bit), then its keys where it holds up to 12 (6 where a key of
    the row lies outside [0, 2^16)), else the keys at (j + 1) * s - 1 for
    s = L // (slots + 1) + 1 inside it; the slots past them 0.  On every
    bucket of search_db (0 to 2,500 keys), round_db, and search_db's keys
    mapped past 16 bits in odd buckets."""
    db = (round_db(3) if which == "rounds" else search_db(0))[0]
    td = T.DeviceDB.from_db(db, "cpu")
    lo = td.lo.numpy().copy()
    pair = td.bucket_pair.numpy()
    sizes = pair[:, 1] - pair[:, 0]
    if which == "wide":
        odd = np.repeat(np.arange(len(pair)) % 2 == 1, sizes)
        lo[:-1][odd] = lo[:-1][odd] * 97 - 300_000
    rows = search_rows(td.bucket_pair, torch.from_numpy(lo), td.n).numpy()
    assert rows.dtype == np.int32 and rows.shape == (len(pair), ROW_W)
    assert np.array_equal(rows[:, 0], pair[:, 0])
    assert np.array_equal(rows[:, 1] & 0x7FFFFFFF, pair[:, 1])
    keys, wide = _row_keys_of(rows)

    def held(start, size, slots):
        if size <= slots:
            off = np.arange(size)
        else:
            s = size // (slots + 1) + 1
            off = (np.arange(slots) + 1) * s - 1
            off = off[off < size]
        return lo[start + off]

    for h in np.flatnonzero(sizes):
        start, size = pair[h, 0], sizes[h]
        narrow = held(start, size, NARROW_SLOTS)
        assert wide[h] == bool(((narrow < 0) | (narrow >= 1 << 16)).any())
        got = held(start, size, WIDE_SLOTS if wide[h] else NARROW_SLOTS)
        want = np.zeros(12, np.int64)
        want[:len(got)] = got
        assert np.array_equal(keys[h], want), (h, size)
    assert wide.any() == (which == "wide")
    assert not rows[sizes == 0, 2:].any()
    if which != "wide":
        assert td.table_bytes() == T.tier_bytes(T.tier_stats(db),
                                                "binary_search")
