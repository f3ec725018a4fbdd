"""Port parity for core/engine: window encode, the payload-wide DeviceDB,
the state carry-over from the JAX DeviceDB, probe_compact, and the tier
each single-deep-bucket DB and the empty DB take (the six from_db
variants are in test_torch_engine_tiers.py).  Zero tolerance: every
plane is integer or a bitcast f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import engine as E
from close_kmers_tpu_torch.core import engine as T
from close_kmers_tpu_torch.db.signature_db import SignatureDB
from close_kmers_tpu_torch.params import LO_CARD

from test_engine import random_db, random_seqs
from test_torch_host import as_jax_db, as_port_db


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=24)
    return as_port_db(db), seqs


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("L", [64, 2048])
def test_encode_windows_matches_jax(L):
    """L=64 takes the JAX banded-matmul branch, L=2048 its log-tree
    branch; the port's log-tree form equals both at every window."""
    rng = np.random.default_rng(L)
    B = 6
    offsets = rng.integers(0, 21, size=(B, L)).astype(np.uint8)
    offsets[0] = rng.integers(0, 20, size=L)           # all valid
    offsets[1, L // 2:] = 20                            # padded tail
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    want = E.encode_windows(jnp.asarray(offsets), jnp.asarray(lengths))
    got = T.encode_windows(torch.from_numpy(offsets),
                           torch.from_numpy(lengths))
    assert np.asarray(want[2]).any()
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_payload_wide_table_matches_jax(corpus):
    """The JAX auto-ladder's payload-wide table, and the port's under the
    flags that force that tier."""
    db, _ = corpus
    want = E.DeviceDB.from_db(as_jax_db(db))
    got = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["payload_wide"])
    assert np.array_equal(np.asarray(want.payload_wide),
                          got.payload_wide.numpy())
    assert (got.wide_w, got.n, got.n_steps) == \
        (want.wide_w, want.n, want.n_steps)


def test_from_numpy_gives_identical_probes(corpus):
    """The state carry-over: a port DeviceDB built from the JAX DeviceDB's
    arrays probes exactly as the JAX one does."""
    db, seqs = corpus
    jdb = E.DeviceDB.from_db(as_jax_db(db))
    fields = {f: (None if getattr(jdb, f) is None
                  else np.asarray(getattr(jdb, f)))
              for f in ("payload_wide", "lo_wide", "fused_wide",
                        "sub_blocks", "sub_header", "bucket_pair", "lo",
                        "payload")}
    fields.update(n=jdb.n, n_steps=jdb.n_steps, wide_w=jdb.wide_w)
    tdb = T.DeviceDB.from_numpy(fields, "cpu")
    offsets, lengths = T.FastAnnotator(db, "cpu").pad_batch(seqs)
    jw = E.encode_windows(jnp.asarray(offsets), jnp.asarray(lengths))
    want = E.probe_windows(jdb, *jw)
    got = T.probe_windows(tdb, *T.encode_windows(
        torch.from_numpy(offsets), torch.from_numpy(lengths)))
    assert np.asarray(want[0]).sum() > 20
    for w, g in zip(want, got):
        assert np.array_equal(bits(w), bits(g.numpy()))


@pytest.mark.parametrize("rows_only,want_code,want_oi,want_avg", [
    (False, True, True, True),
    (False, False, True, True),
    (False, True, False, False),
    (False, False, False, True),
    (True, True, True, True),
    (True, False, False, False),
])
def test_probe_compact_matches_jax(corpus, rows_only, want_code, want_oi,
                                   want_avg):
    db, seqs = corpus
    jfa = E.FastAnnotator(as_jax_db(db))
    tfa = T.FastAnnotator(db, "cpu")
    offsets, lengths = tfa.pad_batch(seqs)
    jo, jl = jfa.pad_batch(seqs)
    assert np.array_equal(offsets, jo) and np.array_equal(lengths, jl)
    kw = dict(want_code=want_code, want_oi=want_oi, want_avg=want_avg,
              rows_only=rows_only)
    want = jfa.probe_compact(offsets, lengths, **kw)
    got = tfa.probe_compact(offsets, lengths, **kw)
    assert sorted(want) == sorted(got)
    assert want["row_off"][-1] > 20
    for k in want:
        assert np.array_equal(bits(want[k]), bits(got[k])), k


def test_probe_compact_cap_overflow_retry(corpus):
    """A 1-hit-per-sequence cap overflows and retries with a bigger one;
    the result equals JAX's, which takes the same retry."""
    db, seqs = corpus
    jfa = E.FastAnnotator(as_jax_db(db))
    tfa = T.FastAnnotator(db, "cpu")
    offsets, lengths = tfa.pad_batch(seqs)
    want = jfa.probe_compact(offsets, lengths, hits_per_seq_cap=1)
    got = tfa.probe_compact(offsets, lengths, hits_per_seq_cap=1)
    assert got["row_off"][-1] > len(seqs)      # the first cap did overflow
    for k in want:
        assert np.array_equal(bits(want[k]), bits(got[k])), k


def _bucket_db(depth, lo_span, fi_max=50, n_extra=50, seed=0):
    """DB with one bucket of ``depth`` keys whose lo codes lie in
    [0, lo_span), plus ``n_extra`` keys in other buckets."""
    rng = np.random.default_rng(seed)
    deep = 7 * LO_CARD + rng.choice(lo_span, size=depth, replace=False)
    extra = rng.choice(np.arange(100, 3_000_000), size=n_extra,
                       replace=False) * LO_CARD
    keys = np.concatenate([deep, extra]).astype(np.int64)
    n = len(keys)
    return SignatureDB(keys, rng.integers(0, fi_max, size=n).astype(np.int32),
                       np.zeros(n, np.int32), np.zeros(n, np.int32),
                       np.ones(n, np.float32))


def _probe_both(jdb, tdb, offsets, lengths):
    """(JAX probe_windows, port probe_windows) on one padded batch."""
    want = E.probe_windows(jdb, *E.encode_windows(jnp.asarray(offsets),
                                                  jnp.asarray(lengths)))
    got = T.probe_windows(tdb, *T.encode_windows(torch.from_numpy(offsets),
                                                 torch.from_numpy(lengths)))
    for w, g in zip(want, got):
        assert np.array_equal(bits(w), bits(g.numpy()))
    return got


@pytest.mark.parametrize("db_args,tier", [
    (dict(depth=40, lo_span=LO_CARD), "fused_wide"),
    (dict(depth=130, lo_span=LO_CARD), "sub_blocks"),
    (dict(depth=300, lo_span=512), "binary_search"),
])
def test_unported_tiers_raise(db_args, tier):
    """One bucket past each JAX gate: the JAX auto-ladder picks ``tier``,
    and the port, forced to it by the flags that build it, builds and
    probes it as JAX does instead of raising, hits included (windows
    spelled from the deep bucket's keys)."""
    db = _bucket_db(**db_args)
    assert T.jax_tier(db) == tier
    jdb = E.DeviceDB.from_db(as_jax_db(db))
    tdb = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS[tier])
    layouts = [f for f in ("fused_wide", "payload_wide", "sub_blocks",
                           "lo_wide") if getattr(jdb, f) is not None]
    assert tdb.tier == tier and layouts == ([] if tier == "binary_search"
                                            else [tier])
    pow20 = 20 ** np.arange(7, -1, -1, dtype=np.int64)
    keys = db.keys[:db_args["depth"]].reshape(-1, 10)       # the deep bucket
    offsets = ((keys[:, :, None] // pow20) % 20).reshape(len(keys), -1)
    offsets = np.concatenate([offsets, np.full((len(keys), 9), 20)],
                             axis=1).astype(np.uint8)
    lengths = np.full(len(keys), offsets.shape[1] - 1, dtype=np.int32)
    got = _probe_both(jdb, tdb, offsets, lengths)
    assert int(got[0].sum()) == db_args["depth"]


def test_empty_db_raises():
    """test_engine.py's test_empty_db on the port: an empty DB builds the
    binary-search tier instead of raising, and every window misses, as
    in JAX."""
    db = SignatureDB(np.zeros(0, np.int64), np.zeros(0, np.int32),
                     np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32))
    tdb = T.DeviceDB.from_db(db, "cpu")
    assert T.jax_tier(db) == tdb.tier == "binary_search"
    offsets = np.full((2, 24), 20, np.uint8)
    offsets[0, :14] = [10, 8, 9, 17, 7, 11, 5, 8, 16, 0, 1, 2, 3, 4]
    lengths = np.array([14, 0], np.int32)
    got = _probe_both(E.DeviceDB.from_db(as_jax_db(db)), tdb, offsets,
                      lengths)
    assert not got[0].any() and (got[5] == 0).all()


TIER_FLAGS = {
    "lo_wide": dict(wide=True, wide_payload=False, fused=False),
    "fused_wide": dict(wide=False, sub=False),
    "sub_blocks": dict(wide=False, sub=True, fused=False),
    "binary_search": dict(wide=False, sub=False, wide_lo=False, fused=False),
}


@pytest.mark.parametrize("tier", list(TIER_FLAGS))
def test_from_numpy_unported_tiers_raise(corpus, tier):
    """The state carry-over of a JAX DeviceDB forced into each tier: it
    builds and probes as JAX does instead of raising."""
    db, seqs = corpus
    jdb = E.DeviceDB.from_db(as_jax_db(db), **TIER_FLAGS[tier])
    fields = {f: (None if getattr(jdb, f) is None
                  else np.asarray(getattr(jdb, f)))
              for f in T.DeviceDB.ARRAYS}
    fields.update(n=jdb.n, n_steps=jdb.n_steps, wide_w=jdb.wide_w,
                  sub_w=jdb.sub_w, fused_w=jdb.fused_w)
    tdb = T.DeviceDB.from_numpy(fields, "cpu")
    assert tdb.tier == tier
    offsets, lengths = T.FastAnnotator(db, "cpu").pad_batch(seqs)
    got = _probe_both(jdb, tdb, offsets, lengths)
    assert int(got[0].sum()) > 20


def test_engines_need_an_explicit_device(corpus):
    db, _ = corpus
    with pytest.raises(ValueError):
        T.FastAnnotator(db, None)
