"""Port parity: the payload-wide probe's match-and-select
(close_kmers_tpu_torch.ops.probe_select, plain torch version on the CPU)
against the Pallas kernel select_wide_rows in interpret mode and against
JAX probe_windows with and without CLOSE_KMERS_PALLAS_SELECT.  Every
plane is integer or a bitcast f32, so the tolerance is zero."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import engine as E
from close_kmers_tpu.db.signature_db import SignatureDB
from close_kmers_tpu.ops.encoder import decode_kmer, seq_to_offsets
from close_kmers_tpu.ops.pallas_select import select_wide_rows
from close_kmers_tpu.params import HI_CARD, LO_CARD
from close_kmers_tpu_torch.ops.probe_select import probe_select

WDS = [1, 7, 32]


def deep_bucket_db(rng, wd, n=3000):
    """Random DB whose deepest bucket holds exactly ``wd`` keys: n keys
    in distinct hi buckets plus one bucket filled to depth wd."""
    his = rng.choice(HI_CARD, size=n + 1, replace=False).astype(np.int64)
    keys = his[:n] * LO_CARD + rng.integers(0, LO_CARD, size=n)
    deep = his[n] * LO_CARD + rng.choice(LO_CARD, size=wd, replace=False)
    keys = np.concatenate([keys, deep])
    m = len(keys)
    db = SignatureDB(keys, rng.integers(0, 50, size=m).astype(np.int32),
                     rng.integers(-1, 8, size=m).astype(np.int32),
                     rng.integers(0, 300, size=m).astype(np.int32),
                     rng.uniform(0.1, 3.0, size=m).astype(np.float32))
    db._deep = np.sort(deep)
    return db


@pytest.fixture(scope="module", params=WDS)
def case(request):
    """(db, JAX DeviceDB, offsets, lengths) with planted hits (among them
    the deep bucket's first and last lanes), misses and invalid
    windows."""
    wd = request.param
    rng = np.random.default_rng(100 + wd)
    db = deep_bucket_db(rng, wd)
    assert db.max_bucket == wd
    ddb = E.DeviceDB.from_db(db)
    assert ddb.payload_wide is not None and ddb.wide_w == wd
    B, L = 16, 64
    offsets = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(20, L, size=B).astype(np.int32)
    for b in range(B):
        for start in (2, 20, 40):
            code = (db._deep[b % wd] if start == 2 else db._deep[-1]
                    if start == 20 else db.keys[rng.integers(0, len(db))])
            offsets[b, start:start + 8] = seq_to_offsets(decode_kmer(int(code)))
    offsets[3, 10:14] = 20                    # invalid residues
    offsets[5, :] = seq_to_offsets("x" * L)   # lowercase: all invalid
    return db, ddb, offsets, lengths


def jax_windows(offsets, lengths):
    hi, lo, valid = E.encode_windows(jnp.asarray(offsets),
                                     jnp.asarray(lengths))
    return hi, lo, valid


def port_probe(ddb, hi, lo, valid):
    pw = torch.from_numpy(np.array(ddb.payload_wide))
    flat = [torch.from_numpy(np.array(x).reshape(-1))
            for x in (hi, lo, valid)]
    return [x.numpy() for x in probe_select(*flat, pw, ddb.wide_w, ddb.n)]


def as_bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_select_matches_pallas_kernel(case):
    """Raw selection of the Pallas kernel (interpret mode) plus the JAX
    miss masking equals the port's probe_select plane by plane."""
    db, ddb, offsets, lengths = case
    hi, lo, valid = jax_windows(offsets, lengths)
    hi_c = jnp.where(valid, hi, 0).reshape(-1)
    lo_c = jnp.where(valid, lo, -2).reshape(-1)
    rows = ddb.payload_wide[hi_c]
    sel = select_wide_rows(rows, lo_c, ddb.wide_w, interpret=True)
    want = E._finish_select(
        (sel[:, 0] > 0, sel[:, 1], sel[:, 2], sel[:, 3], sel[:, 4],
         sel[:, 5]), (hi_c.shape[0],), valid.reshape(-1), ddb.n)
    got = port_probe(ddb, hi, lo, valid)
    assert got[0].sum() >= offsets.shape[0] - 1   # planted hits were found
    assert (~got[0]).sum() > 0                    # and misses exist
    for k, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        assert w.dtype == g.dtype, k
        assert np.array_equal(as_bits(w), as_bits(g)), k


@pytest.mark.parametrize("pallas_env", [None, "1"])
def test_probe_matches_jax_probe_windows(case, pallas_env, monkeypatch):
    """JAX probe_windows (XLA masked-sum selection, or the Pallas
    selection pass when CLOSE_KMERS_PALLAS_SELECT=1) equals the port."""
    db, ddb, offsets, lengths = case
    if pallas_env is None:
        monkeypatch.delenv("CLOSE_KMERS_PALLAS_SELECT", raising=False)
    else:
        monkeypatch.setenv("CLOSE_KMERS_PALLAS_SELECT", pallas_env)
    hi, lo, valid = jax_windows(offsets, lengths)
    want = [np.asarray(x).reshape(-1)
            for x in E.probe_windows(ddb, hi, lo, valid)]
    got = port_probe(ddb, hi, lo, valid)
    for k, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(as_bits(w), as_bits(g)), k
    # the miss conventions: fi = oi = -1, avg_off = 0, wt = 0.0, idx = n
    miss = ~got[0]
    assert (got[1][miss] == -1).all() and (got[2][miss] == -1).all()
    assert (got[3][miss] == 0).all() and (got[4][miss] == 0).all()
    assert (got[5][miss] == ddb.n).all()


def test_cpu_tensors_take_the_plain_version(case):
    db, ddb, offsets, lengths = case
    before = probe_select.launches
    port_probe(ddb, *jax_windows(offsets, lengths))
    assert probe_select.launches == before


def _args():
    N = 4
    return dict(hi=torch.zeros(N, dtype=torch.int32),
                lo=torch.zeros(N, dtype=torch.int32),
                valid=torch.ones(N, dtype=torch.bool),
                payload_wide=torch.zeros((3, 6), dtype=torch.int32),
                wd=1, n=0)


@pytest.mark.parametrize("bad", [
    dict(hi=torch.zeros(4, dtype=torch.int64)),
    dict(valid=torch.ones(4, dtype=torch.int32)),
    dict(payload_wide=torch.zeros((3, 6), dtype=torch.float32)),
    dict(lo=torch.zeros(5, dtype=torch.int32)),
    dict(wd=2),
    dict(hi=torch.zeros((2, 2), dtype=torch.int32)),
])
def test_probe_select_rejects_bad_inputs(bad):
    args = dict(_args(), **bad)
    with pytest.raises((TypeError, ValueError)):
        probe_select(**args)
