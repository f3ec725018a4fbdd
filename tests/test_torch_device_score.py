"""Port parity for core/device_score: DeviceScorer.score_batch and
score_batch_packed (slim 0/2/3) against the JAX DeviceScorer on the same
DB and inputs, comparing unpacked calls (never the packed buffer's tail
past the emitted total).  Zero tolerance: integers exactly, f32 weights
via their bits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import device_score as JD
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.core import device_score as TD
from close_kmers_tpu_torch.core.engine import FastAnnotator

from test_engine import random_db, random_seqs

PARAMS = [
    EngineParams(),
    EngineParams(min_hits=2, max_gap=40),
    EngineParams(min_hits=1),
    EngineParams(order_constraint=1, min_hits=2),
    EngineParams(min_weighted_hits=3),
]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(77)
    db = random_db(rng)
    seqs = random_seqs(rng, db, n=48)
    offsets, lengths = FastAnnotator(db, "cpu").pad_batch(seqs)
    return db, offsets, lengths, JD.DeviceScorer(db), \
        TD.DeviceScorer(db, "cpu")


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("params", PARAMS)
def test_score_batch_matches_jax(corpus, params):
    db, offsets, lengths, jds, tds = corpus
    n_w, calls_w = jds.score_batch(offsets, lengths, params,
                                   calls_per_seq_cap=64)
    n_g, calls_g = tds.score_batch(offsets, lengths, params,
                                   calls_per_seq_cap=64)
    assert n_w.tolist() == n_g.tolist()
    assert sum(n_g) > 10
    for cw, cg in zip(calls_w, calls_g):
        assert [c[:4] for c in cw] == [c[:4] for c in cg]
        assert [bits(np.float32(c[4])) for c in cw] == \
            [bits(np.float32(c[4])) for c in cg]


@pytest.mark.parametrize("slim,unpack", [
    (0, "unpack_dense"), (2, "unpack_dense2"), (3, "unpack_dense3")])
@pytest.mark.parametrize("params", [PARAMS[0], PARAMS[2]])
def test_score_batch_packed_matches_jax(corpus, slim, unpack, params):
    db, offsets, lengths, jds, tds = corpus
    out_w, cap_w = jds.score_batch_packed(offsets, lengths, params,
                                          calls_per_seq_cap=16, slim=slim)
    out_g, cap_g = tds.score_batch_packed(offsets, lengths, params,
                                          calls_per_seq_cap=16, slim=slim)
    assert cap_w == cap_g
    B = offsets.shape[0]
    want = getattr(JD.DeviceScorer, unpack)(np.asarray(out_w), B, cap_w)
    got = getattr(TD.DeviceScorer, unpack)(out_g.numpy(), B, cap_g)
    assert want is not None and got is not None
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert np.array_equal(bits(w), bits(g))


def test_slim_mode_and_hit_total_match_jax(corpus):
    db, offsets, lengths, jds, tds = corpus
    assert tds.slim_mode() == jds.slim_mode()
    p = EngineParams()
    d = jds.ddb
    _, hits_w = JD._probe_score_jit(
        d.bucket_pair, d.lo, d.payload, d.n, d.n_steps,
        jnp.asarray(offsets), jnp.asarray(lengths), p.min_hits,
        p.min_weighted_hits, p.max_gap, p.order_constraint, 64, False, 0,
        d.lo_wide, 1, d.payload_wide, d.wide_w)
    _, hits_g = TD.probe_score(tds.ddb, torch.from_numpy(offsets),
                               torch.from_numpy(lengths), p, 64)
    assert int(hits_w) == int(hits_g) > 0


def test_cap_overflow_retry(corpus):
    db, offsets, lengths, jds, tds = corpus
    params = EngineParams(min_hits=1)
    n1, c1 = tds.score_batch(offsets, lengths, params, calls_per_seq_cap=1)
    n2, c2 = tds.score_batch(offsets, lengths, params, calls_per_seq_cap=64)
    assert n1.sum() > len(n1)          # the first cap did overflow
    assert n1.tolist() == n2.tolist()
    assert c1 == c2


def test_packed_overflow_unpacks_to_none(corpus):
    db, offsets, lengths, jds, tds = corpus
    out, cap = tds.score_batch_packed(offsets, lengths,
                                      EngineParams(min_hits=1),
                                      calls_per_seq_cap=0.25)
    assert TD.DeviceScorer.unpack_dense(out.numpy(), offsets.shape[0],
                                        cap) is None


def test_empty_rows(corpus):
    db, _, _, _, tds = corpus
    offsets = np.full((4, 32), 20, dtype=np.uint8)
    lengths = np.zeros(4, dtype=np.int32)
    n_calls, calls = tds.score_batch(offsets, lengths)
    assert n_calls.tolist() == [0, 0, 0, 0]
    assert calls == [[], [], [], []]
