"""Port parity for device best-call: ``ops.best_call.best_call_plain``
against ``close_kmers_tpu/core/device_score.py::_best_call_device`` on the
same numpy-seeded scan outputs, and the port's ``probe_best`` /
``DeviceScorer.best_batch_packed`` / ``finish_best_batch`` /
``best_calls_batch`` against the JAX DeviceScorer on
``tests/test_device_best.py``'s four cases.  Zero tolerance: the [B, 9]
packs compare as int32 (the weights by their f32 bits), BestCalls field by
field with floats by bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from close_kmers_tpu.core import device_score as JD
from close_kmers_tpu.core.engine import FastAnnotator as JFA
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.core import device_score as TD
from close_kmers_tpu_torch.ops.best_call import CAPC, best_call, \
    best_call_plain

from test_device_best import _db_from_calls
from test_engine import random_db, random_seqs
from test_torch_host import as_jax_db, as_port_db, assert_same

_jax_best = jax.jit(JD._best_call_device)


def jax_pack(emit, cnt, fi, wt) -> np.ndarray:
    """_best_call_device's outputs stacked as _probe_best_jit stacks
    them: [B, 9] int32, weights as bits, overflow as 0/1."""
    r = [np.asarray(x) for x in _jax_best(*map(jnp.asarray,
                                              (emit, cnt, fi, wt)))]
    return np.stack([r[0], r[1], r[2], r[3].view(np.int32), r[4], r[5],
                     r[6].view(np.int32), r[7], r[8].astype(np.int32)],
                    axis=1)


def port_pack(emit, cnt, fi, wt) -> np.ndarray:
    return best_call(*(torch.from_numpy(np.ascontiguousarray(x))
                       for x in (emit, cnt, fi, wt))).numpy()


WEIGHTS = np.array([0.1, 0.3, 0.5, 1.0, 1.5, 2.0], np.float32)


def random_case(rng, B, M, p_emit, n_funcs):
    """Random scan outputs: emit with rate ``p_emit``, counts 1-13 (so
    bridges both merge and not), few functions and a small weight set
    (so totals tie)."""
    emit = rng.random((B, M)) < p_emit
    cnt = rng.integers(1, 14, size=(B, M)).astype(np.int32)
    fi = rng.integers(0, n_funcs, size=(B, M)).astype(np.int32)
    wt = rng.choice(WEIGHTS, size=(B, M))
    return emit, cnt, fi, wt


@pytest.mark.parametrize("B,M", [(1, 2), (40, 2), (24, 15), (24, 16),
                                 (64, 17), (64, 32), (64, 33), (48, 64),
                                 (16, 313), (8, 511), (8, 512), (8, 513),
                                 (4, 1017)])
@pytest.mark.parametrize("p_emit", [0.05, 0.4, 0.95])
def test_plain_matches_jax_random(B, M, p_emit):
    rng = np.random.default_rng(B * 1000 + M + int(p_emit * 100))
    case = random_case(rng, B, M, p_emit, n_funcs=2 + M % 4)
    want = jax_pack(*case)
    np.testing.assert_array_equal(port_pack(*case), want)
    if M > CAPC and p_emit > 0.9:
        assert want[:, 8].any()            # overflow rows are in the mix


def _rows(rows, M):
    """Scan outputs from explicit call lists: row r emits its calls
    (count, fi, wt) at spread columns of an M-wide row."""
    B = len(rows)
    emit = np.zeros((B, M), bool)
    cnt = np.zeros((B, M), np.int32)
    fi = np.full((B, M), 7, np.int32)
    wt = np.full((B, M), 9.0, np.float32)      # non-emitted junk
    for r, calls in enumerate(rows):
        cols = np.linspace(0, M - 1, num=len(calls)).astype(int) \
            if len(calls) > 1 else np.array([M - 1])[:len(calls)]
        assert len(set(cols.tolist())) == len(calls)
        for c, (n, f, w) in zip(cols, calls):
            emit[r, c] = True
            cnt[r, c], fi[r, c], wt[r, c] = n, f, w
    return emit, cnt, fi, wt


CONSTRUCTED = [
    [],                                                  # no call
    [(6, 1, 1.0)],                                       # one function
    [(6, 1, 1.0), (6, 2, 1.0)],                          # full tie of two
    [(8, 3, 1.0), (8, 4, 1.0), (6, 5, 1.0)],             # tie at the top
    [(7, 6, 2.0), (7, 7, 2.0), (7, 8, 2.0)],             # full-tie triple
    [(7, 8, 2.0), (7, 6, 2.0), (7, 7, 2.0)],             # ... reordered
    [(20, 11, 1.0), (18, 12, 1.0), (6, 13, 1.0)],        # pair offset
    [(6, 1, 1.0), (4, 2, 1.0), (6, 1, 1.0)],             # bridge merges
    [(6, 3, 1.0), (5, 4, 1.0), (6, 3, 1.0)],             # held too big
    [(3, 3, 1.0), (2, 4, 1.0), (6, 3, 1.0)],             # sum below 10
    [(6, 1, 1.0), (4, 2, 1.0), (6, 1, 1.0), (2, 5, 0.5), (9, 1, 3.0)],
    [(2, 1, 0.5), (3, 1, 0.5), (4, 2, 0.1), (1, 2, 0.3)],  # collapses
    [(5, 2, -0.0), (5, 3, 0.0)],                         # signed zeros
    [(5, 2, 1.5), (5, 3, 1.5), (5, 4, 1.5), (5, 5, 1.5), (5, 6, 1.5)],
]


@pytest.mark.parametrize("M", [15, 16, 17, 20, 32, 33, 313, 511, 512, 513,
                               1017])
def test_plain_matches_jax_constructed(M):
    """Ties, bridges, full-tie triples, collapses, signed zeros, and rows
    of exactly 32 and 33 calls (the cap and one past it), at M up to and
    past the cap and across the kernel's 16-B words and 512-B rounds."""
    rows = [r for r in CONSTRUCTED if len(r) <= M]
    for n in (31, 32, 33, 40):
        if n <= M:
            rows.append([(1 + k % 5, k % 3, WEIGHTS[k % 6]) for k in range(n)])
    case = _rows(rows, M)
    want = jax_pack(*case)
    np.testing.assert_array_equal(port_pack(*case), want)
    assert want[:, 8].tolist() == [int(len(r) > CAPC) for r in rows]
    # rows with n_funcs == 0 give +0.0 weights, -0.0 where the sums say
    assert (want[0, [3, 6]] == 0).all()


def test_strided_planes_match_contiguous():
    """The scan's call planes are views of one [5, B, W+1] allocation;
    the wrapper reads them by their strides (rows of other planes
    between them)."""
    rng = np.random.default_rng(3)
    emit, cnt, fi, wt = random_case(rng, 24, 40, 0.5, 3)
    planes = torch.zeros((5, 24, 40), dtype=torch.int32)
    planes[2], planes[3] = torch.from_numpy(cnt), torch.from_numpy(fi)
    planes[4] = torch.from_numpy(wt).view(torch.int32)
    got = best_call(torch.from_numpy(emit), planes[2], planes[3],
                    planes[4].view(torch.float32))
    np.testing.assert_array_equal(got.numpy(), jax_pack(emit, cnt, fi, wt))


@pytest.mark.parametrize("M", [513, 1017])
def test_plain_matches_jax_33rd_call_far(M):
    """Rows whose 33rd call lies past column 480 (the kernel's second
    512-B round, or the last bytes of its first), beside rows of exactly
    32 calls ending in the last column: only the first are flagged."""
    rng = np.random.default_rng(M)
    emit, cnt, fi, wt = random_case(rng, 8, M, 0.0, 3)
    for r, last in enumerate((481, 496, 511, 512, M - 1, 500, 490, M - 1)):
        emit[r, rng.choice(400, size=32 - (r == 7), replace=False)] = True
        emit[r, last] = True            # row 7: 32 calls, the last at M - 1
    want = jax_pack(emit, cnt, fi, wt)
    np.testing.assert_array_equal(port_pack(emit, cnt, fi, wt), want)
    assert want[:, 8].tolist() == [int(n > CAPC) for n in emit.sum(axis=1)]


@pytest.mark.parametrize("col0", [1, 3, 15, 16])
@pytest.mark.parametrize("M", [16, 305, 513])
def test_offset_views_match_jax(col0, M):
    """emit and the call planes as column slices of wider arrays: each
    row starts ``col0`` bytes into rows of col0 + M + 21 (on and off 16-B
    alignment, stride(0) != M), with calls in the first and last byte of
    rows."""
    rng = np.random.default_rng(col0 * 1000 + M)
    W = col0 + M + 21
    emit, cnt, fi, wt = random_case(rng, 12, W, 0.3, 3)
    emit[0, col0] = emit[1, col0 + M - 1] = True
    emit[2, col0], emit[2, col0 + M - 1] = True, True
    sl = slice(col0, col0 + M)
    views = [torch.from_numpy(x)[:, sl] for x in (emit, cnt, fi, wt)]
    assert views[0].stride(0) != M
    want = jax_pack(*(np.ascontiguousarray(x[:, sl])
                      for x in (emit, cnt, fi, wt)))
    np.testing.assert_array_equal(best_call(*views).numpy(), want)


def test_wrapper_checks():
    rng = np.random.default_rng(4)
    emit, cnt, fi, wt = (torch.from_numpy(x)
                         for x in random_case(rng, 4, 8, 0.5, 2))
    with pytest.raises(TypeError):
        best_call(emit.to(torch.int32), cnt, fi, wt)
    with pytest.raises(TypeError):
        best_call(emit, cnt, fi, wt.double())
    with pytest.raises(ValueError):
        best_call(emit, cnt[:, :4], fi, wt)
    assert best_call(emit[:0], cnt[:0], fi[:0], wt[:0]).shape == (0, 9)
    before = best_call.launches
    best_call_plain(emit, cnt, fi, wt)
    best_call(emit, cnt, fi, wt)
    assert best_call.launches == before    # the CPU path launches nothing


# -- the fused path on test_device_best.py's four cases ---------------------

def _scorers(jdb):
    db = as_port_db(jdb)
    return db, JD.DeviceScorer(jdb), TD.DeviceScorer(db, "cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(321)
    jdb = random_db(rng)
    seqs = random_seqs(rng, jdb, n=64)
    return (*_scorers(jdb), seqs)


def _check_fused(jdb, jds, tds, seqs, params):
    offsets, lengths = JFA(jdb).pad_batch(seqs)
    want = np.asarray(jds.best_batch_packed(offsets, lengths, params))
    got = tds.best_batch_packed(offsets, lengths, params)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if not want[:, 8].any():
        assert_same(TD.DeviceScorer.finish_best_batch(got.numpy(),
                                                      jdb.function_of),
                    JD.DeviceScorer.finish_best_batch(want, jdb.function_of))
    assert_same(tds.best_calls_batch(offsets, lengths, jdb.function_of,
                                     params),
                jds.best_calls_batch(offsets, lengths, jdb.function_of,
                                     params))
    return want


@pytest.mark.parametrize("params", [
    EngineParams(), EngineParams(min_hits=2, max_gap=40),
    EngineParams(min_hits=1), EngineParams(order_constraint=1, min_hits=2)])
def test_fused_matches_jax(corpus, params):
    db, jds, tds, seqs = corpus
    want = _check_fused(jds.db, jds, tds, seqs, params)
    assert (want[:, 0] > 0).sum() > 10


def test_fused_tie_cases():
    groups = [[(6, 1, 1.0), (6, 2, 1.0)],
              [(8, 3, 1.0), (8, 4, 1.0), (6, 5, 1.0)],
              [(7, 6, 2.0), (7, 7, 2.0), (7, 8, 2.0)],
              [(12, 9, 1.0), (5, 10, 1.0)],
              [(20, 11, 1.0), (18, 12, 1.0), (6, 13, 1.0)]]
    jdb, seqs = _db_from_calls(groups)
    db, jds, tds = _scorers(jdb)
    want = _check_fused(jdb, jds, tds, seqs, EngineParams(min_hits=3))
    assert (want[:, 0] >= 2).sum() >= 4


def test_fused_bridge_merge():
    groups = [[(6, 1, 1.0), (4, 2, 1.0), (6, 1, 1.0)],
              [(6, 3, 1.0), (5, 4, 1.0), (6, 3, 1.0)]]
    jdb, seqs = _db_from_calls(groups)
    db, jds, tds = _scorers(jdb)
    want = _check_fused(jdb, jds, tds, seqs, EngineParams(min_hits=3))
    assert want[0, 0] == 1 and want[1, 0] == 2     # merged, then not


def test_fused_overflow_fallback():
    """A row of 40 calls trips the cap flag: the [B, 9] packs agree on
    it too, finish_best_batch raises, and best_calls_batch scores it
    again through the compact-call path."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    rng = np.random.default_rng(99)
    alpha = "ACDEFGHIKLMNPQRSTVWY"
    kmers = []
    while len(kmers) < 40:
        k = "".join(rng.choice(list(alpha), size=8))
        if k not in kmers:
            kmers.append(k)
    jdb = SignatureDB.from_entries(
        [(k, 5, i, 1.0, -1) for i, k in enumerate(kmers)],
        functions=[f"f{i}" for i in range(40)])
    db, jds, tds = _scorers(jdb)
    seqs = ["".join(k + k for k in kmers), kmers[0] * 3]
    params = EngineParams(min_hits=1)
    want = _check_fused(jdb, jds, tds, seqs, params)
    assert want[:, 8].tolist() == [1, 0]
    offsets, lengths = JFA(jdb).pad_batch(seqs)
    out = tds.best_batch_packed(offsets, lengths, params).numpy()
    with pytest.raises(OverflowError):
        TD.DeviceScorer.finish_best_batch(out, jdb.function_of)
    TD.DeviceScorer.finish_best_batch(out, jdb.function_of,
                                      overflow="ignore")
