"""Port parity for core/matrix.py: the packed pair buffer of one chunk
(pads included), DeviceMatrix.count_pairs and matrix_distance against
the JAX package on the same numpy-seeded inputs, and against the numpy
replay of the reference's registration-order rule
(tests/test_matrix.py::_host_pairs).  Zero tolerance: integers exactly.

Two cases differ from the JAX package on purpose (ADVICE.md, high): the
rank array is uploaded on every request, and the staged CSR is cached
against the mapping's CSR object, never by ``id()``."""

import gc

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import matrix as JM
from close_kmers_tpu.core.api import KmerEngine as JaxEngine
from close_kmers_tpu.db import family_db as JFD
from close_kmers_tpu_torch.core import matrix as TM
from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.db import family_db as TFD
from close_kmers_tpu_torch.ops import encoder

from test_matrix import _host_pairs, _mk_db
from test_torch_host import as_jax_db, as_port_db


def corpus(seed, n_src=300, P=100, max_deg=3, n_pegs=None):
    """tests/test_matrix.py's set-up: a DB, a degree 0..max_deg CSR over
    its rows with peg ids in [0, n_pegs), rank = id for the first P
    pegs, and P query proteins of DB source proteins."""
    rng = np.random.default_rng(seed)
    db, off = _mk_db(rng, n_src=n_src)
    db = as_port_db(db)
    n = len(db)
    deg = rng.integers(0, max_deg + 1, size=n)
    peg_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=peg_offs[1:])
    peg_vals = rng.integers(0, n_pegs or 2 * P, size=int(peg_offs[-1]))
    rank = np.full(n_pegs or 2 * P, 1 << 20, dtype=np.int64)
    rank[:P] = np.arange(P)
    qi = rng.integers(0, len(off), size=P)
    plen = off.shape[1]
    width = -(-(plen + 8) // 8) * 8
    offsets = np.full((P, width), 20, dtype=np.uint8)
    offsets[:, :plen] = off[qi]
    lengths = np.full(P, plen, dtype=np.int32)
    return (db, JaxEngine(as_jax_db(db)), KmerEngine(db, "cpu"),
            (offsets, lengths, peg_offs, peg_vals, rank))


@pytest.mark.parametrize("pair_cap", [16, 760, 4096])
def test_matrix_pairs_buffer_matches_jax(pair_cap):
    """The [1 + 2 * pair_cap] buffer word for word: a cap below the
    chunk's pairs (overflow), one just above, and a roomy one whose pad
    slots hold sk[N - 1] and zero counts."""
    _db, jeng, teng, (offsets, lengths, peg_offs, peg_vals, rank) = \
        corpus(0)
    jdm = JM.DeviceMatrix(jeng, max_deg=3)
    tdm = TM.DeviceMatrix(teng, max_deg=3)
    po, pv, rk = jdm._stage_csr(peg_offs, peg_vals, rank)
    d = jeng.fa.ddb
    off, lens = offsets[:64], lengths[:64]
    want = np.asarray(JM._matrix_pairs_jit(
        d.bucket_pair, d.lo, d.payload, d.n, d.n_steps, jnp.asarray(off),
        jnp.asarray(lens), jnp.int32(5), po, pv, rk, 3, pair_cap,
        d.lo_wide, d.payload_wide, d.wide_w, d.sub_header, d.sub_blocks,
        d.sub_w, d.fused_wide, d.fused_w))
    tpo, tpv = tdm.stage_csr(peg_offs, peg_vals)
    assert np.array_equal(tpo.numpy(), np.asarray(po))
    assert np.array_equal(tpv.numpy(), np.asarray(pv))
    got = TM._matrix_pairs(teng.fa.ddb, torch.from_numpy(off),
                           torch.from_numpy(lens), 5, tpo, tpv,
                           torch.from_numpy(rank.astype(np.int32)), 3,
                           pair_cap).numpy()
    assert got.dtype == np.int32 and got.shape == (1 + 2 * pair_cap,)
    assert np.array_equal(got, want)
    assert 16 < int(got[0]) <= 760


@pytest.mark.parametrize("seed", [0, 1])
def test_count_pairs_matches_jax(seed):
    """tests/test_matrix.py's parity case: CHUNK = 64 (several chunks, a
    padded tail), against JAX and the registration-order replay."""
    _db, jeng, teng, args = corpus(seed, max_deg=3)
    jdm = JM.DeviceMatrix(jeng, max_deg=4)
    tdm = TM.DeviceMatrix(teng, max_deg=4)
    jdm.CHUNK = tdm.CHUNK = 64
    offsets, lengths, peg_offs, peg_vals, rank = args
    want = jdm.count_pairs(*args, pair_cap=1 << 14)
    got = tdm.count_pairs(offsets, lengths, *tdm.stage_csr(peg_offs,
                                                           peg_vals),
                          rank, pair_cap=1 << 14)
    assert got == want == _host_pairs(teng, *args)
    assert sum(got.values()) > 100


def test_count_pairs_cap_retry():
    """pair_cap = 4 overflows every chunk; the x4 retry reruns the whole
    request (staged CSR reused) and ends with JAX's pairs."""
    _db, jeng, teng, args = corpus(2, n_src=50, P=40, max_deg=1)
    jdm = JM.DeviceMatrix(jeng, max_deg=1)
    tdm = TM.DeviceMatrix(teng, max_deg=1)
    tdm.CHUNK = 16
    staged = tdm.stage_csr(*args[2:4])
    got = tdm.count_pairs(*args[:2], *staged, args[4], pair_cap=4)
    assert got == jdm.count_pairs(*args, pair_cap=4) \
        == _host_pairs(teng, *args)
    assert len(got) > 4


def test_count_pairs_gates():
    _db, _jeng, teng, (offsets, lengths, peg_offs, peg_vals, rank) = \
        corpus(3, n_src=20, P=4)
    tdm = TM.DeviceMatrix(teng)
    big = np.zeros((TM.DeviceMatrix.CHUNK * 16 + 1, 8), np.uint8)
    with pytest.raises(ValueError, match="pair-key"):
        tdm.count_pairs(big, np.zeros(len(big), np.int32),
                        *tdm.stage_csr(peg_offs, peg_vals), rank)
    with pytest.raises(ValueError, match="int32"):
        tdm.stage_csr(np.array([0, 1 << 31], np.int64), np.zeros(1))
    po, pv = tdm.stage_csr(np.zeros(len(teng.db) + 1, np.int64),
                           np.zeros(0, np.int64))   # empty vals: [0]
    assert pv.tolist() == [0] and po.shape == (len(teng.db) + 2,)


def alpha(offsets, lengths):
    a = np.frombuffer(encoder.PROT_ALPHA.encode(), np.uint8)
    return [a[offsets[i, :lengths[i]]].tobytes().decode()
            for i in range(len(offsets))]


def add_mapping(engines, items, mappings):
    """/add-style registration into one mapping of each package: every
    hit kmer of every protein maps to its peg (add_request.cc)."""
    for eng, m in zip(engines, mappings):
        results, _h = eng.annotate_with_hits(items, want_hits=True)
        for r in results:
            pid = m.encode_peg(r.seq_id)
            for h in r.hits:
                m.add_peg_mapping(pid, h.code)


def test_matrix_distance_matches_jax():
    """matrix_distance on a mapping built by add_peg_mapping calls, the
    query proteins half registered and half new, against JAX."""
    _db, jeng, teng, (offsets, lengths, *_r) = corpus(4, P=60)
    seqs = alpha(offsets, lengths)
    maps = (JFD.KmerFamilyMapping(), TFD.KmerFamilyMapping())
    add_mapping((jeng, teng), [(f"p{i}", s) for i, s in
                               enumerate(seqs[:30])], maps)
    items = [(f"p{i}", s) for i, s in enumerate(seqs)]
    want = JM.matrix_distance(jeng, maps[0], items)
    got = TM.matrix_distance(teng, maps[1], items)
    assert got is not None and got == want
    assert sum(got.values()) > 50
    assert maps[1].peg_to_id == maps[0].peg_to_id


def test_matrix_distance_gates():
    """None where JAX returns None: duplicate ids, a degree past
    max_deg, more than 2^15 proteins; an empty request too."""
    _db, jeng, teng, (offsets, lengths, *_r) = corpus(5, P=12)
    seqs = alpha(offsets, lengths)
    maps = (JFD.KmerFamilyMapping(), TFD.KmerFamilyMapping())
    add_mapping((jeng, teng), [(f"p{i}", s) for i, s in enumerate(seqs)],
                maps)
    dup = [("p0", seqs[0]), ("p1", seqs[1]), ("p0", seqs[2])]
    assert JM.matrix_distance(jeng, maps[0], dup) is None
    assert TM.matrix_distance(teng, maps[1], dup) is None
    many = [(f"x{i}", "MKV") for i in range((1 << TM.PAIR_SHIFT) + 1)]
    assert TM.matrix_distance(teng, maps[1], many) is None
    assert TM.matrix_distance(teng, maps[1], []) is None
    kmer = int(teng.db.keys[0])
    for m in maps:                   # one kmer of degree 9 > max_deg 8
        for p in range(9):
            m.add_peg_mapping(p, kmer)
    items = [(f"p{i}", s) for i, s in enumerate(seqs)]
    assert JM.matrix_distance(jeng, maps[0], items) is None
    assert TM.matrix_distance(teng, maps[1], items) is None


def test_rank_is_uploaded_per_request():
    """Two requests of the same size, different proteins: each gets its
    own counts.  The JAX package caches the rank array by id() and may
    serve the first request's rank to the second (ADVICE.md, high); the
    port differs from it on purpose, so the reference here is a fresh
    JAX engine per request and the registration-order replay."""
    db, _jeng, teng, (offsets, lengths, *_r) = corpus(6, n_src=10, P=40)
    seqs = alpha(offsets, lengths)
    mapping = TFD.KmerFamilyMapping()
    add_mapping((teng,), [(f"p{i}", s) for i, s in enumerate(seqs)],
                (mapping,))
    got = []
    for a in (0, 20):
        items = [(f"p{i}", seqs[i]) for i in range(a, a + 20)]
        jm = JFD.KmerFamilyMapping()
        add_mapping((JaxEngine(as_jax_db(db)),),
                    [(f"p{i}", s) for i, s in enumerate(seqs)], (jm,))
        want = JM.matrix_distance(JaxEngine(as_jax_db(db)), jm, items)
        got.append(TM.matrix_distance(teng, mapping, items))
        assert got[-1] == want and sum(want.values()) > 0
    assert got[0] != got[1]
    assert len(teng._device_matrices) == 1       # one DeviceMatrix reused


def test_staged_csr_follows_the_mapping():
    """The staged CSR is reused while the mapping's CSR tuple is the same
    object, rebuilt after add_peg_mapping, and the engine's DeviceMatrix
    goes with its mapping."""
    _db, _jeng, teng, (offsets, lengths, *_r) = corpus(7, P=10)
    seqs = alpha(offsets, lengths)
    mapping = TFD.KmerFamilyMapping()
    add_mapping((teng,), [(f"p{i}", s) for i, s in enumerate(seqs[:5])],
                (mapping,))
    dm = teng._device_matrix(mapping)
    assert teng._device_matrix(mapping) is dm
    first = dm.mapping_csr(teng.db.keys, mapping)
    assert dm.mapping_csr(teng.db.keys, mapping) is first
    add_mapping((teng,), [("p9", seqs[9])], (mapping,))
    second = dm.mapping_csr(teng.db.keys, mapping)
    assert second is not first
    assert int(second[0][-1]) > int(first[0][-1])
    del mapping, dm
    gc.collect()
    assert len(teng._device_matrices) == 0
