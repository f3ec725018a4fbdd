"""Port parity for the family path: the row_gather, famwide_select and
family_group wrappers (plain torch versions on the CPU),
``rollup_from_fams`` in its per-row, global and hierarchical packs,
``DeviceFamilyScorer`` on the famwide and two-gather paths, and the
family methods of ``KmerEngine``, each against the JAX package on JAX's
CPU backend (Pallas in interpret mode).  Integers compare exactly and f32
by its int32 bits; packs compare through the ``finish_rollup*`` parsers,
never by the slots past ``n_per_seq`` (the JAX program leaves scan state
there).  Also the JAX tests of ``tests/test_device_family.py`` run on the
port."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import device_family as JF
from close_kmers_tpu.core.api import KmerEngine as JaxEngine
from close_kmers_tpu.core.device_score import DeviceScorer as JaxScorer
from close_kmers_tpu.core.engine import DeviceDB as JaxDeviceDB
from close_kmers_tpu.core.engine import FastAnnotator as JaxAnnotator
from close_kmers_tpu.core.engine import _pad_flat_probes, _unpad_sel
from close_kmers_tpu.core.engine import encode_windows as jax_encode
from close_kmers_tpu.core.engine import probe_windows as jax_probe
from close_kmers_tpu.ops.pallas_gather import CHUNK, pallas_row_gather
from close_kmers_tpu_torch.core import family as F
from close_kmers_tpu_torch.db.family_db import FamilyData, KmerFamilyMapping
from close_kmers_tpu_torch.params import EngineParams
from close_kmers_tpu_torch.core import api as TA
from close_kmers_tpu_torch.core import device_family as TF
from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.core.engine import FastAnnotator
from close_kmers_tpu_torch.ops.family_group import (SMEM_MAX_COLS,
                                                    family_group)
from close_kmers_tpu_torch.ops.probe_select import famwide_select
from close_kmers_tpu_torch.ops.row_gather import IdCheck, row_gather

from test_engine import random_db, random_seqs
from test_torch_host import as_jax_db, as_jax_mapping, as_port_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENUS = 83333


def make_mapping(rng, db, n_fams=40):
    mapping = KmerFamilyMapping()
    for k in db.keys:
        for fid in set(rng.integers(0, n_fams,
                                    size=rng.integers(1, 5)).tolist()):
            mapping.add_fam_mapping(int(fid), int(k))
    for fid in range(n_fams):
        mapping.families.append(FamilyData(
            pgf=f"PGF_{fid % 7:08d}", plf=f"PLF_{GENUS}_{fid:08d}",
            genus_id=GENUS, function=f"fn {fid % 5}" if fid % 3 else
            f"fn{fid % 12}", family_id=fid, total_size=10 + fid, count=3))
    return mapping


@pytest.fixture(scope="module")
def setup():
    """The JAX test's DB and mapping (tests/test_device_family.py), with
    family metadata whose functions partly match the DB's, as the port's
    SignatureDB and KmerFamilyMapping."""
    rng = np.random.default_rng(55)
    db = as_port_db(random_db(rng))
    seqs = random_seqs(rng, db, n=24)
    mapping = make_mapping(rng, db)
    offsets, lengths = FastAnnotator(db, "cpu").pad_batch(seqs)
    return db, seqs, mapping, offsets, lengths


@pytest.fixture(scope="module")
def jax_side(setup):
    """The JAX package's DB and mapping over the same numpy arrays."""
    db, _, mapping, _, _ = setup
    return as_jax_db(db), as_jax_mapping(mapping)


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_parsed_equal(want, got):
    assert (want is None) == (got is None)
    if want is not None:
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert np.array_equal(bits(w), bits(g))


# -- kernel wrappers (plain versions on the CPU) ----------------------------

@pytest.mark.parametrize("w", [3, 128])
def test_row_gather_matches_pallas_interpret(w):
    rng = np.random.default_rng(w)
    table = rng.integers(-1, 1 << 20, size=(700, w), dtype=np.int32)
    idx = rng.integers(0, 700, size=2 * CHUNK).astype(np.int32)
    want = np.asarray(pallas_row_gather(table, idx, interpret=True))
    got, _ = row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_row_gather_any_length(n):
    rng = np.random.default_rng(n)
    table = rng.integers(-1, 99, size=(50, 3), dtype=np.int32)
    idx = rng.integers(0, 50, size=n).astype(np.int32)
    got, _ = row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (n, 3)
    assert np.array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("bad,exc", [
    (dict(idx=torch.tensor([0, 5], dtype=torch.int32)), IndexError),
    (dict(idx=torch.tensor([0, -1], dtype=torch.int32)), IndexError),
    (dict(idx=torch.tensor([0, 1])), TypeError),
    (dict(table=torch.zeros((5, 3), dtype=torch.float32)), TypeError),
    (dict(table=torch.zeros((3, 5), dtype=torch.int32).t()), ValueError),
    (dict(idx=torch.zeros((2, 2), dtype=torch.int32)), ValueError),
])
def test_row_gather_rejects_bad_inputs(bad, exc):
    args = dict(table=torch.zeros((5, 3), dtype=torch.int32),
                idx=torch.tensor([0, 4], dtype=torch.int32))
    args.update(bad)
    with pytest.raises(exc):
        row_gather(**args)


@pytest.mark.parametrize("flag", [0, 1])
def test_id_check_reads_the_flag_after_the_wait(flag):
    """IdCheck waits on its event, then raises only for a set flag; the
    CPU path's check (the wrapper raised already) holds nothing."""
    waited = []

    class Event:
        def synchronize(self):
            waited.append(True)

    check = IdCheck(torch.tensor([flag], dtype=torch.int32), Event(), 9)
    if flag:
        with pytest.raises(IndexError, match="9 rows"):
            check.raise_if_bad()
    else:
        check.raise_if_bad()
    assert waited == [True]
    _, cpu_check = row_gather(torch.zeros((5, 3), dtype=torch.int32),
                              torch.tensor([4], dtype=torch.int32))
    cpu_check.raise_if_bad()


def jax_folded_probe(famwide, fam_w, fam_d, hi, lo, valid):
    """The folded single-gather branch of device_family.py::
    _score_family_jit (lines 383-407), as the JAX package runs it."""
    lmask = (1 << JaxDeviceDB.FUSED_LO_BITS) - 1
    sh = hi.shape
    hi_c = jnp.where(valid, hi, 0)
    lo_c = jnp.where(valid, lo, -2)
    hif, lof, nflat = _pad_flat_probes(hi_c.reshape(-1), lo_c.reshape(-1))
    row = famwide[hif]
    packed = row[:, :fam_w]
    match = (packed & lmask) == (lof[:, None] & lmask)
    m = match.astype(jnp.int32)

    def pick(p):
        return (row[:, p * fam_w:(p + 1) * fam_w] * m).sum(axis=-1)

    fif = (packed * m).sum(axis=-1) >> JaxDeviceDB.FUSED_LO_BITS
    sel = _unpad_sel((match.any(axis=-1), fif, pick(1))
                     + tuple(pick(2 + p) for p in range(fam_d)), nflat)
    found = valid & sel[0].reshape(sh)
    fi = jnp.where(found, sel[1].reshape(sh), -1)
    wt = jnp.where(found, sel[2].reshape(sh), 0)
    fams = jnp.stack([jnp.where(found, sel[3 + p].reshape(sh), -1)
                      for p in range(fam_d)], axis=-1)
    return [np.asarray(x) for x in (found, fi, wt, fams)]


def test_famwide_select_matches_jax_folded_branch(setup, jax_side):
    db, seqs, mapping, offsets, lengths = setup
    tab, W, D = JF.DeviceFamilyDB.famwide_from_mapping(*jax_side,
                                                       force=True)
    ttab, tW, tD = TF.DeviceFamilyDB.famwide_from_mapping(db, mapping, "cpu",
                                                          force=True)
    assert (W, D) == (tW, tD)
    assert np.array_equal(np.asarray(tab), ttab.numpy())
    hi, lo, valid = jax_encode(jnp.asarray(offsets), jnp.asarray(lengths))
    want = jax_folded_probe(tab, W, D, hi, lo, valid)
    found, fi, wt, fams = famwide_select(
        *(torch.from_numpy(np.asarray(x).reshape(-1))
          for x in (hi, lo, valid)), ttab, W, D, JaxDeviceDB.FUSED_LO_BITS)
    assert found.sum() > 50 and (~found).sum() > 50
    assert np.array_equal(want[0].reshape(-1), found.numpy())
    assert np.array_equal(want[1].reshape(-1), fi.numpy())
    assert np.array_equal(want[2].reshape(-1), wt.view(torch.int32).numpy())
    assert np.array_equal(want[3].reshape(-1, D), fams.numpy())


@pytest.mark.parametrize("bad", [
    dict(lo_bits=0), dict(d=0), dict(wd=40),
    dict(famwide=torch.zeros((4, 16), dtype=torch.int64)),
    dict(valid=torch.ones(3, dtype=torch.int32)),
])
def test_famwide_select_rejects_bad_inputs(bad):
    args = dict(hi=torch.zeros(3, dtype=torch.int32),
                lo=torch.zeros(3, dtype=torch.int32),
                valid=torch.ones(3, dtype=torch.bool),
                famwide=torch.zeros((4, 16), dtype=torch.int32),
                wd=4, d=2, lo_bits=13)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        famwide_select(**args)


@pytest.mark.parametrize("bad", [
    dict(fams=torch.zeros((2, 5, 3), dtype=torch.int64)),
    dict(fams=torch.zeros((2, 15), dtype=torch.int32)),
    dict(fams=torch.zeros((2, 5, 0), dtype=torch.int32)),
    dict(cap=-1),
])
def test_family_group_rejects_bad_inputs(bad):
    args = dict(fams=torch.zeros((2, 5, 3), dtype=torch.int32), cap=3)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        family_group(**args)


def test_cpu_tensors_launch_no_kernel(setup):
    db, seqs, mapping, offsets, lengths = setup
    before = (row_gather.launches, famwide_select.launches,
              family_group.launches)
    for fw in (True, False):
        TF.DeviceFamilyScorer(db, mapping, "cpu", famwide=fw) \
            .score_family_packed(offsets, lengths, EngineParams())
    assert (row_gather.launches, famwide_select.launches,
            family_group.launches) == before


# -- rollup_from_fams against JAX ------------------------------------------

@pytest.fixture(scope="module")
def real_fams(setup, jax_side):
    """[B, W, D] family rows of the setup batch, gathered by JAX."""
    db, seqs, mapping, offsets, lengths = setup
    ddb = JaxDeviceDB.from_db(jax_side[0])
    fdb = JF.DeviceFamilyDB.from_mapping(*jax_side)
    hi, lo, valid = jax_encode(jnp.asarray(offsets), jnp.asarray(lengths))
    *_, idx = jax_probe(ddb, hi, lo, valid)
    fams = np.asarray(JF._gather_fams(fdb.fam, idx))
    tf, _ = TF._gather_fams(torch.from_numpy(np.asarray(fdb.fam)),
                            torch.from_numpy(np.asarray(idx)))
    assert np.array_equal(fams, tf.numpy())
    return fams


def synthetic_fams(seed, B, W, D, density):
    rng = np.random.default_rng(seed)
    fams = rng.integers(0, 300, size=(B, W, D)).astype(np.int32)
    fams[rng.random((B, W, D)) > density] = -1
    return fams


def parse(buf, B, cap_seq, row_cap, folded):
    if cap_seq >= 0:
        return JF.DeviceFamilyScorer.finish_rollup_rows(np.asarray(buf),
                                                        cap_seq)
    return JF.DeviceFamilyScorer.finish_rollup_global(
        np.asarray(buf), B, -cap_seq, row_cap, folded)


@pytest.mark.parametrize("cap_seq,row_cap", [
    (8, 0), (64, 0), (5000, 0), (-4096, 0), (-100, 0), (-4096, 48),
    (-4096, 1)])
def test_rollup_from_fams_matches_jax(real_fams, cap_seq, row_cap):
    """Per-row (with an overflowing cap and one wider than W*D+1), global
    folded (with an overflowing pack) and hierarchical packs."""
    B, W, D = real_fams.shape
    want = np.asarray(JF.rollup_from_fams(jnp.asarray(real_fams), cap_seq,
                                          row_cap))
    got = TF.rollup_from_fams(torch.from_numpy(real_fams), cap_seq,
                              row_cap).numpy()
    assert want.shape == got.shape
    folded = (W * D + 1) < (1 << 15)
    assert folded
    c = min(cap_seq, W * D + 1)
    w = parse(want, B, c, row_cap, folded)
    g = parse(got, B, c, row_cap, folded)
    assert_parsed_equal(w, g)
    n_per = got[:, 0] if cap_seq >= 0 else got[:B]
    assert int(n_per.sum()) > 50
    if cap_seq in (8, -100) or row_cap == 1:
        assert g is None           # the overflow cases do overflow


@pytest.mark.parametrize("cap_seq,row_cap", [(-2000, 0), (-2000, 300)])
def test_rollup_unfolded_global_matches_jax(cap_seq, row_cap):
    """W*D+1 >= 2^15: the global pack keeps count and first apart."""
    fams = synthetic_fams(7, 3, 4096, 8, 0.01)
    want = np.asarray(JF.rollup_from_fams(jnp.asarray(fams), cap_seq,
                                          row_cap))
    got = TF.rollup_from_fams(torch.from_numpy(fams), cap_seq,
                              row_cap).numpy()
    assert want.shape == got.shape
    w = parse(want, 3, cap_seq, row_cap, False)
    g = parse(got, 3, cap_seq, row_cap, False)
    assert g is not None and int(g[0].sum()) > 500
    assert_parsed_equal(w, g)


def test_rollup_weights_are_host_constants():
    """Degree-3 rows weigh float32(1)/float32(3) exactly, and the group
    sums are sequential f32 adds in window order."""
    fams = np.full((1, 7, 3), -1, np.int32)
    fams[0, :, :] = [5, 6, 7]
    got = TF.rollup_from_fams(torch.from_numpy(fams), 4).numpy()[0]
    third = np.float32(1.0) / np.float32(3.0)
    want = np.float32(0.0)
    for i in range(7):
        want = third if i == 0 else np.float32(want + third)
    assert got[0] == 3 and list(got[1:4]) == [5, 6, 7]
    assert list(got[5:8]) == [7, 7, 7]
    assert got[9:12].view(np.float32).tolist() == [want] * 3
    assert list(got[13:16]) == [0, 1, 2]


def edge_fams(case):
    """[B, W, D] family rows for the kernel's edge cases (B = 13 is no
    multiple of the eight rows a block takes)."""
    rng = np.random.default_rng(len(case))
    if case.startswith("d"):                         # d1, d3, d4, d8
        return synthetic_fams(int(case[1:]), 13, 40, int(case[1:]), 0.6)
    if case == "all_pad":
        return np.full((13, 30, 3), -1, np.int32)
    if case == "one_family":
        # row 0: one family on every slot, the longest add chain; row 1:
        # it in every window beside others; the rest random
        fams = synthetic_fams(5, 13, 50, 3, 0.5)
        fams[0] = 77
        fams[1, :, 1] = 77
        return fams
    if case == "ids_near_2^30":
        fams = rng.integers((1 << 30) - 40, 1 << 30, size=(13, 40, 3))
        fams[rng.random(fams.shape) < 0.3] = -1
        return fams.astype(np.int32)
    W, D = {"at_limit": (2048, 4), "past_limit": (2731, 3)}[case]
    assert (W * D <= SMEM_MAX_COLS) == (case == "at_limit")
    return synthetic_fams(11, 2, W, D, 0.3)


EDGE_CASES = ["all_pad", "one_family", "d1", "d3", "d4", "d8",
              "ids_near_2^30", "at_limit", "past_limit"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_rollup_edge_cases_match_jax(case):
    """The plain composition (sort_fams + group_sorted_plain) equals
    JAX's rollup_from_fams on the fused kernel's edge cases, per-row at
    caps 0, 3 and W*D+1 and in the global pack, at zero tolerance."""
    fams = edge_fams(case)
    B, W, D = fams.shape
    M = W * D
    for cap_seq in (0, 3, M + 1, -B * (M + 1)):
        want = np.asarray(JF.rollup_from_fams(jnp.asarray(fams), cap_seq))
        got = TF.rollup_from_fams(torch.from_numpy(fams), cap_seq).numpy()
        assert want.shape == got.shape
        n_want = want[:, 0] if cap_seq >= 0 else want[:B]
        assert np.array_equal(n_want, got[:, 0] if cap_seq >= 0 else got[:B])
        folded = (M + 1) < (1 << 15)
        c = min(cap_seq, M + 1) if cap_seq >= 0 else cap_seq
        assert_parsed_equal(parse(want, B, c, 0, folded),
                            parse(got, B, c, 0, folded))
    n = got[:B]
    if case == "all_pad":
        assert not n.any()
    else:
        assert n.sum() > B
    if case == "one_family":
        r = TF.DeviceFamilyScorer.finish_rollup_rows(
            TF.rollup_from_fams(torch.from_numpy(fams), M + 1).numpy(), M + 1)
        assert r[0][0] == 1 and r[2][0] == M


# -- DeviceFamilyScorer against JAX ----------------------------------------

@pytest.fixture(scope="module")
def scorers(setup, jax_side):
    db, seqs, mapping, offsets, lengths = setup
    return {fw: (JF.DeviceFamilyScorer(*jax_side, famwide=fw),
                 TF.DeviceFamilyScorer(db, mapping, "cpu", famwide=fw))
            for fw in (True, False)}


@pytest.mark.parametrize("famwide", [True, False])
@pytest.mark.parametrize("cap,row_cap,slim", [
    (64, 0, False), (8, 0, True), (-4096, 0, True), (-4096, 48, True)])
def test_score_family_packed_matches_jax(setup, scorers, famwide, cap,
                                         row_cap, slim):
    db, seqs, mapping, offsets, lengths = setup
    jd, td = scorers[famwide]
    assert (jd.famwide is None) == (td.famwide is None) == (not famwide)
    B = offsets.shape[0]
    params = EngineParams()
    a = jd.score_family_packed(offsets, lengths, params, 4, cap,
                               slim_calls=slim, row_cap=row_cap)
    b = td.score_family_packed(offsets, lengths, params, 4, cap,
                               slim_calls=slim, row_cap=row_cap)
    assert a[1] == b[1]
    fold_calls, fold_rows = td.pack_flags(offsets.shape[1])
    assert (fold_calls, fold_rows) == jd.pack_flags(offsets.shape[1])
    unpack = "unpack_dense" if not slim else \
        ("unpack_dense2" if fold_calls else "unpack_dense3")
    wc = getattr(JaxScorer, unpack)(np.asarray(a[0]), B, a[1])
    gc = getattr(JaxScorer, unpack)(b[0].numpy(), B, b[1])
    assert wc is not None and int(gc[0].sum()) > 5
    assert_parsed_equal(wc, gc)
    assert np.asarray(a[2]).shape == b[2].shape
    wr = parse(a[2], B, b[3], row_cap, fold_rows)
    gr = parse(b[2].numpy(), B, b[3], row_cap, fold_rows)
    assert_parsed_equal(wr, gr)
    assert (gr is None) == (cap == 8)


def test_order_constraint_takes_the_two_gather_path(setup, scorers):
    db, seqs, mapping, offsets, lengths = setup
    jd, td = scorers[True]
    B = offsets.shape[0]
    oc = EngineParams(order_constraint=True, min_hits=2)
    a = jd.score_family_packed(offsets, lengths, oc, 4, 4 * B)
    b = td.score_family_packed(offsets, lengths, oc, 4, 4 * B)
    before = famwide_select.launches
    assert_parsed_equal(JaxScorer.unpack_dense(np.asarray(a[0]), B, a[1]),
                        JaxScorer.unpack_dense(b[0].numpy(), B, b[1]))
    assert_parsed_equal(parse(a[2], B, b[3], 0, True),
                        parse(b[2].numpy(), B, b[3], 0, True))
    assert famwide_select.launches == before
    with pytest.raises(ValueError):
        TF.score_family(td.ddb, td.fdb.fam, torch.from_numpy(offsets),
                        torch.from_numpy(lengths), oc, 64, 8,
                        famwide=(td.famwide, td.fam_w, td.fam_d))


@pytest.mark.parametrize("cap", [None, 1, 64])
def test_rollup_matches_jax(setup, scorers, cap):
    db, seqs, mapping, offsets, lengths = setup
    jd, td = scorers[False]
    want = jd.rollup(offsets, lengths, cap)
    got = td.rollup(offsets, lengths, cap)
    assert_parsed_equal(want, got)


def test_from_numpy_carries_jax_state(setup, scorers):
    db, seqs, mapping, offsets, lengths = setup
    for fw in (True, False):
        jd, td = scorers[fw]
        carried = TF.DeviceFamilyScorer.from_numpy(
            db, dict(fam=np.asarray(jd.fdb.fam),
                     famwide=None if jd.famwide is None
                     else np.asarray(jd.famwide), fam_w=jd.fam_w),
            "cpu", ddb=td.ddb)
        assert carried.fam_d == td.fam_d and carried.fdb.d == jd.fdb.d
        for cap in (64, -4096):
            a = td.score_family_packed(offsets, lengths, EngineParams(), 4,
                                       cap, slim_calls=True)
            b = carried.score_family_packed(offsets, lengths,
                                            EngineParams(), 4, cap,
                                            slim_calls=True)
            assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    fdb = TF.DeviceFamilyDB.from_numpy(np.asarray(jd.fdb.fam), "cpu")
    assert torch.equal(fdb.fam, td.fdb.fam) and fdb.d == td.fdb.d
    built = TF.DeviceFamilyDB.from_mapping(db, mapping, "cpu")
    assert torch.equal(built.fam, fdb.fam) and built.d == fdb.d


# -- the JAX tests of tests/test_device_family.py, on the port -------------

def test_device_rollup_matches_host(setup):
    db, seqs, mapping, offsets, lengths = setup
    dfs = TF.DeviceFamilyScorer(db, mapping, "cpu")
    n_per_seq, fam, counts, weights, first = dfs.rollup(offsets, lengths)
    res, _h = KmerEngine(db, "cpu").annotate_with_hits(
        [(str(i), s) for i, s in enumerate(seqs)], want_hits=True)
    k = total = 0
    for s, r in enumerate(res):
        py = F.accumulate_family_scores(r.hits, mapping)
        n = int(n_per_seq[s])
        got = {int(fam[k + i]): (int(counts[k + i]), float(weights[k + i]))
               for i in range(n)}
        want = {fid: (ss.hit_count, float(ss.weighted_total))
                for fid, ss in py.items()}
        assert got == want, s
        assert [int(fam[k + i]) for i in range(n)] == sorted(got)
        order = np.argsort(first[k:k + n], kind="stable")
        assert [int(fam[k + i]) for i in order] == list(want)
        k += n
        total += n
    assert total > 50


def test_device_rollup_cap_retry(setup):
    db, seqs, mapping, offsets, lengths = setup
    dfs = TF.DeviceFamilyScorer(db, mapping, "cpu")
    a = dfs.rollup(offsets, lengths, fams_per_seq_cap=1)
    b = dfs.rollup(offsets, lengths, fams_per_seq_cap=64)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_device_rollup_no_hits(setup):
    db, _, mapping, _, _ = setup
    dfs = TF.DeviceFamilyScorer(db, mapping, "cpu")
    offsets = np.full((4, 64), 20, dtype=np.uint8)
    lengths = np.zeros(4, dtype=np.int32)
    n_per_seq, fam, counts, weights, first = dfs.rollup(offsets, lengths)
    assert n_per_seq.sum() == 0 and len(fam) == 0


def test_rollup_cap_escalation_sticky(setup):
    """Forcing the overflow path gives identical results and raises the
    scorer's default cap, so later batches skip the retry."""
    db, seqs, mapping, offsets, lengths = setup
    dfs = TF.DeviceFamilyScorer(db, mapping, "cpu")
    roomy = dfs.rollup(offsets, lengths, 64)
    assert int(roomy[0].max()) > 1
    tight = dfs.rollup(offsets, lengths, 1)   # forces escalation
    for a, b in zip(roomy, tight):
        assert np.array_equal(a, b)
    assert dfs._default_cap >= 16
    after = dfs.rollup(offsets, lengths)      # sticky default path
    for a, b in zip(roomy, after):
        assert np.array_equal(a, b)


def test_device_rollup_sub_bucket_layout(setup):
    """The family rollup is identical when the engine probes via the
    deep-bucket sub-bucket layout (idx stays the global DB row)."""
    db, seqs, mapping, offsets, lengths = setup
    from close_kmers_tpu_torch.core.engine import DeviceDB
    ddb_sub = DeviceDB.from_db(db, "cpu", wide=False, fused=False)
    assert ddb_sub.tier == "sub_blocks"
    a = TF.DeviceFamilyScorer(db, mapping, "cpu").rollup(offsets, lengths)
    b = TF.DeviceFamilyScorer(db, mapping, "cpu", ddb=ddb_sub).rollup(
        offsets, lengths)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_hierarchical_global_pack_identical(real_fams):
    """rollup_from_fams(cap_seq<0, row_cap>0) parses to the flat global
    pack's result whenever no row overflows row_cap, and
    finish_rollup_global flags a row overflow."""
    fams = torch.from_numpy(real_fams)
    B = fams.shape[0]
    gcap = 64 * B
    flat = TF.rollup_from_fams(fams, -gcap).numpy()
    hier = TF.rollup_from_fams(fams, -gcap, row_cap=48).numpy()
    n_per = flat[:B]
    assert int(n_per.max()) <= 48 and int(n_per.sum()) > 50
    assert np.array_equal(hier[:B], flat[:B])
    total = int(n_per.sum())
    assert np.array_equal(hier[B:].reshape(3, -1)[:, :total],
                          flat[B:].reshape(3, -1)[:, :total])
    finish = TF.DeviceFamilyScorer.finish_rollup_global
    r = finish(TF.rollup_from_fams(fams, -gcap, row_cap=1).numpy(), B, gcap,
               row_cap=1, folded=True)
    assert r is None
    ok = finish(hier, B, gcap, row_cap=48, folded=True)
    for a, b in zip(ok, finish(flat, B, gcap, folded=True)):
        assert np.array_equal(a, b)


def test_famwide_path_identical(setup, scorers):
    """The folded single-read rows give packs identical to the
    two-gather path's, raw buffers included (the port zero-fills the
    slots past each row's groups on both paths)."""
    db, seqs, mapping, offsets, lengths = setup
    fw, base = scorers[True][1], scorers[False][1]
    B = offsets.shape[0]
    for cap in (4 * B, -4 * B):
        a = base.score_family_packed(offsets, lengths, EngineParams(), 4, cap,
                                     slim_calls=True)
        b = fw.score_family_packed(offsets, lengths, EngineParams(), 4, cap,
                                   slim_calls=True)
        assert a[1] == b[1] and a[3] == b[3]
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


# -- KmerEngine family methods against the JAX engine ----------------------

def fields(matches):
    """BestMatch objects of either package as comparable field dicts."""
    return [vars(m) for m in matches]


def call_key(c):
    return (c.start, c.end, c.count, c.fI, bits(np.float32(c.weighted)))


def score_items(d):
    return [(fid, s.hit_count, s.hit_total, bits(np.float32(s.weighted_total)))
            for fid, s in d.items()]


@pytest.fixture(scope="module")
def engines(setup, jax_side):
    """A JAX engine and a port engine, both forced onto the device family
    path, and a port engine on the host path; the JAX engine runs on the
    JAX twins of the DB and the mapping."""
    db, seqs, mapping, offsets, lengths = setup
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    return (items, JaxEngine(jax_side[0], device_family_min=0),
            KmerEngine(db, "cpu", device_family_min=0),
            KmerEngine(db, "cpu", device_family=False))


def test_annotate_family_matches_jax(setup, jax_side, engines):
    """seq_scores equal, dict ORDER included, on the device path and the
    host path (native.family_scores), and so are the calls and best
    calls."""
    mapping = setup[2]
    items, jeng, teng, heng = engines
    r_j, s_j = jeng.annotate_family(items, jax_side[1], want_best=True)
    assert sum(len(s) for s in s_j) > 50
    for eng in (teng, heng):
        r_t, s_t = eng.annotate_family(items, mapping, want_best=True)
        assert [score_items(d) for d in s_j] == [score_items(d) for d in s_t]
        for a, b in zip(r_j, r_t):
            assert a.seq_id == b.seq_id
            assert [call_key(c) for c in a.calls] == \
                [call_key(c) for c in b.calls]
            assert vars(a.best) == vars(b.best)
    assert teng._device_family_scorer(mapping) is not None
    assert heng._device_family_scorer(mapping) is None


@pytest.mark.parametrize("kw", [
    dict(target_genus_id=GENUS), dict(allow_ambiguous=True),
    dict(genus_filter=False, kmer_hit_threshold=1)])
def test_best_family_matches_matches_jax(setup, jax_side, engines, kw):
    mapping = setup[2]
    items, jeng, teng, heng = engines
    want = fields(jeng.best_family_matches(items, jax_side[1], **kw))
    assert sum(1 for m in want if m["gfam_id"]) > 3
    assert fields(teng.best_family_matches(items, mapping, **kw)) == want
    assert fields(heng.best_family_matches(items, mapping, **kw)) == want


def test_best_family_matches_padded_arrays_match_jax(setup, jax_side,
                                                     engines):
    db, seqs, mapping, offsets, lengths = setup
    items, jeng, teng, heng = engines
    want = jeng.best_family_matches_padded(offsets, lengths, jax_side[1],
                                           genus_filter=False,
                                           as_arrays=True)
    got = teng.best_family_matches_padded(offsets, lengths, mapping,
                                          genus_filter=False, as_arrays=True)
    assert len(want) == len(got) == len(seqs)
    assert fields([want.materialize(i) for i in range(len(want))]) == \
        fields([got.materialize(i) for i in range(len(got))])


def test_annotate_family_device_matches_host(setup, engines):
    """The port's device family program and its host path give equal
    results and the same formatted /lookup output."""
    mapping = setup[2]
    items, _jeng, teng, heng = engines
    r_h, s_h = heng.annotate_family(items, mapping, want_best=True)
    r_d, s_d = teng.annotate_family(items, mapping, want_best=True)
    for s, (ra, rb) in enumerate(zip(r_h, r_d)):
        ma = F.find_best_family_match(ra.best, s_h[s], mapping, 3, False,
                                      GENUS)
        mb = F.find_best_family_match(rb.best, s_d[s], mapping, 3, False,
                                      GENUS)
        assert F.format_best_match_lookup(ra.seq_id, ma) == \
            F.format_best_match_lookup(rb.seq_id, mb)
        assert F.all_matches_rows(s_h[s], mapping, 3) == \
            F.all_matches_rows(s_d[s], mapping, 3)


def test_engines_sharing_a_mapping_keep_their_own_scorers(setup):
    """A JAX engine caches its scorer as mapping._device_scorer; the
    port's engine never reads or writes that attribute, so each engine
    runs its own scorer on a shared mapping."""
    db, seqs, _, _, _ = setup
    mapping = make_mapping(np.random.default_rng(9), db)
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    jeng = JaxEngine(as_jax_db(db), device_family_min=0)
    teng = KmerEngine(db, "cpu", device_family_min=0)
    want = fields(jeng.best_family_matches(items, mapping))
    jax_cached = mapping._device_scorer
    assert isinstance(jax_cached[1], JF.DeviceFamilyScorer)
    assert fields(teng.best_family_matches(items, mapping)) == want
    assert mapping._device_scorer is jax_cached
    tdfs = teng._device_family_scorer(mapping)
    assert isinstance(tdfs, TF.DeviceFamilyScorer)
    # and the other order: a port scorer cached first is not what JAX reads
    mapping2 = make_mapping(np.random.default_rng(9), db)
    assert fields(teng.best_family_matches(items, mapping2)) == want
    assert not hasattr(mapping2, "_device_scorer")
    assert fields(jeng.best_family_matches(items, mapping2)) == want
    assert isinstance(mapping2._device_scorer[1], JF.DeviceFamilyScorer)
    assert teng._family_scorers[mapping2][1] is not \
        mapping2._device_scorer[1]


def test_scorer_cache_follows_the_csr(setup):
    """A new family mapping (add_fam_mapping clears the CSR) rebuilds the
    cached scorer; an unchanged one reuses it."""
    db, seqs, _, _, _ = setup
    mapping = make_mapping(np.random.default_rng(10), db)
    teng = KmerEngine(db, "cpu", device_family_min=0)
    a = teng._device_family_scorer(mapping)
    assert teng._device_family_scorer(mapping) is a
    mapping.add_fam_mapping(3, int(db.keys[0]))
    assert teng._device_family_scorer(mapping) is not a


def test_bounded_dispatch_ahead(setup, monkeypatch):
    """With 8 chunks and FAMILY_MATCH_GROUP = 2, no more than 2 chunks'
    buffers are pending at once, and the matches equal those of
    dispatching every chunk before reading any back (the reference's
    order).  This differs from the reference on purpose: its
    best_family_matches_padded enqueues every chunk of a request up front
    (ADVICE.md, medium: unbounded dispatch-ahead)."""
    db, seqs, mapping, _, _ = setup
    items = [(f"q{i}", s) for i, s in enumerate(seqs + seqs[:8])]
    assert len(items) == 32
    eng = KmerEngine(db, "cpu", device_family_min=0)
    dfs = eng._device_family_scorer(mapping)
    dfs.bm_calls_per_seq, dfs.bm_groups_per_seq = 64, 256   # no retries
    monkeypatch.setattr(KmerEngine, "_chunk_rows", lambda self, B0, L: 4)
    live = []
    peak = []
    real = TA._Readback

    class Counting(real):
        def __init__(self, t):
            super().__init__(t)
            live.append(self)
            peak.append(len(live))

        def result(self):
            if self in live:
                live.remove(self)
            return super().result()

    monkeypatch.setattr(TA, "_Readback", Counting)
    monkeypatch.setattr(KmerEngine, "FAMILY_MATCH_GROUP", 8)
    unbounded = eng.best_family_matches(items, mapping,
                                        target_genus_id=GENUS)
    assert max(peak) == 8 and len(peak) == 8
    peak.clear()
    monkeypatch.setattr(KmerEngine, "FAMILY_MATCH_GROUP", 2)
    got = eng.best_family_matches(items, mapping, target_genus_id=GENUS)
    assert len(peak) == 8 and max(peak) == 2
    assert got == unbounded
    assert sum(1 for m in got if m.gfam_id) > 3


def test_cap_retry_is_sticky_per_sequence(setup, monkeypatch):
    """Overflowing per-sequence caps re-run the chunk with what its
    readback asks for and stay raised for later chunks."""
    db, seqs, mapping, _, _ = setup
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    eng = KmerEngine(db, "cpu", device_family_min=0)
    want = eng.best_family_matches(items, mapping, kmer_hit_threshold=1)
    dfs = eng._device_family_scorer(mapping)
    dfs.bm_calls_per_seq, dfs.bm_groups_per_seq = 1, 1
    monkeypatch.setattr(KmerEngine, "_chunk_rows", lambda self, B0, L: 8)
    assert eng.best_family_matches(items, mapping,
                                   kmer_hit_threshold=1) == want
    assert dfs.bm_groups_per_seq >= 4


def test_family_scores_batch_needs_hits(setup, engines):
    mapping = setup[2]
    items, _j, teng, _h = engines
    _r, h = teng.annotate_with_hits(items)
    out_n, fam, cnt, wt = teng.family_scores_batch(mapping, h)
    assert len(out_n) == len(items) and int(out_n.sum()) == len(fam) > 50
    with pytest.raises(TypeError):
        teng.family_scores_batch(mapping)


def test_family_path_runs_without_jax():
    """The device family path, the host path and the port's scalar
    best-call of ambiguous rows run with jax unavailable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['close_kmers_tpu'] = None\n"
        "import numpy as np\n"
        "from close_kmers_tpu_torch.cli import kser\n"
        "from close_kmers_tpu_torch.core.family import BestCallReduction\n"
        f"ctx = kser.load_server_context({os.path.join(REPO, 'tests', 'golden', 'data')!r}, device='cpu')\n"
        "root = ctx.mapping_map['']\n"
        "items = [('q', 'MKV' * 40)]\n"
        "a = ctx.engine.best_family_matches(items, root, allow_ambiguous=True)\n"
        "ctx.engine.device_family_min = 0\n"
        "b = ctx.engine.best_family_matches(items, root, allow_ambiguous=True)\n"
        "assert a == b and ctx.engine._device_family_scorer(root)\n"
        "r = BestCallReduction(np.array([2]), np.array([[0, 1, -1]]),\n"
        "                      np.array([[3, 3, 0]]),\n"
        "                      np.array([[1, 1, 0]], np.float32), ['a', 'b'])\n"
        "assert r.best_call(0).function == 'b ?? a'\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CLOSE_KMERS_JAX_PLATFORM"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr


# -- the scale universe, the famwide gates and the fan-out bound -----------

def spelled_items(db, n, rng, n_k=10, tail=24):
    """``n`` proteins, each ``n_k`` back-to-back kmers of one function of
    ``db`` (so that calls form) then ``tail`` random residues."""
    from close_kmers_tpu_torch.ops import encoder as E
    items = []
    funcs = np.unique(db.fi)
    for i in range(n):
        keys = db.keys[db.fi == funcs[rng.integers(0, len(funcs))]]
        pick = keys[rng.integers(0, len(keys), size=n_k)]
        tail_s = "".join(rng.choice(list(E.PROT_ALPHA), size=tail))
        items.append((f"p{i}", "".join(E.decode_kmer(int(k)) for k in pick)
                      + tail_s))
    return items


@pytest.fixture(scope="module")
def scale_side():
    """A small seeded scale DB (make_scale_db.scale_db, 40 functions), its
    scale-rule mapping, spelled proteins, and the JAX twins."""
    from close_kmers_tpu_torch.scripts.make_scale_db import (scale_db,
                                                             scale_mapping)
    db = scale_db(40_000, n_funcs=40, seed=8, device="cpu")
    mapping = scale_mapping(db)
    items = spelled_items(db, 48, np.random.default_rng(8))
    return db, mapping, items, as_jax_db(db), as_jax_mapping(mapping)


@pytest.mark.parametrize("famwide", [True, False])
def test_scale_mapping_best_matches_match_jax(scale_side, famwide):
    """On the scale rule's mapping, the port's best_family_matches (and
    the padded array path) on the famwide rows and on the two-gather path
    equal the JAX engine's over the same arrays, genus filter off as in
    the JAX scale serve and on."""
    db, mapping, items, jdb, jmap = scale_side
    jeng = JaxEngine(jdb, device_family_min=0)
    teng = KmerEngine(db, "cpu", device_family_min=0)
    dfs = TF.DeviceFamilyScorer(db, mapping, "cpu", ddb=teng.fa.ddb,
                                famwide=famwide)
    assert (dfs.famwide is not None) == famwide and dfs.fdb.d == 3
    teng._family_scorers[mapping] = (mapping.fam_csr(), dfs)
    assert teng._device_family_scorer(mapping) is dfs
    for kw in (dict(genus_filter=False), dict(genus_filter=True,
                                              target_genus_id=2)):
        want = fields(jeng.best_family_matches(items, jmap, **kw))
        assert sum(1 for m in want if m["gfam_id"]) > len(items) // 2
        assert fields(teng.best_family_matches(items, mapping, **kw)) == want
    offsets, lengths = teng.fa.pad_batch([s for _, s in items])
    got = teng.best_family_matches_padded(offsets, lengths, mapping,
                                          genus_filter=False, as_arrays=True)
    want = jeng.best_family_matches_padded(offsets, lengths, jmap,
                                           genus_filter=False,
                                           as_arrays=True)
    assert fields([got.materialize(i) for i in range(len(got))]) == \
        fields([want.materialize(i) for i in range(len(want))])


def gate_db(case):
    """A DB over 64 hi buckets and a mapping for one side of one famwide
    gate: ``passes`` (D = 3, buckets of 4), ``few_keys`` (the key gate,
    set just above its keys), ``fan_out`` (a kmer of 9 families),
    ``deep`` (a bucket of 129 keys), ``bytes`` (the byte gate, set just
    below its table) or ``wide_fi`` (a function index past 2^18)."""
    from close_kmers_tpu_torch.db.signature_db import SignatureDB
    rng = np.random.default_rng(5)
    H = 64
    keys = np.concatenate([h * 8000 + np.sort(rng.choice(8000, 129 if (
        case == "deep" and h == 3) else 4, replace=False))
        for h in range(H)]).astype(np.int64)
    n = len(keys)
    fi = rng.integers(0, 30, size=n).astype(np.int32)
    if case == "wide_fi":
        fi[5] = 1 << 18
    db = SignatureDB(keys, fi, np.full(n, -1, np.int32),
                     rng.integers(0, 200, size=n).astype(np.int32),
                     rng.uniform(0.1, 3, size=n).astype(np.float32),
                     functions=[f"fn{i}" for i in range(int(fi.max()) + 1)],
                     n_hi=H)
    mapping = KmerFamilyMapping()
    for i, k in enumerate(keys.tolist()):
        for j in range(9 if (case == "fan_out" and i == 7) else 1 + i % 3):
            mapping.add_fam_mapping(int(fi[i]) * 9 + j, k)
    gates = dict(FAMWIDE_MIN_KEYS=n + 1 if case == "few_keys" else 100,
                 FAMWIDE_MAX_BYTES=1 << 40)
    if case == "bytes":
        gates["FAMWIDE_MAX_BYTES"] = \
            H * TF.DeviceFamilyDB.famwide_row_w(db, 3) * 4 - 1
    return db, mapping, gates


GATE_CASES = ["passes", "few_keys", "fan_out", "deep", "bytes", "wide_fi"]


@pytest.mark.parametrize("case", GATE_CASES)
def test_jax_famwide_oracle_matches_jax(monkeypatch, case):
    """``DeviceFamilyDB.jax_famwide`` says what the JAX package's auto
    gate builds (famwide_from_mapping with force=None), on either side of
    each of its gates (thresholds set on both packages alike), and the
    port's famwide table under that choice equals the JAX one."""
    db, mapping, gates = gate_db(case)
    for k, v in gates.items():
        monkeypatch.setattr(JF.DeviceFamilyDB, k, v)
        monkeypatch.setattr(TF.DeviceFamilyDB, k, v)
    jdb, jmap = as_jax_db(db), as_jax_mapping(mapping)
    want = JF.DeviceFamilyDB.famwide_from_mapping(jdb, jmap, force=None)
    pick = TF.DeviceFamilyDB.jax_famwide(db, TF.fan_out(mapping))
    assert pick == (want is not None) == (case == "passes")
    got = TF.DeviceFamilyDB.famwide_from_mapping(db, mapping, "cpu",
                                                 force=pick)
    assert (got is None) == (want is None)
    if want is not None:
        assert got[1:] == want[1:]
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))


def test_family_gate_reads_the_fan_out_before_densifying(setup, monkeypatch):
    """A mapping whose dense table would pass FAMILY_TABLE_MAX_BYTES takes
    the host path without a call to _dense_fam (it raises here), logs the
    gate, and answers as the device path does; at the bound it builds."""
    db, seqs, _, _, _ = setup
    mapping = make_mapping(np.random.default_rng(12), db)
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    want = fields(KmerEngine(db, "cpu", device_family_min=0)
                  .best_family_matches(items, mapping))
    table = (len(db) + 1) * TF.fan_out(mapping) * 4
    assert TF.fan_out(mapping) == \
        TF.DeviceFamilyDB._dense_fam(db, mapping)[1] > 1

    def boom(*a, **kw):
        raise AssertionError("_dense_fam ran past the bound")

    teng = KmerEngine(db, "cpu", device_family_min=0)
    teng.FAMILY_TABLE_MAX_BYTES = table - 1
    monkeypatch.setattr(TF.DeviceFamilyDB, "_dense_fam", boom)
    with pytest.MonkeyPatch.context() as m:
        logged = []
        m.setattr(TA._log, "warning", lambda *a: logged.append(a))
        assert teng._device_family_scorer(mapping) is None
        assert teng.family_gate(mapping).startswith("FAMILY_TABLE_MAX_BYTES")
        assert fields(teng.best_family_matches(items, mapping)) == want
        assert len(logged) == 1      # once per CSR
    monkeypatch.undo()
    teng2 = KmerEngine(db, "cpu", device_family_min=0)
    teng2.FAMILY_TABLE_MAX_BYTES = table
    assert teng2.family_gate(mapping) is None
    assert teng2._device_family_scorer(mapping) is not None


def test_fan_out_past_jax_bound_matches_jax(setup, jax_side):
    """A kmer of 40 families (past the JAX engine's DEVICE_FAMILY_MAX_D =
    32, which sends JAX to its host path) stays on the port's device path
    under the byte bound, with the JAX engine's answers."""
    db, seqs, _, _, _ = setup
    mapping = make_mapping(np.random.default_rng(13), db)
    for f in range(40):
        mapping.add_fam_mapping(f, int(db.keys[3]))
    items = [(f"q{i}", s) for i, s in enumerate(seqs)]
    jmap = as_jax_mapping(mapping)
    jeng = JaxEngine(jax_side[0], device_family_min=0)
    assert jeng._device_family_scorer(jmap) is None
    teng = KmerEngine(db, "cpu", device_family_min=0)
    assert teng._device_family_scorer(mapping).fdb.d == 40
    assert fields(teng.best_family_matches(items, mapping)) == \
        fields(jeng.best_family_matches(items, jmap))


@pytest.mark.parametrize("case", GATE_CASES)
def test_card_famwide_gate_never_builds_by_itself(monkeypatch, case):
    """The card's gate takes famwide rows on no DB (two gathers were no
    slower on the card), where the JAX gate would (``passes``) and where
    it would not; ``famwide=True`` still builds them wherever they pack,
    and ``jax_famwide`` passed as the flag rebuilds the JAX choice."""
    db, mapping, gates = gate_db(case)
    for k, v in gates.items():
        monkeypatch.setattr(TF.DeviceFamilyDB, k, v)
    D = TF.fan_out(mapping)
    assert not TF.DeviceFamilyDB.card_famwide(db, D)
    assert TF.DeviceFamilyScorer(db, mapping, "cpu").famwide is None
    assert TF.DeviceFamilyScorer(db, mapping, "cpu",
                                 famwide=None).famwide is None
    forced = TF.DeviceFamilyScorer(db, mapping, "cpu", famwide=True)
    assert (forced.famwide is not None) == (case != "wide_fi")
    jax_pick = TF.DeviceFamilyScorer(
        db, mapping, "cpu", famwide=TF.DeviceFamilyDB.jax_famwide(db, D))
    assert (jax_pick.famwide is not None) == (case == "passes")


def test_chunk_rows_follow_the_card_chunk(setup):
    """best_family_matches_padded's chunks: 65,536 rows at L = 312 (the
    card's measured chunk; the JAX sizing gives 4,096), fewer rows for
    longer proteins, and a small request whole, rounded up to a power of
    two of at least 256."""
    eng = KmerEngine(setup[0], "cpu")
    assert eng._chunk_rows(200_000, 312) == 65_536
    assert eng._chunk_rows(200_000, 1016) == 16_384
    assert eng._chunk_rows(200_000, 40) == 65_536
    assert eng._chunk_rows(65_536, 312) == 65_536
    assert eng._chunk_rows(1000, 312) == 1024
    assert eng._chunk_rows(3, 312) == 256
