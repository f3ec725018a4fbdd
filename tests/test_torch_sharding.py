"""Port parity for parallel/sharding.py on a one-process mesh of eight
CPU entries, against the JAX functions on the 8-device virtual CPU mesh
(tests/conftest.py) with the same seeded inputs: the ShardedDB tables,
the shard bounds and routing capacities, probe_sharded and probe_routed
(with their per-device counters, the overflow fallback and the drop
report) on the mesh shapes of tests/test_sharding.py,
serve_step_sharded in both probe modes with real EngineParams and family
rows, ShardedEngine.probe_compact, the state carry-over from a JAX
ShardedDB, KmerEngine(mesh=) and the dry run.  Zero tolerance: every
plane is integer or f32 compared by its int32 bits."""

import numpy as np
import pytest
import torch

from close_kmers_tpu.core.device_family import DeviceFamilyScorer as JDFS
from close_kmers_tpu.core.device_score import DeviceScorer as JDS
from close_kmers_tpu.db.family_db import KmerFamilyMapping as JMapping
from close_kmers_tpu.params import EngineParams as JParams
from close_kmers_tpu.parallel import sharding as J
from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.core.device_family import DeviceFamilyScorer
from close_kmers_tpu_torch.core.engine import FastAnnotator
from close_kmers_tpu_torch.db.signature_db import SignatureDB
from close_kmers_tpu_torch.params import LO_CARD, EngineParams
from close_kmers_tpu_torch.parallel import sharding as T
from close_kmers_tpu_torch.parallel.dryrun import dryrun_multichip

from test_engine import random_db, random_seqs
from test_torch_host import as_jax_db, as_port_db

CPU8 = ["cpu"] * 8
SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
ROUTED_SHAPES = [(1, 8), (2, 4), (4, 2)]


def bits(x):
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_planes(want, got):
    assert len(want) == len(got)
    for j, (w, g) in enumerate(zip(want, got)):
        w, g = bits(w), bits(g)
        assert w.shape == g.shape, (j, w.shape, g.shape)
        assert np.array_equal(w, g), j


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(99)
    db = as_port_db(random_db(rng))
    seqs = random_seqs(rng, db, n=32)
    offsets, lengths = FastAnnotator(db, "cpu").pad_batch(seqs)
    return db, as_jax_db(db), seqs, offsets, lengths


def meshes(shape):
    return J.make_mesh(*shape), T.make_mesh(*shape, devices=CPU8)


def sharded(corpus, shape, **kw):
    db, jdb = corpus[:2]
    jm, tm = meshes(shape)
    return J.ShardedDB.from_db(jdb, jm, **kw), T.ShardedDB.from_db(db, tm,
                                                                   **kw)


@pytest.fixture(scope="module")
def mapping(corpus):
    """tests/test_sharding.py's kmer->family mapping (seed 7), as the
    JAX package's KmerFamilyMapping, and its dense family table."""
    jdb = corpus[1]
    rng = np.random.default_rng(7)
    m = JMapping()
    for k in jdb.keys:
        for fid in set(rng.integers(0, 40, size=rng.integers(1, 5)).tolist()):
            m.add_fam_mapping(int(fid), int(k))
    return m, np.asarray(JDFS(jdb, m).fdb.fam)


def assert_same_db(jsdb, tsdb):
    for k in T.ShardedDB.ARRAYS:
        a, b = getattr(jsdb, k), getattr(tsdb, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert b.shape == a.shape, k
            assert np.array_equal(np.asarray(a), b.numpy()), k
    for k in ("n_steps", "m", "n_shards", "wide_w", "sub_w"):
        assert getattr(jsdb, k) == getattr(tsdb, k), k
    for k in ("row_base", "h_bounds"):
        assert np.array_equal(getattr(jsdb, k), getattr(tsdb, k)), k


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_db_tables_match_jax(corpus, shape):
    jsdb, tsdb = sharded(corpus, shape)
    assert tsdb.payload_wide is not None
    assert_same_db(jsdb, tsdb)
    # one copy of each shard on the one device the entries share
    parts = tsdb.payload_wide.parts
    assert len(parts) == 8 and len({id(p) for p in parts.values()}) \
        == shape[1]


@pytest.mark.parametrize("S", [1, 2, 3, 8, 64])
def test_hi_range_bounds_match_jax(corpus, S):
    db, jdb = corpus[:2]
    assert np.array_equal(T._hi_range_bounds(db, S),
                          J._hi_range_bounds(jdb, S))


@pytest.mark.parametrize("shape", ROUTED_SHAPES)
def test_routing_caps_match_jax(corpus, shape):
    jsdb, tsdb = sharded(corpus, shape)
    for B, L in ((32, 192), (7, 16), (4096, 312)):
        for cf in (2.0, 8.0, 0.01, None):
            for ov in (8.0, 1.0, 10_000.0):
                assert T._routing_caps(tsdb, B, L, cf, ov) == \
                    J._routing_caps(jsdb, B, L, cf, ov)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_probe_matches_jax(corpus, shape):
    """probe_sharded's seven planes equal JAX's, and the sharded engine's
    compact hits equal JAX's and the single-device engine's."""
    offsets, lengths = corpus[3:]
    jsdb, tsdb = sharded(corpus, shape)
    want = J.probe_sharded(jsdb, offsets, lengths)
    got = T.probe_sharded(tsdb, offsets, lengths)
    assert int(bits(got[0]).sum()) > 20
    assert_planes(want, got)
    assert got[0].device == torch.device("cpu")
    se = T.ShardedEngine(corpus[0], tsdb.mesh)
    hg = se.probe_compact(offsets, lengths)
    hj = J.ShardedEngine(corpus[1], jsdb.mesh).probe_compact(offsets,
                                                            lengths)
    hf = FastAnnotator(corpus[0], "cpu").probe_compact(offsets, lengths)
    for k in ("pos", "fi", "oi", "avg_off", "code", "row_off", "wt"):
        assert np.array_equal(bits(hg[k]), bits(hj[k])), k
        assert np.array_equal(bits(hg[k]), bits(hf[k])), k


def test_sharded_batch_padding(corpus):
    """A batch not divisible by the data axis is padded internally."""
    db, jdb, seqs = corpus[:3]
    offsets, lengths = FastAnnotator(db, "cpu").pad_batch(seqs[:7])
    jm, tm = meshes((4, 2))
    got = T.ShardedEngine(db, tm).probe_compact(offsets, lengths)
    want = J.ShardedEngine(jdb, jm).probe_compact(offsets, lengths)
    for k in want:
        assert np.array_equal(bits(got[k]), bits(want[k])), k
    assert len(got["row_off"]) == 8


def test_probe_sharded_refuses_an_uneven_batch(corpus):
    offsets, lengths = corpus[3:]
    tsdb = sharded(corpus, (4, 2))[1]
    with pytest.raises(ValueError, match="do not divide"):
        T.probe_sharded(tsdb, offsets[:7], lengths[:7])


@pytest.mark.parametrize("wide", [True, False])
def test_sharded_probe_wide_vs_narrow(corpus, wide):
    """The per-shard payload-wide layout and the per-shard binary search
    agree with JAX's and with each other."""
    offsets, lengths = corpus[3:]
    jsdb, tsdb = sharded(corpus, (2, 4), wide_payload=wide)
    assert (tsdb.payload_wide is not None) == wide
    assert_same_db(jsdb, tsdb)
    got = T.probe_sharded(tsdb, offsets, lengths)
    assert_planes(J.probe_sharded(jsdb, offsets, lengths), got)
    other = T.probe_sharded(sharded(corpus, (2, 4),
                                    wide_payload=not wide)[1],
                            offsets, lengths)
    assert_planes(other, got)


@pytest.fixture(scope="module")
def deep():
    """tests/test_sharding.py's deep-bucket DB (seed 13) and 16 queries
    that spell DB kmers."""
    from close_kmers_tpu_torch.ops import encoder as E
    rng = np.random.default_rng(13)
    n = 60_000
    his = rng.integers(2000, 2400, size=n, dtype=np.int64)
    los = rng.integers(0, LO_CARD, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD + los)
    db = SignatureDB(
        keys,
        rng.integers(0, 50, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 3.0, size=len(keys)).astype(np.float32))
    seqs = []
    for _ in range(16):
        s = "".join(rng.choice(list(E.PROT_ALPHA), size=64))
        km = E.decode_kmer(int(keys[rng.integers(0, len(keys))]))
        seqs.append(s[:10] + km + s[18:])
    offsets, lengths = FastAnnotator.pad_batch(None, seqs)
    return db, offsets, lengths


@pytest.mark.parametrize("routed", [False, True])
def test_sharded_deep_bucket_sub_layout(deep, routed):
    """A deep-bucket DB probes through each shard's sub-bucket blocks and
    matches JAX's tables and probes and the single-device engine."""
    db, offsets, lengths = deep
    jm, tm = meshes((2, 4))
    jsdb = J.ShardedDB.from_db(as_jax_db(db), jm)
    tsdb = T.ShardedDB.from_db(db, tm)
    assert tsdb.sub_blocks is not None and tsdb.payload_wide is None
    assert_same_db(jsdb, tsdb)
    probe = J.probe_routed if routed else J.probe_sharded
    tprobe = T.probe_routed if routed else T.probe_sharded
    assert_planes(probe(jsdb, offsets, lengths), tprobe(tsdb, offsets,
                                                        lengths))
    got = T.ShardedEngine(db, tm, routed=routed).probe_compact(offsets,
                                                               lengths)
    want = FastAnnotator(db, "cpu").probe_compact(offsets, lengths)
    assert len(want["pos"]) >= 16
    for k in want:
        assert np.array_equal(bits(got[k]), bits(want[k])), k


@pytest.mark.parametrize("shape", ROUTED_SHAPES)
def test_routed_probe_matches_jax(corpus, shape):
    """The routed probe's nine outputs (counters included) equal JAX's,
    its planes equal the replicated probe's, and nothing overflows at
    the default capacity."""
    offsets, lengths = corpus[3:]
    jsdb, tsdb = sharded(corpus, shape)
    got = T.probe_routed(tsdb, offsets, lengths)
    assert_planes(J.probe_routed(jsdb, offsets, lengths), got)
    assert_planes(T.probe_sharded(tsdb, offsets, lengths)[:5], got[:5])
    assert got[7].shape == (8,) and int(got[8].sum()) == 0


def test_routed_probe_overflow_fallback_exact(corpus):
    """At a tiny per-pair capacity the overflowing windows take the
    all_gather + psum fallback, exact and counted, as in JAX."""
    offsets, lengths = corpus[3:]
    jsdb, tsdb = sharded(corpus, (2, 4))
    kw = dict(capacity_factor=0.01, ov_frac=1.0)
    got = T.probe_routed(tsdb, offsets, lengths, **kw)
    assert_planes(J.probe_routed(jsdb, offsets, lengths, **kw), got)
    assert_planes(T.probe_sharded(tsdb, offsets, lengths)[:5], got[:5])
    assert int(got[7].sum()) > 0 and int(got[8].sum()) == 0


def test_routed_probe_drop_reporting(corpus):
    """Windows past both capacities read found = 0 and are counted in
    n_dropped, as in JAX."""
    offsets, lengths = corpus[3:]
    jsdb, tsdb = sharded(corpus, (2, 4))
    kw = dict(capacity_factor=0.01, ov_frac=10_000.0)
    got = T.probe_routed(tsdb, offsets, lengths, **kw)
    assert_planes(J.probe_routed(jsdb, offsets, lengths, **kw), got)
    n_drop = int(got[8].sum())
    assert n_drop > 0
    f_got = bits(got[0])
    f_want = bits(T.probe_sharded(tsdb, offsets, lengths)[0])
    assert (f_got <= f_want).all()
    assert f_want.sum() - f_got.sum() <= n_drop


def test_routed_engine_redispatches_on_drops(corpus):
    """Queries whose windows mostly fall in the first shard (DB kmers
    between long runs of A: hi 0) overflow both default capacities; the
    routed engine re-dispatches and still equals the JAX engine and the
    single-device one."""
    db, jdb = corpus[:2]
    jsdb, tsdb = sharded(corpus, (1, 8))
    rng = np.random.default_rng(3)
    from close_kmers_tpu_torch.ops import encoder as E
    seqs = ["".join(E.decode_kmer(int(k)) + "A" * 60 for k in
                    rng.choice(db.keys, size=3)) for _ in range(16)]
    offsets, lengths = FastAnnotator.pad_batch(None, seqs)
    assert int(T.probe_routed(tsdb, offsets, lengths)[8].sum()) > 0
    got = T.ShardedEngine(db, tsdb.mesh, routed=True).probe_compact(
        offsets, lengths)
    want = J.ShardedEngine(jdb, jsdb.mesh, routed=True).probe_compact(
        offsets, lengths)
    single = FastAnnotator(db, "cpu").probe_compact(offsets, lengths)
    assert len(single["pos"]) >= 48
    for k in want:
        assert np.array_equal(bits(got[k]), bits(want[k])), k
        assert np.array_equal(bits(got[k]), bits(single[k])), k


def parse_rows(rows, cap):
    return [bits(x) for x in DeviceFamilyScorer.finish_rollup_rows(
        bits(rows), cap)]


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
@pytest.mark.parametrize("routed", [True, False])
def test_serve_step_matches_jax(corpus, mapping, shape, routed):
    """The serving step's best pack and counters equal JAX's bit for bit
    and the single-device pack, its rollup rows parse to JAX's groups,
    with real engine params, in both probe modes."""
    db, jdb, _, offsets, lengths = corpus
    jmap, fam = mapping
    jsdb, tsdb = sharded(corpus, shape)
    jf, tf = J.shard_fam_table(fam, jsdb), T.shard_fam_table(fam, tsdb)
    assert np.array_equal(np.asarray(jf), tf.numpy())
    kw = dict(cap_seq=64, routed=routed)
    want = J.serve_step_sharded(jsdb, offsets, lengths,
                                params=JParams(min_hits=3, max_gap=150),
                                fam_shards=jf, **kw)
    got = T.serve_step_sharded(tsdb, offsets, lengths,
                               params=EngineParams(min_hits=3, max_gap=150),
                               fam_shards=tf, **kw)
    assert len(got) == 4
    assert_planes(want[:3], got[:3])
    assert_planes(parse_rows(want[3], 64), parse_rows(got[3], 64))
    single = JDS(jdb).best_batch_packed(offsets, lengths,
                                        JParams(min_hits=3, max_gap=150))
    assert np.array_equal(bits(got[0]), np.asarray(single))
    roll = JDFS(jdb, jmap).rollup(offsets, lengths, fams_per_seq_cap=64)
    assert_planes([bits(x) for x in roll], parse_rows(got[3], 64))
    assert int(got[2].sum()) == 0


def test_serve_step_params_matter(corpus):
    """Per-request EngineParams flow into the sharded scan."""
    offsets, lengths = corpus[3:]
    tsdb = sharded(corpus, (2, 4))[1]
    loose = T.serve_step_sharded(tsdb, offsets, lengths,
                                 params=EngineParams(min_hits=1))
    strict = T.serve_step_sharded(tsdb, offsets, lengths,
                                  params=EngineParams(min_hits=10))
    assert len(loose) == 3
    assert (bits(loose[0])[:, 0] >= bits(strict[0])[:, 0]).all()
    assert not np.array_equal(bits(loose[0]), bits(strict[0]))


def test_probe_step_hit_counts_sharded(corpus):
    """Per-sequence hit counts of the sharded probe grid equal the
    single-device compact probe's."""
    db, _, seqs = corpus[:3]
    fa = FastAnnotator(db, "cpu")
    offsets, lengths = fa.pad_batch(seqs[:8])
    tsdb = sharded(corpus, (2, 4))[1]
    found = bits(T.probe_sharded(tsdb, offsets, lengths)[0])
    assert np.array_equal(found.sum(axis=1),
                          np.diff(fa.probe_compact(offsets,
                                                   lengths)["row_off"]))


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_from_numpy_carries_jax_state(corpus, mapping, shape):
    """A port ShardedDB built from a JAX ShardedDB's arrays gives the
    JAX outputs."""
    offsets, lengths = corpus[3:]
    jm, tm = meshes(shape)
    jsdb = J.ShardedDB.from_db(corpus[1], jm)
    fields = {k: (None if getattr(jsdb, k) is None
                  else np.asarray(getattr(jsdb, k)))
              for k in T.ShardedDB.ARRAYS}
    fields.update({k: getattr(jsdb, k) for k in
                   ("n_steps", "m", "wide_w", "sub_w", "row_base",
                    "h_bounds")})
    tsdb = T.ShardedDB.from_numpy(fields, tm)
    assert_same_db(jsdb, tsdb)
    fam = mapping[1]
    want = J.serve_step_sharded(jsdb, offsets, lengths,
                                fam_shards=J.shard_fam_table(fam, jsdb),
                                cap_seq=64)
    got = T.serve_step_sharded(tsdb, offsets, lengths,
                               fam_shards=T.shard_fam_table(fam, tsdb),
                               cap_seq=64)
    assert_planes(want[:3], got[:3])
    assert_planes(parse_rows(want[3], 64), parse_rows(got[3], 64))
    assert_planes(J.probe_routed(jsdb, offsets, lengths),
                  T.probe_routed(tsdb, offsets, lengths))


def test_make_mesh_needs_cards_or_an_explicit_list():
    """Without a device list the mesh takes cards, and raises when the
    machine has fewer than asked (never the CPU); an explicit list must
    fill the mesh."""
    if torch.cuda.is_available():
        pytest.skip("this machine has cards; the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        T.make_mesh()
    with pytest.raises(RuntimeError, match="given"):
        T.make_mesh(2, 2, devices=["cpu"] * 3)
    m = T.make_mesh(2, None, devices=["cpu"] * 6)
    assert m.shape == {"data": 2, "table": 3} and len(m.entries) == 6
    assert not m.distributed


@pytest.mark.parametrize("routed", [False, True])
def test_kmer_engine_on_a_mesh_matches_jax(corpus, mapping, routed):
    """KmerEngine(mesh=) annotates like the JAX engine on its mesh (calls,
    hits, OTU votes, best calls), and its family path takes the host
    path as JAX's does."""
    from close_kmers_tpu.core.api import KmerEngine as JEngine
    db, jdb, seqs = corpus[:3]
    items = [(f"s{i}", s) for i, s in enumerate(seqs)]
    jm, tm = meshes((2, 4))
    jeng = JEngine(jdb, mesh=jm, routed=routed)
    teng = KmerEngine(db, None, mesh=tm, routed=routed)
    assert isinstance(teng.fa, T.ShardedEngine) and teng.fa.routed == routed
    kw = dict(want_hits=True, want_otu=True, want_best=True)
    params = JParams(min_hits=2, max_gap=30)
    rw, hw = jeng.annotate_with_hits(items, params, **kw)
    rg, hg = teng.annotate_with_hits(items, EngineParams(min_hits=2,
                                                         max_gap=30), **kw)
    assert sum(len(r.calls) for r in rg) > 5
    for a, b in zip(rw, rg):
        assert [(c.start, c.end, c.count, c.fI, bits(np.float32(c.weighted)))
                for c in a.calls] == \
            [(c.start, c.end, c.count, c.fI, bits(np.float32(c.weighted)))
             for c in b.calls]
        assert [vars(h) for h in a.hits] == [vars(h) for h in b.hits]
        assert a.otu.finalize() == b.otu.finalize()
        assert vars(a.best) == vars(b.best)
    for k in hw:
        assert np.array_equal(bits(hw[k]), bits(hg[k])), k
    assert teng._device_family_scorer(mapping[0]) is None


def test_kmer_engine_takes_a_device_or_a_mesh(corpus):
    tm = T.make_mesh(1, 2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        KmerEngine(corpus[0], "cpu", mesh=tm)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_on_cpu_entries(n):
    """The dry run's routed and replicated steps run on an explicit list
    of CPU entries (2 x 4, and 1 x 3); without cards and without a list
    it raises."""
    dryrun_multichip(n, devices=["cpu"] * n)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            dryrun_multichip(n)


def test_sharded_engine_hits_of_batch_matches_jax(corpus):
    """The per-sequence Hit lists (the NR preload's and
    annotate_best_match's interface) equal the JAX sharded engine's."""
    db, jdb, seqs = corpus[:3]
    jm, tm = meshes((2, 4))
    got = T.ShardedEngine(db, tm, routed=True).hits_of_batch(seqs)
    want = J.ShardedEngine(jdb, jm, routed=True).hits_of_batch(seqs)
    assert sum(map(len, got)) > 20
    assert [[vars(h) for h in hs] for hs in got] == \
        [[vars(h) for h in hs] for hs in want]
