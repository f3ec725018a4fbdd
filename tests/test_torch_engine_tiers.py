"""Port parity for the probe tiers of core/engine: for each tier the JAX
auto-ladder or its ``from_db`` flags pick (payload_wide, fused_wide,
sub_blocks, lo_wide, the binary search), the port's ``DeviceDB`` holds
the JAX ``DeviceDB``'s tables field by field, and its ``probe_windows``
gives the JAX probe's outputs.  Zero tolerance: every plane is integer or
a bitcast f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from close_kmers_tpu.core import engine as E
from close_kmers_tpu.core.device_score import DeviceScorer as JaxScorer
from close_kmers_tpu_torch.core import engine as T
from close_kmers_tpu_torch.db.signature_db import SignatureDB
from close_kmers_tpu_torch.params import LO_CARD, EngineParams
from close_kmers_tpu_torch.core.device_score import DeviceScorer
from close_kmers_tpu_torch.ops.probe_select import probe_select

from test_engine import random_db, random_seqs
from test_torch_host import as_jax_db, as_port_db

# tests/test_engine.py::test_probe_layout_parity's six variants
VARIANTS = {
    "binary_search": dict(wide=False, sub=False, wide_lo=False, fused=False),
    "scale_lo_wide": dict(wide=False, sub=False, fused=False),
    "fused_wide": dict(wide=False, sub=False),
    "sub_blocks": dict(wide=False, sub=True, fused=False),
    "lo_wide": dict(wide=True, wide_payload=False, fused=False),
    "payload_wide": dict(wide=True, wide_payload=True),
}
WIDTHS = ("wide_w", "sub_w", "fused_w", "n", "n_steps")


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def spell(rng, db, B, L, n_kmers):
    """[B, L] offsets whose sequence b is ``n_kmers`` back-to-back DB
    kmers of one function (so that calls form), then random residues."""
    offsets = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    pow20 = 20 ** np.arange(7, -1, -1, dtype=np.int64)
    for b in range(B):
        f = db.fi[rng.integers(0, len(db))]
        keys = db.keys[rng.choice(np.nonzero(db.fi == f)[0], size=n_kmers)]
        offsets[b, :8 * n_kmers] = ((keys[:, None] // pow20) % 20).reshape(-1)
    return offsets, np.full(B, L, dtype=np.int32)


@pytest.fixture(scope="module")
def shallow():
    """tests/test_engine.py's setup corpus (seed 42)."""
    rng = np.random.default_rng(42)
    db = as_port_db(random_db(rng))
    offsets, lengths = E.FastAnnotator(as_jax_db(db)).pad_batch(
        random_seqs(rng, db))
    return db, offsets, lengths


@pytest.fixture(scope="module")
def deep():
    """The seed-11 DB of test_sub_bucket_probe_matches_binary_search:
    ~160 keys per hi bucket, past every wide gate."""
    rng = np.random.default_rng(11)
    n = 80_000
    his = rng.integers(1000, 1500, size=n, dtype=np.int64)
    los = rng.integers(0, LO_CARD, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD + los)
    db = SignatureDB(
        keys,
        rng.integers(0, 99, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 3.0, size=len(keys)).astype(np.float32),
        functions=[f"fn{i}" for i in range(99)])
    offsets, lengths = spell(rng, db, 16, 96, 10)
    return db, offsets, lengths


def assert_tables_equal(jd, td):
    for f in T.DeviceDB.ARRAYS:
        a, b = getattr(jd, f), getattr(td, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), f
    for w in WIDTHS:
        assert getattr(jd, w) == getattr(td, w), w


def jax_fields(jd):
    fields = {f: (None if getattr(jd, f) is None
                  else np.asarray(getattr(jd, f))) for f in T.DeviceDB.ARRAYS}
    fields.update({w: getattr(jd, w) for w in WIDTHS})
    return fields


def assert_probes_equal(jd, td, offsets, lengths):
    """The port's probe_windows against the JAX _probe_batch_jit (five
    planes) and the JAX probe_windows (all six, idx included)."""
    o, ln = jnp.asarray(offsets), jnp.asarray(lengths)
    jit = E._probe_batch_jit(jd.bucket_pair, jd.lo, jd.payload, jd.n,
                             jd.n_steps, o, ln, jd.lo_wide, jd.payload_wide,
                             jd.wide_w, jd.sub_header, jd.sub_blocks,
                             jd.sub_w, jd.fused_wide, jd.fused_w)
    eager = E.probe_windows(jd, *E.encode_windows(o, ln))
    got = T.probe_windows(td, *T.encode_windows(torch.from_numpy(offsets),
                                                 torch.from_numpy(lengths)))
    for k, g in enumerate(got):
        if k < 5:
            assert np.array_equal(bits(jit[k]), bits(g.numpy())), k
        assert np.array_equal(bits(eager[k]), bits(g.numpy())), k
    return got


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tables_match_jax(shallow, name):
    db, _, _ = shallow
    jd = E.DeviceDB.from_db(as_jax_db(db), **VARIANTS[name])
    td = T.DeviceDB.from_db(db, "cpu", **VARIANTS[name])
    assert td.tier == name.replace("scale_", "")
    assert_tables_equal(jd, td)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_probe_matches_jax(shallow, name):
    db, offsets, lengths = shallow
    jd = E.DeviceDB.from_db(as_jax_db(db), **VARIANTS[name])
    td = T.DeviceDB.from_db(db, "cpu", **VARIANTS[name])
    got = assert_probes_equal(jd, td, offsets, lengths)
    assert int(got[0].sum()) > 1000


@pytest.mark.parametrize("name", list(VARIANTS))
def test_from_numpy_carries_each_tier(shallow, name):
    """The state carry-over: a port DeviceDB built from a JAX DeviceDB's
    arrays, in every tier, probes as the JAX one does."""
    db, offsets, lengths = shallow
    jd = E.DeviceDB.from_db(as_jax_db(db), **VARIANTS[name])
    td = T.DeviceDB.from_numpy(jax_fields(jd), "cpu")
    assert td.tier == name.replace("scale_", "")
    assert_tables_equal(jd, td)
    assert_probes_equal(jd, td, offsets, lengths)


def test_deep_db_sub_and_binary_search_match_jax(deep):
    """The seed-11 deep DB: the JAX auto-ladder's sub_blocks tier (forced
    by its flags) and the binary search (sub=False) build JAX's tables and
    probe as JAX does, and equal each other."""
    db, offsets, lengths = deep
    assert db.max_bucket > T.WIDE_BUCKET_MAX
    assert T.jax_tier(db) == "sub_blocks"
    outs = []
    for kw, tier in ((T.JAX_TIER_FLAGS["sub_blocks"], "sub_blocks"),
                     (dict(sub=False), "binary_search")):
        jd = E.DeviceDB.from_db(as_jax_db(db), **kw)
        td = T.DeviceDB.from_db(db, "cpu", **kw)
        assert td.tier == tier
        assert_tables_equal(jd, td)
        outs.append(assert_probes_equal(jd, td, offsets, lengths))
    assert int(outs[0][0].sum()) >= 16 * 10
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


def test_sub_tier_goes_through_probe_select(deep, monkeypatch):
    db, offsets, lengths = deep
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["sub_blocks"])
    before = probe_select.launches
    called = []

    def spy(*a):
        called.append(a[3] is td.sub_blocks)
        return probe_select(*a)

    monkeypatch.setattr(T, "probe_select", spy)
    T.probe_windows(td, *T.encode_windows(torch.from_numpy(offsets),
                                           torch.from_numpy(lengths)))
    assert called == [True]
    assert probe_select.launches == before     # CPU: the plain version


def _deep17():
    rng = np.random.default_rng(17)
    n = 40_000
    his = rng.integers(5000, 5080, size=n, dtype=np.int64)
    keys = np.unique(his * LO_CARD
                     + rng.integers(0, LO_CARD, size=n, dtype=np.int64))
    return SignatureDB(
        keys, rng.integers(0, 50, size=len(keys)).astype(np.int32),
        rng.integers(-1, 8, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 3.0, size=len(keys)).astype(np.float32))


@pytest.mark.parametrize("which,tier", [
    ("shallow", "payload_wide"),
    ("deep11", "sub_blocks"),
    ("deep17", "sub_blocks"),
    ("empty", "binary_search"),
])
def test_auto_ladder_picks_jax_tier(shallow, deep, which, tier):
    """With no flags the JAX package picks ``tier`` (jax_tier, the oracle
    of its choice) for the seed-42 corpus, the seed-11 deep DB, the seed-17
    DB of test_deep_bucket_db_picks_sub_not_fused and the empty DB; the
    port builds the same tables under the flags that force that tier, and
    its own auto pick is card_tier's (test_torch_tier_gates.py)."""
    db = {"shallow": lambda: shallow[0], "deep11": lambda: deep[0],
          "deep17": _deep17,
          "empty": lambda: SignatureDB.from_entries([])}[which]()
    jd = E.DeviceDB.from_db(as_jax_db(db))
    td = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS[tier])
    assert T.jax_tier(db) == td.tier == tier
    assert_tables_equal(jd, td)
    assert T.DeviceDB.from_db(db, "cpu").tier == T.card_tier(db)


@pytest.mark.parametrize("rows_only", [False, True])
def test_probe_compact_on_sub_tier(deep, rows_only):
    db, offsets, lengths = deep
    jfa, tfa = E.FastAnnotator(as_jax_db(db)), T.FastAnnotator(db, "cpu")
    tfa.ddb = T.DeviceDB.from_db(db, "cpu", **T.JAX_TIER_FLAGS["sub_blocks"])
    assert tfa.ddb.tier == "sub_blocks" and jfa.ddb.sub_blocks is not None
    want = jfa.probe_compact(offsets, lengths, rows_only=rows_only)
    got = tfa.probe_compact(offsets, lengths, rows_only=rows_only)
    assert sorted(want) == sorted(got) and want["row_off"][-1] >= 160
    for k in want:
        assert np.array_equal(bits(want[k]), bits(got[k])), k


@pytest.mark.parametrize("slim", [0, 2, 3])
def test_device_scorer_on_sub_tier(deep, slim):
    db, offsets, lengths = deep
    js = JaxScorer(as_jax_db(db))
    ts = DeviceScorer(db, "cpu", T.DeviceDB.from_db(
        db, "cpu", **T.JAX_TIER_FLAGS["sub_blocks"]))
    assert ts.ddb.tier == "sub_blocks" and js.ddb.sub_blocks is not None
    want, wcap = js.score_batch_packed(offsets, lengths, EngineParams(),
                                       calls_per_seq_cap=4, slim=slim)
    got, gcap = ts.score_batch_packed(offsets, lengths, EngineParams(),
                                      calls_per_seq_cap=4, slim=slim)
    want = np.asarray(want)
    assert wcap == gcap and int(want[:len(offsets)].sum()) >= 16
    assert np.array_equal(want, got.numpy())
