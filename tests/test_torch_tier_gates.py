"""The port's tier pick and the JAX gates (core/engine.py): ``from_db``
with no flags builds ``card_tier``'s pick (CARD_TIER) for every DB the
tier tests use, without the statistics pass; ``flag_tier``, the JAX
gates as a pure function of ``tier_stats``, which equals what they
compute by ``np.unique``, names what the JAX ``from_db`` builds under
each flag set; ``tier_bytes`` is what ``tier_tables`` holds; the JAX
picks at the scale DBs' statistics, where the binary search has the
smallest tables; and, for each DB where the port's pick differs from the
JAX package's, the port's tables equal the JAX ``from_db``'s forced to
that tier by its flags."""

import numpy as np
import pytest

from close_kmers_tpu.core import engine as E
from close_kmers_tpu_torch.core import engine as T
from close_kmers_tpu_torch.db.signature_db import SignatureDB
from close_kmers_tpu_torch.params import LO_CARD

from test_engine import random_db
from test_torch_cuda import search_db
from test_torch_engine import _bucket_db
from test_torch_engine_tiers import (VARIANTS, _deep17, assert_tables_equal,
                                     deep, shallow)  # noqa: F401 (fixtures)
from test_torch_host import as_jax_db, as_port_db


def _deep11():
    rng = np.random.default_rng(11)
    n = 80_000
    keys = np.unique(rng.integers(1000, 1500, size=n, dtype=np.int64)
                     * LO_CARD + rng.integers(0, LO_CARD, size=n))
    return SignatureDB(keys, rng.integers(0, 99, size=len(keys)),
                       np.zeros(len(keys)), np.zeros(len(keys)),
                       np.ones(len(keys)))


# every DB the tier tests build, by name
DBS = {
    "shallow": lambda: as_port_db(random_db(np.random.default_rng(42))),
    "corpus5": lambda: as_port_db(random_db(np.random.default_rng(5))),
    "deep11": _deep11,
    "deep17": _deep17,
    "empty": lambda: SignatureDB.from_entries([]),
    "bucket40": lambda: _bucket_db(depth=40, lo_span=LO_CARD),
    "bucket130": lambda: _bucket_db(depth=130, lo_span=LO_CARD),
    "bucket300": lambda: _bucket_db(depth=300, lo_span=512),
    "search0": lambda: search_db(0)[0],
}


@pytest.fixture(scope="module", params=sorted(DBS))
def named_db(request):
    return request.param, DBS[request.param]()


def test_auto_ladder_builds_card_tier(named_db, monkeypatch):
    """The pick reads nothing of the DB: no statistics pass."""
    name, db = named_db

    def no_stats(db):
        raise AssertionError("from_db with no flags read the statistics")

    monkeypatch.setattr(T, "tier_stats", no_stats)
    td = T.DeviceDB.from_db(db, "cpu")
    assert td.tier == T.card_tier(db) == T.CARD_TIER, name


def test_stats_equal_the_jax_gates_view(named_db):
    """tier_stats's sub-bucket runs equal np.unique's counts, and the JAX
    gates read from the stats pick what jax_tier picks from the DB."""
    name, db = named_db
    st = T.tier_stats(db)
    skey = db.hi.astype(np.int64) * T.SUB + (db.lo >> T.SUB_SHIFT)
    _, ucnt = np.unique(skey, return_counts=True)
    assert (st.n, st.H, st.max_bucket) == (len(db), len(db.bucket_start) - 1,
                                           db.max_bucket)
    assert st.n_sub == len(ucnt)
    assert st.max_sub == (int(ucnt.max()) if len(db) else 0)
    assert T.flag_tier(st) == T.jax_tier(db), name


def test_tier_bytes_are_the_uploaded_tables():
    """Every tier of a DB over 4,096 hi buckets (~100 keys a bucket, so
    that no table is large)."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 4096 * LO_CARD, size=400_000))
    n = len(keys)
    db = SignatureDB(keys, rng.integers(0, 50, size=n), np.zeros(n),
                     np.zeros(n), np.ones(n), n_hi=4096)
    st = T.tier_stats(db)
    assert st.H == 4096 and st.max_bucket > 100
    for tier in T.TIERS:
        d = T.DeviceDB.from_numpy(T.tier_tables(db, tier), "cpu", copy=False)
        assert d.tier == tier
        # the uploaded arrays and, on the binary search, its search rows
        assert d.table_bytes() == T.tier_bytes(st, tier), tier


@pytest.mark.parametrize("name", list(VARIANTS))
def test_flag_tier_is_what_jax_builds(shallow, deep, name):  # noqa: F811
    """Under each of test_probe_layout_parity's flag sets, on the shallow
    DB and (where the flags keep wide off) the deep DB, flag_tier names
    the layout the JAX from_db builds, and the port's from_db builds it
    too."""
    for db in (shallow[0], deep[0])[:1 + (not VARIANTS[name]["wide"])]:
        jd = E.DeviceDB.from_db(as_jax_db(db), **VARIANTS[name])
        layouts = [f for f in ("fused_wide", "payload_wide", "sub_blocks",
                               "lo_wide") if getattr(jd, f) is not None]
        want = layouts[0] if layouts else "binary_search"
        assert T.flag_tier(T.tier_stats(db), **VARIANTS[name]) == want
        assert T.DeviceDB.from_db(db, "cpu", **VARIANTS[name]).tier == want


def test_tier_tables_refuse_an_unknown_tier():
    with pytest.raises(ValueError):
        T.tier_tables(DBS["shallow"](), "hash")


# (label, stats, the JAX package's pick): the DBs
# chip_smoke.py's scale phase made on the card (uniform seed 21, skewed
# seed 22; the skewed 9.7e8 one by --scale-keys 970978247), and the
# uniform 9.7e8-key one as Poisson bucket counts at that density
# estimate it
SCALE_STATS = [
    ("2.1e8 uniform", T.TierStats(n=210_000_000, H=3_200_000,
                                  max_bucket=108, fi_max=1999, max_sub=20,
                                  n_sub=50_264_648),
     "fused_wide"),
    ("2.1e8 skewed", T.TierStats(n=210_000_000, H=3_200_000,
                                 max_bucket=1532, fi_max=1999, max_sub=148,
                                 n_sub=38_663_476),
     "binary_search"),
    ("9.7e8 uniform", T.TierStats(n=970_978_247, H=3_200_000,
                                  max_bucket=393, fi_max=1999, max_sub=48,
                                  n_sub=51_199_987),
     "binary_search"),
    ("9.7e8 skewed", T.TierStats(n=970_978_247, H=3_200_000,
                                 max_bucket=4444, fi_max=1999, max_sub=350,
                                 n_sub=48_265_020),
     "binary_search"),
]


@pytest.mark.parametrize("label,st,jax", SCALE_STATS,
                         ids=[s[0] for s in SCALE_STATS])
def test_picks_at_scale_stats(label, st, jax):
    """The JAX gates' pick, and the port's tables within half the card."""
    assert T.flag_tier(st) == jax, label
    assert T.tier_bytes(st, T.CARD_TIER) <= 40 << 30


def test_binary_search_table_is_the_smallest_at_scale():
    """~20 B a key: the one tier that takes every scale DB."""
    for _, st, _ in SCALE_STATS:
        sizes = {t: T.tier_bytes(st, t) for t in T.TIERS}
        assert min(sizes, key=sizes.get) == "binary_search"
        assert sizes["binary_search"] < 21 * st.n


# the tier-test DBs whose port pick (the binary search, the card's
# fastest tier) differs from the JAX pick, with the JAX pick
DIFFERS = {"bucket130": "sub_blocks", "bucket40": "fused_wide",
           "corpus5": "payload_wide", "deep11": "sub_blocks",
           "deep17": "sub_blocks", "search0": "sub_blocks",
           "shallow": "payload_wide"}


@pytest.mark.parametrize("name", sorted(DBS))
def test_picks_differ_from_jax_only_where_named(name):
    db = DBS[name]()
    assert T.card_tier(db) == "binary_search"
    assert T.jax_tier(db) == DIFFERS.get(name, "binary_search")


@pytest.mark.parametrize("name", sorted(DIFFERS))
def test_differing_pick_builds_jax_tables_of_its_tier(name):
    """Where the port picks another tier than the JAX package, its
    auto-built tables equal the JAX from_db's forced to that tier by its
    flags, and the JAX auto pick is the tier DIFFERS names."""
    db = DBS[name]()
    td = T.DeviceDB.from_db(db, "cpu")
    card = T.card_tier(db)
    jd = E.DeviceDB.from_db(as_jax_db(db), **T.JAX_TIER_FLAGS[card])
    assert td.tier == card != DIFFERS[name] == T.jax_tier(db)
    assert_tables_equal(jd, td)
