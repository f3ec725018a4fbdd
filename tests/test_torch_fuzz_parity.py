"""The port's parity fuzzer (``close_kmers_tpu_torch/scripts/fuzz_parity.py``)
on the CPU, where every kernel wrapper runs its plain version.

* Its round inputs equal the JAX round's (``scripts/fuzz_parity.py``)
  for the same seed, bit for bit: the JAX round is run until it builds
  its EngineParams, with ``SignatureDB`` and ``EngineParams`` (the names
  its body imports) patched to record their arguments; the patched
  EngineParams reads the round's proteins from the round's frame and
  stops it there, before any JAX engine is built.
* Whole port rounds pass on the CPU (the sharded step on four CPU
  entries, family rounds, a small wide round), and the port's TpuEngine
  equals the JAX TpuEngine on the captured inputs.
* The edge DB's buckets sit on the search rows' edges (12, 13, 25, 26
  keys), and the binary-search probe equals the oracle's lookup there.
* The command refuses to run without a card unless given ``--device
  cpu``, and a mismatch exits 1 with the seed.
"""

import dataclasses
import importlib
import sys

import numpy as np
import pytest
import torch

from close_kmers_tpu_torch.core.engine import (DeviceDB, TpuEngine,
                                               probe_windows)
from close_kmers_tpu_torch.scripts import fuzz_parity as F

G = importlib.import_module("scripts.fuzz_parity")


class _Captured(Exception):
    pass


def jax_round_inputs(monkeypatch, seed: int) -> dict:
    """The JAX round's DB arguments, DB, proteins and params for
    ``seed``."""
    import close_kmers_tpu.db.signature_db as jsdb
    import close_kmers_tpu.params as jparams
    got = {}
    real = jsdb.SignatureDB

    class Recording(real):
        def __init__(self, *args, **kw):
            got["db_args"] = (args, kw)
            super().__init__(*args, **kw)

    def engine_params(**kw):
        frame = sys._getframe(1).f_locals
        got.update(params=kw, seqs=list(frame["seqs"]), db=frame["db"],
                   deep=frame["deep"])
        raise _Captured

    monkeypatch.setattr(jsdb, "SignatureDB", Recording)
    monkeypatch.setattr(jparams, "EngineParams", engine_params)
    with pytest.raises(_Captured):
        G.one_round(seed)
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("seed", [1000, 1001, 1002, 1003, 1017])
def test_round_inputs_equal_the_jax_round(monkeypatch, seed):
    want = jax_round_inputs(monkeypatch, seed)
    got = F.round_inputs(seed)
    (keys, fi, oi, avg_off, wt), kw = want["db_args"]
    db = got.db
    assert np.array_equal(db.keys, keys)
    for a, b in ((db.fi, fi), (db.oi, oi), (db.avg_off, avg_off)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert wt.dtype == np.float32
    assert np.array_equal(db.wt.view(np.int32), wt.view(np.int32))
    assert db.functions == kw["functions"]
    assert got.seqs == want["seqs"]
    assert dataclasses.asdict(got.params) == dict(
        dataclasses.asdict(F.EngineParams()), **want["params"])
    assert got.deep == want["deep"]


def _hits_key(hits):
    return [(h.pos, h.fI, h.oI, h.avg_off, h.code,
             int(np.float32(h.wt).view(np.int32))) for h in hits]


def _calls_key(calls):
    return [(c.start, c.end, c.count, c.fI,
             int(np.float32(c.weighted).view(np.int32))) for c in calls]


@pytest.mark.parametrize("seed", [1000, 1001])
def test_tpu_engine_matches_the_jax_engine(monkeypatch, seed):
    """The port's TpuEngine on the round's inputs against the JAX
    TpuEngine on the JAX round's own DB, proteins and params."""
    from close_kmers_tpu.core.engine import TpuEngine as JaxEngine
    from close_kmers_tpu.params import EngineParams as JaxParams
    want_in = jax_round_inputs(monkeypatch, seed)
    got_in = F.round_inputs(seed)
    items = [(f"s{i}", s) for i, s in enumerate(got_in.seqs)]
    want = JaxEngine(want_in["db"]).process_batch(
        items, JaxParams(**want_in["params"]), want_hits=True)
    got = TpuEngine(got_in.db, "cpu").process_batch(items, got_in.params,
                                                    want_hits=True)
    assert sum(len(h) for _c, h, _o in want) > 0
    for (wc, wh, wo), (gc, gh, go) in zip(want, got, strict=True):
        assert _hits_key(gh) == _hits_key(wh)
        assert _calls_key(gc) == _calls_key(wc)
        assert go.otus_by_count == wo.otus_by_count


@pytest.mark.parametrize("seed", range(1000, 1008))
def test_one_round_on_the_cpu(seed):
    """Port rounds on the CPU as ``run`` plans them (family rounds at
    seeds 1002 and 1005), seed 1000 with a 64-row wide batch."""
    cov = F.Coverage()
    r, family, _ = F.round_plan(seed, card=False)
    wide = 64 if seed == 1000 else 0
    res = F.one_round(seed, "cpu", r, family, wide, cov)
    assert cov.rounds == 1 and cov.seqs == res["seqs"] >= 8
    assert cov.fallback_rows >= 1 and res["fallback_rows"] >= 1
    assert cov.routed_overflow > 0
    assert res["tier"] is not None and sum(cov.tiers.values()) == 1
    assert cov.family_rounds == int(family)
    assert cov.wide_rows == wide and (cov.wide_calls > 0) == bool(wide)


def test_edge_db_buckets_and_the_binary_search():
    """The edge DB has buckets of each size of EDGE_SIZES, and the
    binary-search probe (probe_search's plain version on the CPU) finds
    every key of them with its row's payload and misses codes beside
    them, as the oracle's lookup does."""
    db = F.edge_db(7)
    sizes = np.diff(db.bucket_start.astype(np.int64))
    for s in (12, 13, 25, 26):
        assert (sizes == s).sum() >= 40
    ddb = DeviceDB.from_db(db, "cpu")
    assert ddb.tier == "binary_search"
    rng = np.random.default_rng(7)
    near = db.keys + rng.integers(-2, 3, size=len(db))
    codes = np.concatenate([db.keys, near])
    hi = torch.from_numpy((codes // F.LO_CARD).astype(np.int32))
    lo = torch.from_numpy((codes % F.LO_CARD).astype(np.int32))
    valid = torch.ones(len(codes), dtype=torch.bool)
    found, fi, oi, av, wt, idx = probe_windows(ddb, hi, lo, valid)
    for k, c in enumerate(codes.tolist()):
        ent = db.lookup(c)
        assert bool(found[k]) == (ent is not None)
        if ent is not None:
            assert (int(fi[k]), int(oi[k]), int(av[k])) == ent[:3]
            assert np.float32(wt[k]) == np.float32(ent[3])
            assert db.keys[int(idx[k])] == c
    assert int(found[:len(db)].sum()) == len(db)


def test_edge_round_on_the_cpu():
    """A whole round over the edge DB meets hits in buckets of exactly
    12 and 13 keys and in pivot buckets."""
    cov = F.Coverage()
    F.one_round(2000, "cpu", 1, True, 0, cov, F.edge_db(2000))
    assert cov.hits["12"] > 0 and cov.hits["13"] > 0
    assert cov.hits["26+"] > 0 and cov.family_rounds == 1


def test_the_command_needs_a_card_unless_told(monkeypatch, capsys):
    """Without ``--device`` the command takes the card, and refuses
    without one; ``--device cpu`` runs (zero rounds here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        F.main(["--rounds", "1"])
    assert F.main(["--rounds", "0", "--device", "cpu"]) == 0
    assert "coverage: 0 rounds" in capsys.readouterr().out


def test_a_mismatch_exits_1_with_its_seed(monkeypatch, capsys):
    """A wrong fi in the compact hits is found, named with its seed, and
    the command exits 1."""
    real = F.FastAnnotator.probe_compact

    def wrong(self, *a, **kw):
        h = real(self, *a, **kw)
        h["fi"] = h["fi"] + (np.arange(len(h["fi"])) == 0)
        return h

    monkeypatch.setattr(F.FastAnnotator, "probe_compact", wrong)
    assert F.main(["--rounds", "1", "--seed0", "1003",
                   "--device", "cpu"]) == 1
    assert "MISMATCH: seed 1003:" in capsys.readouterr().out
