"""The frozen copies' outputs pinned at small seeds: a later change to
the port cannot move the benchmark's yardstick, and a change to a copy
shows here.  Each digest is sha256 over the outputs named."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import DATA

CPU = torch.device("cpu")


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else
                 np.ascontiguousarray(p).tobytes() if isinstance(
                     p, np.ndarray) else str(p).encode())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def tiny():
    from kserbench.gen.scale_db import scale_db
    from kserbench.gen.scale_mapping import scale_mapping
    from kserbench.gen.traffic import make_pool
    db = scale_db(300_000, True, 50, 5, CPU)
    uni = scale_mapping(db.keys, db.fi, db.functions)
    traffic = json.load(open(os.path.join(DATA, "traffic", "tiny.json")))
    return db, uni, make_pool(traffic, db, 9)


@pytest.mark.parametrize("aa_bias,want", [(False, "5c819a5d8598158c"), (True, "ea479138e4275f49")])
def test_scale_db(aa_bias, want):
    from kserbench.gen.scale_db import scale_db
    db = scale_db(50_000, aa_bias, 40, 77, CPU)
    assert digest(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                  "\n".join(db.functions)) == want


def test_scale_mapping(tiny):
    db, uni, _ = tiny
    assert digest(uni.offs, uni.vals, "\n".join(uni.pgf),
                  "\n".join(uni.plf), uni.genus_id,
                  "\n".join(uni.function)) == "79fbea752642081e"


def test_traffic_pool(tiny):
    _, _, pool = tiny
    assert digest(*[r.body for r in pool.requests + pool.warmup]) == "6e111449e8c3a6b5"


def test_spell():
    from kserbench.gen.scale_db import scale_db
    from kserbench.gen.spell import function_pool, spell
    db = scale_db(50_000, True, 40, 77, CPU)
    rng = np.random.default_rng(3)
    codes = spell(function_pool(db, rng), np.array([1, 5, 9]), rng)
    assert digest(codes) == "c2e6d2fc17ac3bf6"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_reference_answers(tiny, precision):
    from kserbench.harness.check import with_precision
    from kserbench.reference import oracle as O
    from kserbench.reference.answers import (RefDB, best_match_record,
                                             query_record)
    db, uni, pool = tiny
    ref = RefDB(db, uni)
    p = O.EngineParams()

    def answers():
        out = []
        for req in pool.requests[:4]:
            for i, sid in enumerate(req.ids):
                seq = pool.seq(req, i)
                out.append(query_record(ref, sid, seq, p))
                out.append(best_match_record(ref, sid, seq, p))
        return "".join(out)
    cast = np.float32 if precision == "f32" else O.bf16
    text = with_precision(answers, cast)
    assert "CALL\t" in text and "PGF_" in text
    assert digest(text) == {"f32": "f7698c37a0e84ad2", "bf16": "a5abb688cf17cfc0"}[precision]
