"""tests/test_dna.py's four cases on the port's CPU engine: the port's
core/dna.py (a copy of the JAX package's) driving the port's KmerEngine
must give the JAX engine's outputs on the same DB and inputs, and the
port's oracle where the original case checks the oracle.  Zero
tolerance: f32 weights as their bits."""

import numpy as np
import pytest

from close_kmers_tpu.core import dna as JD
from close_kmers_tpu.core.api import KmerEngine as JaxEngine
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.core import dna as TD
from close_kmers_tpu_torch.core import oracle as O
from close_kmers_tpu_torch.core.api import KmerEngine

from test_dna import BASES, CODON
from test_engine import random_db
from test_torch_host import as_jax_db, as_port_db, assert_same


@pytest.fixture(scope="module")
def corpus():
    """tests/test_dna.py's corpus (seed 2024), an engine of each
    package."""
    rng = np.random.default_rng(2024)
    db = as_port_db(random_db(rng))
    return rng, db, JaxEngine(as_jax_db(db)), KmerEngine(db, "cpu")


def call_key(c):
    return (c.start, c.end, c.count, c.fI,
            int(np.float32(c.weighted).view(np.int32)))


def test_dna_batch_matches_jax_and_oracle(corpus):
    rng, db, jeng, teng = corpus
    params = EngineParams(min_hits=3)
    contigs = []
    for i in range(6):
        prot = db._test_prots[i][:40]
        dna = "N" * int(rng.integers(0, 3)) + \
            "".join(CODON[c] for c in prot) + \
            "".join(rng.choice(list(BASES), size=int(rng.integers(0, 30))))
        contigs.append((f"c{i}", dna))
    for kw in (dict(), dict(want_hits=True)):
        want = JD.annotate_dna_batch(jeng, contigs, params, **kw)
        got = TD.annotate_dna_batch(teng, contigs, params, **kw)
        assert_same(got, want)
    n_with_calls = 0
    for (cid, dna), (calls, _h, otu) in zip(contigs, got):
        o_calls, o_otu = [], O.OtuStats()
        O.process_seq(dna, db.lookup, params, o_calls, None, o_otu)
        assert [call_key(c) for c in calls] == \
            [call_key(c) for c in o_calls], cid
        assert otu.otus_by_count == o_otu.otus_by_count
        n_with_calls += bool(calls)
    assert n_with_calls >= 4


def test_long_sequence_tiling_matches_jax(corpus):
    rng, db, jeng, teng = corpus
    parts = []
    total = 0
    while total < 30000:
        p = db._test_prots[int(rng.integers(0, len(db._test_prots)))]
        a = int(rng.integers(0, 40))
        s = p[a:a + int(rng.integers(8, 60))]
        parts.append(s)
        total += len(s)
        if rng.random() < 0.1:
            parts.append("X")
            total += 1
    seq = "".join(parts)
    h_tiled = TD.probe_long_sequence(teng, seq, tile=1024)
    assert_same(h_tiled, JD.probe_long_sequence(jeng, seq, tile=1024))
    h_ref = teng.fa.probe_compact(*teng.fa.pad_batch([seq]))
    for k in ("pos", "fi", "code"):
        assert np.array_equal(h_tiled[k], h_ref[k]), k
    assert np.array_equal(np.float32(h_tiled["wt"]).view(np.int32),
                          np.float32(h_ref["wt"]).view(np.int32))
    assert len(h_tiled["pos"]) > 1000


def test_probe_compact_plane_dropping_matches_jax(corpus):
    rng, db, jeng, teng = corpus
    seq = db._test_prots[0] * 4
    kw = dict(want_code=False, want_oi=False, want_avg=False)
    full = teng.fa.probe_compact(*teng.fa.pad_batch([seq]))
    slim = teng.fa.probe_compact(*teng.fa.pad_batch([seq]), **kw)
    assert_same(slim, jeng.fa.probe_compact(*jeng.fa.pad_batch([seq]), **kw))
    for k in ("pos", "fi", "wt"):
        assert np.array_equal(full[k], slim[k]), k
    assert not slim["oi"].any() and not slim["avg_off"].any()
    assert "code" not in slim


def test_annotate_long_sequence_matches_jax_and_oracle(corpus):
    rng, db, jeng, teng = corpus
    prot = db._test_prots[0]
    seq = prot * 3 + "XX" + prot
    params = EngineParams(min_hits=3, max_gap=50)
    calls, otu = TD.annotate_long_sequence(teng, "big", seq, params,
                                           tile=128)
    assert_same((calls, otu), JD.annotate_long_sequence(jeng, "big", seq,
                                                        params, tile=128))
    o_calls, o_otu = [], O.OtuStats()
    O.process_aa_seq(seq, db.lookup, params, o_calls, None, o_otu)
    assert [call_key(c) for c in calls] == [call_key(c) for c in o_calls]
    assert len(calls) > 0
    assert otu.otus_by_count == o_otu.otus_by_count
