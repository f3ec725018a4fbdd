"""Port parity for the engine's leftovers: ``TpuEngine`` (probe_padded,
hits_of_batch, hit_codes_of_batch, process_batch), ``replay_hits``,
``FastAnnotator.annotate`` / ``best_calls``, ``KmerEngine.best_call`` and
``core/family.py::annotate_best_match``, each against the JAX function on
the same DB and inputs (``tests/test_engine.py``'s and
``tests/test_family.py``'s corpora).  Zero tolerance: integers exactly,
floats by bits, objects field by field."""

import numpy as np
import pytest

from close_kmers_tpu.core import engine as JEng, family as JF, oracle as JO
from close_kmers_tpu.core.api import KmerEngine as JK
from close_kmers_tpu.db import family_db as JFD
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.core import engine as TEng, family as TF, \
    oracle as TO
from close_kmers_tpu_torch.core.api import KmerEngine as TK
from close_kmers_tpu_torch.db import family_db as TFD
import close_kmers_tpu_torch.params as TP

from test_engine import random_db, random_seqs
from test_torch_host import as_port_db, assert_same

PARAMS = [EngineParams(), EngineParams(min_hits=2, max_gap=30),
          EngineParams(min_hits=1), EngineParams(min_weighted_hits=3),
          EngineParams(order_constraint=1, min_hits=2)]


def tparams(p):
    """The port's EngineParams with ``p``'s fields."""
    return TP.EngineParams(**vars(p))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    jdb = random_db(rng)
    seqs = random_seqs(rng, jdb)
    seqs += ["", "ACD", "A" * 8, "MKLVINGKTACDEF"]
    db = as_port_db(jdb)
    return jdb, db, seqs, JEng.TpuEngine(jdb), TEng.TpuEngine(db, "cpu")


def test_probe_padded_matches_jax(setup):
    jdb, db, seqs, je, te = setup
    offsets, lengths = TEng.FastAnnotator.pad_batch(te, seqs)
    want = je.probe_padded(offsets, lengths)
    got = te.probe_padded(offsets, lengths)
    assert_same(want, got)
    assert int(got[0].sum()) > 50


def test_hits_of_batch_matches_jax(setup):
    jdb, db, seqs, je, te = setup
    for pad_to in (None, 512):
        want = je.hits_of_batch(seqs, pad_to=pad_to)
        got = te.hits_of_batch(seqs, pad_to=pad_to)
        assert_same([[vars(h) for h in hs] for hs in want],
                    [[vars(h) for h in hs] for hs in got])
    assert te.hits_of_batch([]) == []
    assert_same(je.hit_codes_of_batch(seqs), te.hit_codes_of_batch(seqs))
    assert_same(je.hit_codes_of_batch([]), te.hit_codes_of_batch([]))


@pytest.mark.parametrize("params", PARAMS)
def test_process_batch_matches_jax(setup, params):
    jdb, db, seqs, je, te = setup
    items = [(f"s{i}", s) for i, s in enumerate(seqs)]
    for kw in (dict(want_hits=True), dict(want_otu=False)):
        want = je.process_batch(items, params, **kw)
        got = te.process_batch(items, tparams(params), **kw)
        assert_same(want, got)
    assert sum(len(c) for c, _, _ in got) > 0


def test_replay_hits_matches_jax(setup):
    jdb, db, seqs, je, te = setup
    params = EngineParams(min_hits=3)
    for seq in seqs[:12]:
        runs = []
        for O, E, d, p in ((JO, JEng, jdb, params),
                           (TO, TEng, db, tparams(params))):
            calls, hits, otu = [], [], O.OtuStats()
            O.process_aa_seq(seq, d.lookup, p, [], hits.append, None)
            E.replay_hits(hits, p, calls, otu)
            runs.append((calls, otu.finalize()))
        assert_same(*runs)


def test_empty_db_matches_jax():
    from close_kmers_tpu.db.signature_db import SignatureDB
    jdb = SignatureDB.from_entries([])
    items = [("a", "MKLVINGKTACDEF"), ("b", "")]
    assert_same(JEng.TpuEngine(jdb).process_batch(items),
                TEng.TpuEngine(as_port_db(jdb), "cpu").process_batch(items))


@pytest.mark.parametrize("params", PARAMS[:3])
def test_fast_annotator_matches_jax(setup, params):
    jdb, db, seqs, je, te = setup
    jfa, tfa = JEng.FastAnnotator(jdb), TEng.FastAnnotator(db, "cpu")
    assert_same(jfa.annotate(seqs, params, want_votes=True),
                tfa.annotate(seqs, tparams(params), want_votes=True))
    assert_same(jfa.best_calls(seqs, jdb.function_of, params),
                tfa.best_calls(seqs, db.function_of, tparams(params)))


def test_kmer_engine_best_call_matches_jax(setup):
    jdb, db, seqs, je, te = setup
    jk, tk = JK(jdb), TK(db, "cpu")
    items = [(f"s{i}", s) for i, s in enumerate(seqs)]
    n_named = 0
    for jr, tr in zip(jk.annotate(items), tk.annotate(items)):
        jb, tb = jk.best_call(jr.calls), tk.best_call(tr.calls)
        assert_same(jb, tb)
        n_named += bool(tb.function)
    assert n_named > 5


# -- annotate_best_match on test_family.py's universe -----------------------

FUNCS = ["DNA gyrase subunit B", "Acetate kinase", "hypothetical protein"]
FAM_SPEC = [("fig|100.1.peg.1", 0, "Leptospira", "1"),
            ("fig|100.1.peg.2", 0, "Bacillus", "2"),
            ("fig|100.1.peg.3", 1, "Leptospira", "3"),
            ("fig|100.1.peg.4", 2, "Bacillus", "4")]


@pytest.fixture(scope="module")
def universe(tmp_path_factory):
    """test_family.py's universe, built by each package from the same
    files: a DB, its TpuEngine and a mapping with the NR preloaded."""
    from close_kmers_tpu.db.signature_db import SignatureDB
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("fam")
    alpha = list("ACDEFGHIKLMNPQRSTVWY")
    prots = {peg: "".join(rng.choice(alpha, size=90))
             for peg, *_ in FAM_SPEC}
    (tmp / "genus.map").write_text("Leptospira\t171\nBacillus\t1386\n")
    (tmp / "families.dat").write_text("".join(
        f"GF0000000{i}\t1\t1\t{peg}\t{len(prots[peg])}\t{FUNCS[fi]}\t{lf}\t"
        f"{genus}\t{lf}\n" for i, (peg, fi, genus, lf) in enumerate(FAM_SPEC)))
    (tmp / "families.nr").write_text("".join(
        f">{peg}\n{prots[peg]}\n" for peg, *_ in FAM_SPEC))
    seen = {}
    for peg, fi, _, _ in FAM_SPEC:
        p = prots[peg]
        for i in range(len(p) - 7):
            seen.setdefault(p[i:i + 8], (p[i:i + 8], 10, fi, 1.0, -1))
    jdb = SignatureDB.from_entries(seen.values(), functions=FUNCS)
    db = as_port_db(jdb)
    out = {}
    for name, FD, eng in (("jax", JFD, JEng.TpuEngine(jdb)),
                          ("port", TFD, TEng.TpuEngine(db, "cpu"))):
        m = FD.KmerFamilyMapping()
        m.load_genus_map(str(tmp / "genus.map"))
        m.load_families(str(tmp / "families.dat"))
        assert m.load_nr(str(tmp / "families.nr"), eng) == 4
        out[name] = (eng, m)
    return jdb, db, prots, out


def test_annotate_best_match_matches_jax(universe):
    jdb, db, prots, out = universe
    rng = np.random.default_rng(11)
    items = [(peg, p) for peg, p in prots.items()]
    pegs = list(prots.values())
    for k in range(12):       # chimeras of two proteins, fragments, junk
        a, b = pegs[k % 4], pegs[(k + 1 + k // 4) % 4]
        cut = int(rng.integers(20, 70))
        items.append((f"q{k}", a[:cut] + b[cut:]))
    items += [("frag", pegs[0][10:40]), ("junk", "MKKKKKKKKLVVVVV"),
              ("empty", "")]
    (je, jm), (te, tm) = out["jax"], out["port"]
    placed = 0
    for kw in (dict(), dict(allow_ambiguous=True),
               dict(target_genus_id=171), dict(genus_filter=False),
               dict(params=EngineParams(min_hits=3), kmer_hit_threshold=1)):
        tkw = dict(kw)
        if "params" in kw:
            tkw["params"] = tparams(kw["params"])
        want = JF.annotate_best_match(je, items, jm, jdb.function_of, **kw)
        got = TF.annotate_best_match(te, items, tm, db.function_of, **tkw)
        assert_same(want, got)
        placed += sum(1 for _, m in got if m.gfam_id)
    assert placed > 10
