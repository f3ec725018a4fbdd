"""The port's host modules against their JAX-package originals.

``close_kmers_tpu_torch`` keeps its own copies of the JAX package's
host-side modules (params, the encoder, translation, FASTA parsing, the
signature and family DBs, the oracle, family scoring, the native C++
scorer, the metrics, the DNA paths of core/dna.py, the DB builder and
its recall harness, propagate_names, the KMC reader, and the host-only
CLI tools kclient, kmerge and propagate_names).  Each case feeds
one module pair the same numpy-seeded inputs and asserts equal outputs
at zero tolerance: floats compare by bit pattern, objects field by
field.

The two helpers :func:`as_port_db` and :func:`as_jax_db` give the other
port tests a DB of each package over the same numpy arrays.
"""

import dataclasses
import io

import numpy as np
import pytest

import close_kmers_tpu.params as JP
from close_kmers_tpu.core import family as JF, oracle as JO
from close_kmers_tpu.db import family_db as JFD, signature_db as JSD
from close_kmers_tpu.io import fasta as JFA
from close_kmers_tpu.native import api as JN
from close_kmers_tpu.ops import encoder as JE, translate as JT
from close_kmers_tpu.utils import metrics as JM
import close_kmers_tpu_torch.params as TP
from close_kmers_tpu_torch.core import family as TF, oracle as TO
from close_kmers_tpu_torch.db import family_db as TFD, signature_db as TSD
from close_kmers_tpu_torch.io import fasta as TFA
from close_kmers_tpu_torch.native import api as TN
from close_kmers_tpu_torch.ops import encoder as TE, translate as TT
from close_kmers_tpu_torch.utils import metrics as TM

ALPHA = list(JE.PROT_ALPHA)


def _as_db(cls, db):
    out = cls(db.keys, db.fi, db.oi, db.avg_off, db.wt, list(db.functions),
              list(db.otus), db.n_hi)
    if hasattr(db, "_test_prots"):
        out._test_prots = db._test_prots
    return out


def as_port_db(db):
    """The port's SignatureDB over ``db``'s numpy arrays."""
    return _as_db(TSD.SignatureDB, db)


def as_jax_db(db):
    """The JAX package's SignatureDB over ``db``'s numpy arrays."""
    return _as_db(JSD.SignatureDB, db)


def as_jax_mapping(mapping):
    """The JAX package's KmerFamilyMapping with ``mapping``'s families and
    kmer->family CSR."""
    out = JFD.KmerFamilyMapping()
    out.families = [JFD.FamilyData(**vars(fd)) for fd in mapping.families]
    keys, offs, vals = mapping.fam_csr()
    for i, k in enumerate(keys.tolist()):
        for f in vals[offs[i]:offs[i + 1]].tolist():
            out.add_fam_mapping(f, k)
    return out


def norm(x):
    """A comparable form of ``x``: dataclasses and plain objects by class
    name and fields, arrays by dtype, shape and bytes, floats by bits."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple(norm(getattr(x, f.name))
                      for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return ("f", np.float64(x).tobytes())
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, dict):
        return ("dict", tuple((norm(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if hasattr(x, "__dict__") and not callable(x):
        return (type(x).__name__, norm(vars(x)))
    return x


def assert_same(a, b):
    assert norm(a) == norm(b)


def random_prots(rng, n, lo=20, hi=120):
    return ["".join(rng.choice(ALPHA, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def random_dna(rng, n, lo=30, hi=300):
    letters = list("acgtACGTnNrykm")
    p = np.array([.2, .2, .2, .2, .04, .04, .04, .04, .01, .01, .005, .005,
                  .005, .005])
    return ["".join(rng.choice(letters, size=int(rng.integers(lo, hi)),
                               p=p / p.sum())) for _ in range(n)]


def small_db_entries(rng, n_funcs=10, prot_len=60):
    """(entries, functions, reference proteins) of a family-style DB."""
    prots = random_prots(rng, n_funcs, prot_len, prot_len + 1)
    seen = {}
    for f, p in enumerate(prots):
        for i in range(len(p) - JP.K + 1):
            km = p[i:i + JP.K]
            if km not in seen:
                seen[km] = (km, int(rng.integers(0, 300)), f,
                            float(np.float32(rng.uniform(0.1, 5.0))),
                            int(rng.integers(-1, 10)))
    return list(seen.values()), [f"fn{i}" for i in range(n_funcs)], prots


def queries(rng, prots, n=24):
    """Queries of reference fragments, junk, lowercase and ambiguity."""
    out = []
    for _ in range(n):
        p = prots[int(rng.integers(len(prots)))]
        a = int(rng.integers(0, len(p) - 20))
        junk = "".join(rng.choice(ALPHA + ["X", "a", "*"], size=8))
        out.append(junk + p[a:a + int(rng.integers(12, 40))] + junk)
    return out


# -- one case per module ----------------------------------------------------

def check_params(rng, tmp_path):
    names = [n for n in dir(JP) if n.isupper()]
    assert names and names == [n for n in dir(TP) if n.isupper()]
    for n in names:
        assert_same(getattr(JP, n), getattr(TP, n))
    assert_same(JP.EngineParams(), TP.EngineParams())
    kw = dict(order_constraint=1, min_hits=3, min_weighted_hits=2, max_gap=50)
    assert_same(JP.EngineParams(**kw), TP.EngineParams(**kw))


def check_encoder(rng, tmp_path):
    seqs = random_prots(rng, 30) + ["", "MKVlk", "XXXXXXXXXXX", "ACDEFGHIK*Y"]
    for s in seqs:
        a, b = JE.seq_to_offsets(s), TE.seq_to_offsets(s)
        assert_same(a, b)
        assert_same(JE.windows_valid(a), TE.windows_valid(b))
        assert_same(JE.encode_windows_hi_lo(a), TE.encode_windows_hi_lo(b))
        assert JE.num_scanned_positions(len(s)) == \
            TE.num_scanned_positions(len(s))
    kmers = ["".join(rng.choice(ALPHA + ["x"], size=8)) for _ in range(200)]
    codes = [JE.encode_aa_kmer(k) for k in kmers]
    assert codes == [TE.encode_aa_kmer(k) for k in kmers]
    ok = [c for c in codes if c <= JP.MAX_ENCODED]
    assert [JE.decode_kmer(c) for c in ok] == [TE.decode_kmer(c) for c in ok]
    assert [JE.split_hi_lo(c) for c in ok] == [TE.split_hi_lo(c) for c in ok]
    raw = np.frombuffer("".join(kmers).encode("latin-1"), ">u8")
    assert_same(JE.raw_keys_to_encoded(raw), TE.raw_keys_to_encoded(raw))
    assert_same(JE.AA_TO_OFFSET, TE.AA_TO_OFFSET)


def check_translate(rng, tmp_path):
    reads = random_dna(rng, 40)
    for s in reads[:12]:
        assert JT.rev_comp(s) == TT.rev_comp(s)
        for off in range(3):
            assert JT.translate_kguts(s, off) == TT.translate_kguts(s, off)
            assert JT.translate_t11(s, off) == TT.translate_t11(s, off)
        assert_same(JT.six_frames_kguts(s), TT.six_frames_kguts(s))
        assert_same(JT.six_frame_kguts_offsets(s),
                    TT.six_frame_kguts_offsets(s))
        assert_same(JT.get_possible_proteins(s), TT.get_possible_proteins(s))
    assert_same(JT.batch_possible_protein_orfs(reads),
                TT.batch_possible_protein_orfs(reads))
    assert_same(JT.batch_orf_arrays(reads), TT.batch_orf_arrays(reads))


def check_oracle(rng, tmp_path):
    entries, funcs, prots = small_db_entries(rng)
    jdb = JSD.SignatureDB.from_entries(entries, functions=funcs)
    tdb = TSD.SignatureDB.from_entries(entries, functions=funcs)
    for oc in (0, 1):
        for s in queries(rng, prots, 12):
            res = []
            for O, db in ((JO, jdb), (TO, tdb)):
                params = (JP if O is JO else TP).EngineParams(
                    order_constraint=oc, min_hits=2 + oc)
                calls, hits, otu = [], [], O.OtuStats()
                O.process_aa_seq(s, db.lookup, params, calls, hits.append,
                                 otu)
                best = O.find_best_call(calls, db.function_of)
                text = "".join([O.format_call(c, db.function_of)
                                for c in calls]
                               + [O.format_hit(h, db.function_of)
                                  for h in hits]
                               + [O.format_otu_stats("q", len(s), otu)])
                res.append((calls, hits, otu.finalize(), best, text))
            assert_same(*res)
    dna = random_dna(rng, 4)
    for s in dna:
        a, b = [], []
        JO.process_seq(s, jdb.lookup, JP.EngineParams(min_hits=2), a)
        TO.process_seq(s, tdb.lookup, TP.EngineParams(min_hits=2), b)
        assert_same(a, b)


def check_signature_db(rng, tmp_path):
    entries, funcs, _ = small_db_entries(rng)
    jdb = JSD.SignatureDB.from_entries(entries, functions=funcs)
    tdb = TSD.SignatureDB.from_entries(entries, functions=funcs)
    assert_same(vars(jdb), vars(tdb))
    # each package saves, the other loads: every format round-trips
    for name, save, load in (("db.npz", "save_npz", "load_npz"),
                             ("db.mm", "save_mem_map", "load_mem_map"),
                             ("final.kmers", "save_final_kmers",
                              "load_final_kmers")):
        for src, other in ((jdb, TSD.SignatureDB), (tdb, JSD.SignatureDB)):
            p = str(tmp_path / f"{type(src).__module__}.{name}")
            getattr(src, save)(p)
            got = getattr(other, load)(p, functions=funcs)
            want = getattr(type(src), load)(p, functions=funcs)
            assert_same(vars(got), vars(want))
            assert len(got) == len(tdb)
    idx = str(tmp_path / "function.index")
    JSD.write_index_file(idx, funcs)
    assert JSD.load_index_file(idx) == TSD.load_index_file(idx) == funcs


def _families_files(rng, tmp_path):
    genus = tmp_path / "genus.map"
    genus.write_text("Escherichia\t561\nBacillus\t1386\n")
    rows = []
    for i in range(40):
        g = ["Escherichia", "Bacillus", "Nomap"][i % 3]
        rows.append("\t".join([f"PG{i % 9:08d}", "x", "x", f"fig|1.1.peg.{i}",
                               str(int(rng.integers(50, 500))),
                               f"function {i % 7}", "x", g,
                               str(int(rng.integers(1, 10 ** 9)))]))
    fams = tmp_path / "families.dat"
    fams.write_text("\n".join(rows) + "\nshort\tline\n")
    return str(genus), str(fams)


def check_family_db(rng, tmp_path):
    genus, fams = _families_files(rng, tmp_path)
    pairs = [(int(rng.integers(0, 20)), int(rng.integers(0, 5000)))
             for _ in range(300)]
    maps = []
    for FD in (JFD, TFD):
        m = FD.KmerFamilyMapping()
        m.load_genus_map(genus)
        m.load_families(fams)
        for f, k in pairs:
            m.add_fam_mapping(f, k)
            m.add_peg_mapping(f, k)
        out = io.StringIO()
        m.write_kmer_distribution(out)
        maps.append((m.families, m.peg_names, m.peg_to_family, m.genus_map,
                     m.fam_csr(), m.peg_csr(), m.family_meta_arrays(),
                     m.families_of_kmer(pairs[0][1]),
                     m.pegs_of_kmer(pairs[1][1]), out.getvalue(),
                     m.dump_sizes()))
    assert_same(*maps)


def check_fasta(rng, tmp_path):
    prots = random_prots(rng, 6)
    fa = "".join(f">s{i} desc {i}\n{p[:30]}\n{p[30:]}\n"
                 for i, p in enumerate(prots)) + ">empty\n\n>bad 1\nAC-DE\n"
    reads = random_dna(rng, 5, 20, 60)
    fq = "".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in
                 enumerate(reads))
    for data in (fa, fa.encode()):
        assert JFA.parse_fasta_bytes(data) == TFA.parse_fasta_bytes(data)
    assert JFA.parse_fastq_bytes(fq) == TFA.parse_fastq_bytes(fq)
    path = tmp_path / "x.fa"
    path.write_text(fa)
    assert list(JFA.parse_fasta_file(str(path))) == \
        list(TFA.parse_fasta_file(str(path)))
    # chunked parsing through the callbacks, cut at random places
    cuts = sorted(rng.integers(0, len(fa), size=6))
    for P in ((JFA.FastaParser, TFA.FastaParser),
              (JFA.FastqParser, TFA.FastqParser)):
        text = fa if P[0] is JFA.FastaParser else fq
        got = []
        for cls in P:
            seen, defs, errs = [], [], []
            p = cls(on_seq=lambda i, s: seen.append((i, s)),
                    on_def_seq=lambda *a: defs.append(a),
                    on_error=lambda *a: errs.append(a))
            for a, b in zip([0, *cuts], [*cuts, len(text)]):
                p.parse_chunk(text[a:b])
            p.parse_complete()
            got.append((seen, defs, errs))
        assert got[0] == got[1]


def _hit_arrays(rng, n_seqs=40):
    lens = rng.integers(0, 60, size=n_seqs)
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(row_off[-1])
    pos = np.concatenate([np.sort(rng.choice(120, size=k, replace=False))
                          for k in lens]).astype(np.int32)
    # runs of one function, some noise, offsets that mostly pass the
    # order_constraint drift test
    fi = np.where(rng.random(n) < 0.9, (pos // 40) % 4,
                  rng.integers(0, 4, size=n)).astype(np.int32)
    oi = rng.integers(-1, 8, size=n).astype(np.int32)
    av = (300 - pos + rng.integers(0, 3, size=n)).astype(np.int32)
    wt = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    return pos, fi, oi, av, wt, row_off


def check_native(rng, tmp_path):
    pos, fi, oi, av, wt, row_off = _hit_arrays(rng)
    for oc, mh in ((0, 2), (1, 3), (0, 5)):
        a = JN.score_batch(pos, fi, oi, av, wt, row_off,
                           JP.EngineParams(order_constraint=oc, min_hits=mh),
                           max_calls_per_seq=32, want_votes=True)
        b = TN.score_batch(pos, fi, oi, av, wt, row_off,
                           TP.EngineParams(order_constraint=oc, min_hits=mh),
                           max_calls_per_seq=32, want_votes=True)
        assert_same(a, b)
        assert int(b[0].sum()) > 5
        assert_same(JN.best_call_batch(*a[:6]), TN.best_call_batch(*b[:6]))
        assert_same(JN.best_call_batch(a[0], None, None, *a[3:6]),
                    TN.best_call_batch(b[0], None, None, *b[3:6]))
    keys = np.unique(rng.integers(0, 5000, size=400)).astype(np.int64)
    deg = rng.integers(1, 4, size=len(keys))
    offs = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    vals = rng.integers(0, 30, size=int(offs[-1])).astype(np.int32)
    codes = rng.integers(0, 5000, size=int(row_off[-1])).astype(np.int64)
    a = JN.family_scores(codes, row_off, keys, offs, vals)
    b = TN.family_scores(codes, row_off, keys, offs, vals)
    assert_same(a, b)
    assert int(b[0].sum()) > 20
    entries, funcs, prots = small_db_entries(rng)
    db = TSD.SignatureDB.from_entries(entries, functions=funcs)
    qs = queries(rng, prots, 16)
    L = max(map(len, qs)) + 8
    offsets = np.full((len(qs), L), 20, np.uint8)
    for i, q in enumerate(qs):
        offsets[i, :len(q)] = TE.seq_to_offsets(q)
    lengths = np.array([len(q) for q in qs], np.int32)
    assert_same(JN.HashPipeline(db).run(offsets, lengths, 2),
                TN.HashPipeline(db).run(offsets, lengths, 2))


def check_family(rng, tmp_path):
    genus, fams = _families_files(rng, tmp_path)
    n_fam = 20
    maps = []
    for FD in (JFD, TFD):
        m = FD.KmerFamilyMapping()
        m.load_genus_map(genus)
        m.load_families(fams)
        for k in range(3000):
            for f in rng.__class__(np.random.PCG64(k)).choice(
                    min(n_fam, len(m.families)), size=1 + k % 3,
                    replace=False):
                m.add_fam_mapping(int(f), k)
                m.add_peg_mapping(int(f), k)
        maps.append(m)
    out = []
    for F, O, m in ((JF, JO, maps[0]), (TF, TO, maps[1])):
        hit_rng = np.random.default_rng(7)
        per_seq = []
        for s in range(12):
            hits = [O.Hit(oI=0, pos=i, avg_off=0, fI=int(hit_rng.integers(3)),
                          wt=1.0, code=int(hit_rng.integers(0, 3000)))
                    for i in range(int(hit_rng.integers(0, 40)))]
            calls = [O.Call(0, 20, 6, int(hit_rng.integers(3)),
                            np.float32(hit_rng.uniform(1, 9)))
                     for _ in range(int(hit_rng.integers(0, 4)))]
            best = O.find_best_call(calls, lambda i: m.families[i].function)
            fam_sc = F.accumulate_family_scores(hits, m)
            peg_sc = F.accumulate_peg_scores(hits, m)
            row = [fam_sc, peg_sc, F.all_matches_rows(fam_sc, m, 2),
                   F.all_matches_rows(peg_sc, m, 2, family_mode=False)]
            for amb, g, tg in ((False, True, 0), (True, True, 561),
                               (False, False, 1386)):
                bm = F.find_best_family_match(best, fam_sc, m, 2, amb, tg, g)
                row += [bm, F.format_best_match_lookup(f"s{s}", bm),
                        F.format_best_match_fq(bm)]
            per_seq.append(row)
        # the batched scan, fed one numpy rollup through BestCallReduction
        nf = np.array([1, 2, 0], np.int32)
        ofi = np.array([[0, 0, 0], [1, 2, 0], [0, 0, 0]], np.int32)
        ocnt = np.array([[9, 0, 0], [7, 7, 0], [0, 0, 0]], np.int32)
        owt = np.array([[5, 0, 0], [4, 4, 0], [0, 0, 0]], np.float32)
        red = F.BestCallReduction(nf, ofi, ocnt, owt,
                                  [fd.function for fd in m.families[:5]])
        n_per = np.array([3, 2, 1], np.int32)
        fam = np.array([0, 1, 2, 3, 4, 5], np.int32)
        cnt = np.array([5, 4, 3, 6, 2, 8], np.int32)
        wt = np.array([2.5, 1.0, 3.0, 0.5, 2.0, 4.0], np.float32)
        first = np.array([3, 1, 2, 0, 1, 0], np.int32)
        per_seq.append([red.best_call(s) for s in range(3)])
        per_seq.append(F.find_best_family_matches_batch(
            red, n_per, fam, cnt, wt, first, m, 2))
        cols = F.find_best_family_matches_batch(
            red, n_per, fam, cnt, wt, first, m, 2, as_arrays=True)
        per_seq.append([cols.materialize(i) for i in range(len(cols))])
        out.append(per_seq)
    assert_same(*out)
    placed = [m for row in out[1][:12] for m in row[4::3] if m.gfam_id]
    assert len(placed) > 5


def check_dna(rng, tmp_path):
    """core/dna.py's three functions on an engine of each package over
    the same DB: coding contigs, random DNA with ambiguity codes, and a
    long protein tiled into 512-aa tiles."""
    from close_kmers_tpu.core import dna as JDNA
    from close_kmers_tpu.core.api import KmerEngine as JK
    from close_kmers_tpu_torch.core import dna as TDNA
    from close_kmers_tpu_torch.core.api import KmerEngine as TK
    from test_dna import CODON

    entries, funcs, prots = small_db_entries(rng)
    je = JK(JSD.SignatureDB.from_entries(entries, functions=funcs))
    te = TK(TSD.SignatureDB.from_entries(entries, functions=funcs), "cpu")
    contigs = [(f"r{i}", s) for i, s in enumerate(random_dna(rng, 4))]
    contigs += [(f"c{i}", "N" * i + "".join(CODON[c] for c in p[5:55])
                 + "ACGTTGCA"[:i]) for i, p in enumerate(prots[:5])]
    for kw in (dict(), dict(want_hits=True, want_otu=False)):
        out = [D.annotate_dna_batch(e, contigs, P.EngineParams(min_hits=2),
                                    **kw)
               for D, e, P in ((JDNA, je, JP), (TDNA, te, TP))]
        assert_same(*out)
        assert sum(len(calls) for calls, _h, _o in out[1]) > 3
    long = "".join(p[int(a):int(a) + 40] + "X" for p, a in zip(
        prots * 8, rng.integers(0, 20, size=8 * len(prots))))
    assert len(long) > 1024
    for tile in (512, 4096):
        assert_same(JDNA.probe_long_sequence(je, long, tile),
                    TDNA.probe_long_sequence(te, long, tile))
        assert_same(
            JDNA.annotate_long_sequence(je, "big", long,
                                        JP.EngineParams(max_gap=50), tile),
            TDNA.annotate_long_sequence(te, "big", long,
                                        TP.EngineParams(max_gap=50), tile))


def annotated_genomes(rng, tmp, n_genomes=6, n_funcs=8, prot_len=60,
                      p_mut=0.03):
    """Annotated protein FASTA files, one a genome: each function's
    protein recurs in every genome with point mutations at rate
    ``p_mut``, one function in a few genomes only, one named by two roles.
    Returns the file paths."""
    alpha = np.array(ALPHA)
    base = rng.choice(alpha, size=(n_funcs, prot_len))
    names = [f"Function {f}" for f in range(n_funcs)]
    names[-1] = "Role X / Role Y"
    paths = []
    for g in range(n_genomes):
        body = []
        for f in range(n_funcs):
            if f == 1 and g % 3:
                continue                       # a function in few genomes
            prot = base[f].copy()
            mut = rng.random(prot_len) < p_mut
            prot[mut] = rng.choice(alpha, size=int(mut.sum()))
            body.append(f">fig|{100 + g}.1.peg.{f + 1} {names[f]}\n"
                        f"{''.join(prot)}\n")
        path = tmp / f"genome{g:02d}.fa"
        path.write_text("".join(body))
        paths.append(str(path))
    return paths


def _files_of(d):
    """{relative path: bytes} of every file under ``d``."""
    import os
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, d)] = fh.read()
    return out


def check_builder(rng, tmp_path):
    from close_kmers_tpu.db import builder as JB
    from close_kmers_tpu_torch.db import builder as TB
    files = annotated_genomes(rng, tmp_path)
    defs = tmp_path / "defs.tsv"
    defs.write_text("fig|100.1.peg.1\tFunction 0 # a comment\n")
    keep = tmp_path / "keep.fa"
    keep.write_text(">fig|999.1.peg.1 Kept function\n"
                    + "".join(rng.choice(ALPHA, size=50)) + "\n")
    assert TB.strip_func_comment("A # b") == JB.strip_func_comment("A # b")
    assert TB.roles_of_function("A / B @ C; D") == \
        JB.roles_of_function("A / B @ C; D")
    got = []
    for B in (JB, TB):
        for kw in (dict(good_roles=["Role Y"]),
                   dict(good_functions=["Function 1"], min_reps_required=3)):
            r = B.build_signature_kmers(files, [str(keep)], [str(defs)], **kw)
            out = tmp_path / f"{B.__name__}.{len(got)}"
            r.write_data_dir(str(out), mem_map=True)
            r.write_final_kmers(str(out / "extra.kmers"))
            got.append((r.stats, r.fm.functions_by_index(),
                        r.kept_kmer_strings(), vars(r.to_signature_db()),
                        _files_of(out)))
        x = B.build_signature_kmers_external(
            files, [str(keep)], [str(defs)], 5, (), ["Role Y"],
            work_dir=str(tmp_path / f"{B.__name__}.work"),
            buffer_records=500)
        out = tmp_path / f"{B.__name__}.external"
        x.write_data_dir(str(out))
        got.append((vars(x.to_signature_db()), _files_of(out)))
    assert_same(got[:3], got[3:])
    assert len(got[0][2]) > 200 and "Role X / Role Y" in got[0][1]


def check_recall(rng, tmp_path):
    from close_kmers_tpu.core.api import KmerEngine as JK
    from close_kmers_tpu.db import builder as JB, recall as JR
    from close_kmers_tpu_torch.core.api import KmerEngine as TK
    from close_kmers_tpu_torch.db import recall as TR
    files = annotated_genomes(rng, tmp_path, p_mut=0.08)
    r = JB.build_signature_kmers(files, min_reps_required=3)
    jdb = r.to_signature_db()
    vdir = tmp_path / "valid"
    (vdir / "anno").mkdir(parents=True)
    (vdir / "seq").mkdir()
    for i, f in enumerate(files[:3]):
        text = open(f).read()
        (vdir / "seq" / f"s{i}.fa").write_text(text + ">\nMKLV\n")
        (vdir / "anno" / f"a{i}").write_text("".join(
            f"{ln[1:].split()[0]}\t{'Function 2' if i else ln.split(' ', 1)[1]}"
            f"\n" for ln in text.splitlines() if ln.startswith(">")))
    got = []
    for R, eng in ((JR, JK(jdb)), (TR, TK(as_port_db(jdb), "cpu"))):
        out = tmp_path / R.__name__
        R.run_recall(eng, r.fm, files, str(out), 3, 100)
        text = io.StringIO()
        totals = R.run_validation(eng, str(vdir), 3, 100, verbose=True,
                                  out=text)
        got.append((_files_of(out), text.getvalue(), totals))
    assert_same(*got)
    assert got[1][2]["correct"] > 5 and got[1][2]["incorrect"] > 0


def check_propagate_names(rng, tmp_path):
    from close_kmers_tpu.db import propagate_names as JP_
    from close_kmers_tpu_torch.db import propagate_names as TP_
    from test_propagate_names import write_release
    fids = [f"fig|1.1.peg.{i}" for i in range(12)]
    pegsyn = [(f"md5_{i}", [f]) for i, f in enumerate(fids)]
    old_rows = [(f"GFOLD{i % 4}", f, f"fn{i % 4}", str(i % 4), "G")
                for i, f in enumerate(fids[:10])]
    new_rows = [(f"GFNEW{i % 5}", f, f"fn{i % 5}", str(i % 5), "G")
                for i, f in enumerate(fids[2:])]
    rel = {n: write_release(tmp_path, n, "G", pegsyn, rows)
           for n, rows in (("old", old_rows), ("new", new_rows))}
    got = []
    for M in (JP_, TP_):
        for fam_type in (M.GLOBAL, "local"):
            fd = {}
            for n, (fams, data) in rel.items():
                fd[n] = M.FamData(fams, data, "", fam_type)
                fd[n].read_pegsyn()
                fd[n].read_fams_file()
            rs = M.RenumberState(fd["old"], fd["new"])
            got.append((rs.run(), rs.new_fam_name))
    assert_same(got[:2], got[2:])
    assert len(got[0][0]) > 3


def check_kmc(rng, tmp_path):
    from close_kmers_tpu.io import kmc as JKM
    from close_kmers_tpu_torch.io import kmc as TKM
    items = sorted({("".join(rng.choice(list("ACGT"), size=9)),
                     int(rng.integers(1, 70000))) for _ in range(300)})
    for src, dst in ((JKM, TKM), (TKM, JKM)):
        for p, cs in ((2, 1), (4, 4)):
            base = str(tmp_path / f"{src.__name__}.{p}")
            src.write_kmc_db(base, items, kmer_length=9,
                             lut_prefix_length=p, counter_size=cs)
            assert dst.is_kmc_db(base) and dst.is_kmc_db(base + ".kmc_suf")
            assert_same(vars(JKM.read_kmc_info(base)),
                        vars(TKM.read_kmc_info(base)))
            assert list(dst.read_kmc_db(base)) == \
                list(src.read_kmc_db(base + ".kmc_pre"))
    assert not TKM.is_kmc_db(str(tmp_path / "none"))


def canned_server(response: bytes):
    """A one-thread TCP server on localhost answering every connection
    with ``response`` after reading the request's header and body.
    Returns (port, requests seen, stop)."""
    import socket
    import threading
    srv = socket.create_server(("127.0.0.1", 0))
    seen = []

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                data = b""
                while b"\n\n" not in data:
                    data += conn.recv(65536)
                head, body = data.split(b"\n\n", 1)
                n = int(head.split(b"Content-length: ")[1].split(b"\n")[0])
                while len(body) < n:
                    body += conn.recv(65536)
                seen.append(head + b"\n\n" + body)
                conn.sendall(response)

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    def stop():
        srv.close()
        t.join(10)
    return srv.getsockname()[1], seen, stop


def check_kclient(rng, tmp_path):
    from close_kmers_tpu.cli import kclient as JKC
    from close_kmers_tpu_torch.cli import kclient as TKC
    body = tmp_path / "q.fa"
    body.write_bytes(b"".join(b">p%d\n%s\n" % (i, p.encode())
                              for i, p in enumerate(random_prots(rng, 40))))
    port, seen, stop = canned_server(
        b"HTTP/1.1 200 OK\n\nHIT\t1\t2\t3\tfnA\nCALL\tx\n")
    try:
        got = [M.stream_request("127.0.0.1", port, "/query?details=1",
                                str(body), chunk=1000) for M in (JKC, TKC)]
    finally:
        stop()
    assert got[0] == got[1] and "fnA" in got[1]
    assert seen[0] == seen[1] and len(seen[0]) > body.stat().st_size


def check_kmerge(rng, tmp_path):
    from close_kmers_tpu.cli import kmerge as JKM
    from close_kmers_tpu_torch.cli import kmerge as TKM
    kdir = tmp_path / "KMERS"
    kdir.mkdir()
    kmers = ["".join(rng.choice(list("ACGT"), size=6)) for _ in range(30)]
    for g in range(8):
        pick = rng.choice(30, size=12, replace=False)
        (kdir / f"k{g}").write_text("".join(
            f"{kmers[i]}\t{int(rng.integers(1, 9))}\n" for i in pick))
    (tmp_path / "res.list").write_text("k0\nk1\nk2\nk3\n")
    (tmp_path / "sus.list").write_text("k4\nk5\nk6\nk7\n")
    got = []
    for M in (JKM, TKM):
        for extra in ([], ["--use-kmer-counts"], ["-a", "-r", "3"],
                      ["--no-header", "--max-files", "3"]):
            out = tmp_path / f"{M.__name__}.{len(got)}.tsv"
            assert M.main([str(tmp_path / "res.list"),
                           str(tmp_path / "sus.list"), "-d", str(kdir),
                           "-o", str(out)] + extra) == 0
            got.append(out.read_text())
    assert got[:4] == got[4:] and all(got)


def check_propagate_names_cli(rng, tmp_path):
    from close_kmers_tpu.cli import propagate_names as JPN
    from close_kmers_tpu_torch.cli import propagate_names as TPN
    from test_propagate_names import write_release
    fids = [f"fig|2.1.peg.{i}" for i in range(9)]
    pegsyn = [(f"m{i}", [f]) for i, f in enumerate(fids)]
    old = write_release(tmp_path, "old", "G", pegsyn, [
        (f"GFA{i % 3}", f, f"fn{i % 3}", str(i % 3), "G")
        for i, f in enumerate(fids[:7])])
    new = write_release(tmp_path, "new", "G", pegsyn, [
        (f"GFB{i % 3}", f, f"fn{i % 3}", str(i % 3), "G")
        for i, f in enumerate(fids) if i])
    got = []
    for M in (JPN, TPN):
        log = tmp_path / f"{M.__name__}.log"
        assert M.main(["global", *old, *new, "--log-file", str(log)]) == 0
        got.append(log.read_text())
    assert got[0] == got[1] and "NOW" in got[1]


def check_metrics(rng, tmp_path):
    a, b = JM.Metrics(), TM.Metrics()
    for name in rng.choice(["requests", "proteins", "x/y"], size=20):
        n = int(rng.integers(1, 9))
        a.inc(str(name), n)
        b.inc(str(name), n)
    assert a.counters == b.counters

    def timeless(m):     # the uptime and the rate change between calls
        return [ln for ln in m.render().splitlines()
                if not ln.startswith(("uptime_s", "proteins_per_s"))]
    assert timeless(a) == timeless(b)


CHECKS = {"params": check_params, "encoder": check_encoder,
          "translate": check_translate, "oracle": check_oracle,
          "signature_db": check_signature_db, "family_db": check_family_db,
          "fasta": check_fasta, "native": check_native,
          "family": check_family, "metrics": check_metrics,
          "dna": check_dna, "builder": check_builder,
          "recall": check_recall, "propagate_names": check_propagate_names,
          "kmc": check_kmc, "kclient": check_kclient,
          "kmerge": check_kmerge,
          "propagate_names_cli": check_propagate_names_cli}


@pytest.mark.parametrize("module", list(CHECKS))
def test_copy_matches_jax_original(module, tmp_path):
    CHECKS[module](np.random.default_rng(sorted(CHECKS).index(module)),
                   tmp_path)


def test_port_native_library_builds_under_dot_build():
    from close_kmers_tpu_torch.native import build
    path = build.build()
    assert path == build.LIB
    assert build.BUILD_DIR.endswith("close_kmers_tpu_torch/.build")
    assert not path.startswith(build._HERE)
