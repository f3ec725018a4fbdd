# Copied from close_kmers_tpu/core/family.py.
"""Family scoring: per-sequence family score accumulation, best global/local
family selection, and the all-matches report.

Parity targets in the reference close_kmers sources:

* on_hit family accumulation — lookup_request.cc:446-469 ==
  family_mapper.cc:287-316: per hit, weight = 1/N over the kmer's N
  distinct families; SeqScore counters accumulate in hit order, float32.
* best-match selection — lookup_request.cc:203-326 (genus filter applied
  to best-local-family) and family_mapper.cc:65-205 (genus filter
  disabled, family_mapper.cc:175-176) — toggled via ``genus_filter``.
* all-matches report — lookup_request.cc:328-399 / family_mapper.cc:207-285.

Determinism note: the reference iterates std::unordered_map when scanning
seq_score_ and pgf rollups, so float accumulation order and strict-``>``
tie resolution depend on libstdc++ bucket order.  This implementation
uses first-insertion order (Python dict order) throughout, which is
deterministic and matches the reference whenever scores are untied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import EngineParams
from ..db.family_db import KmerFamilyMapping
from . import oracle as O


@dataclasses.dataclass
class SeqScore:
    """sequence_accumulated_score_t (lookup_request.h:26-42)."""
    hit_count: int = 0
    hit_total: int = 0
    weighted_total: np.float32 = np.float32(0.0)


def accumulate_family_scores(hits, mapping: KmerFamilyMapping) -> dict[int, SeqScore]:
    """Family-mode on_hit accumulation over a hit list in position order
    (lookup_request.cc:446-469).  Returns {family_id: SeqScore} in
    first-hit order."""
    seq_score: dict[int, SeqScore] = {}
    for h in hits:
        fams = mapping.families_of_kmer(h.code)
        if not fams:
            continue
        weight = np.float32(1.0) / np.float32(len(fams))
        for fid in fams:
            s = seq_score.get(fid)
            if s is None:
                s = seq_score[fid] = SeqScore()
            s.hit_count += 1
            s.hit_total += 1
            s.weighted_total = np.float32(s.weighted_total + weight)
    return seq_score


def accumulate_peg_scores(hits, mapping: KmerFamilyMapping) -> dict[int, SeqScore]:
    """Non-family mode: per-peg raw hit counts (lookup_request.cc:470-481);
    a peg occurs once per (kmer hit, occurrence in peg) pair since
    add_mapping does not dedup."""
    seq_score: dict[int, SeqScore] = {}
    for h in hits:
        for pid in mapping.pegs_of_kmer(h.code):
            s = seq_score.get(pid)
            if s is None:
                s = seq_score[pid] = SeqScore()
            s.hit_count += 1
            s.hit_total += 1
    return seq_score


@dataclasses.dataclass
class BestMatch:
    """best_match_t (family_mapper.h:20-28) + the weighted score that the
    /lookup TSV additionally reports (lookup_request.cc:326)."""
    gfam_id: str = ""
    gfam_score: float = 0.0
    lfam_id: str = ""
    lfam_score: float = 0.0
    function: str = ""
    score: float = 0.0
    weighted_score: float = 0.0


@dataclasses.dataclass
class BestMatchColumns:
    """Array-form batch best-match result (find_best_family_matches_batch
    as_arrays=True): numeric columns for vectorized consumers (the
    /fq_lookup frame reduction reads only score/gfam_score), with
    per-row BestMatch materialization on demand — building 100k+
    BestMatch objects and their string columns was ~0.4 s/pass of the
    FASTQ path (cProfile), all of it skippable until a row is printed.
    """
    gfam_score: np.ndarray     # f32 [S]; 0 = no global family
    lfam_score: np.ndarray     # f32 [S]
    score: np.ndarray          # f32 [S]
    weighted_score: np.ndarray  # f32 [S]
    _gpgf_idx: np.ndarray      # i64 [S] into _pgf_names (where valid)
    _gvalid: np.ndarray
    _lfam_idx: np.ndarray      # i64 [S] into _plf_names (where valid)
    _lvalid: np.ndarray
    _fn_col: list              # str [S]
    _pgf_names: list
    _plf_names: list
    _patched: dict | None = None   # scalar-path rows (row -> BestMatch)

    def __len__(self):
        return len(self.score)

    def materialize(self, i: int) -> BestMatch:
        if self._patched and i in self._patched:
            return self._patched[i]
        return BestMatch(
            self._pgf_names[int(self._gpgf_idx[i])]
            if self._gvalid[i] else "",
            float(self.gfam_score[i]),
            self._plf_names[int(self._lfam_idx[i])]
            if self._lvalid[i] else "",
            float(self.lfam_score[i]),
            self._fn_col[i], float(self.score[i]),
            float(self.weighted_score[i]))

    def __iter__(self):
        return (self.materialize(i) for i in range(len(self)))

    @classmethod
    def concat(cls, parts: list) -> "BestMatchColumns":
        """Concatenate per-chunk column results (row order preserved)."""
        if len(parts) == 1:
            return parts[0]
        patched = {}
        off = 0
        fn_col = []
        for p in parts:
            if p._patched:
                patched.update({off + k: v for k, v in p._patched.items()})
            fn_col.extend(p._fn_col)
            off += len(p)
        cat = lambda name: np.concatenate([getattr(p, name) for p in parts])
        return cls(cat("gfam_score"), cat("lfam_score"), cat("score"),
                   cat("weighted_score"), cat("_gpgf_idx"), cat("_gvalid"),
                   cat("_lfam_idx"), cat("_lvalid"), fn_col,
                   parts[0]._pgf_names, parts[0]._plf_names,
                   _patched=patched or None)

    @classmethod
    def from_objects(cls, ms: list) -> "BestMatchColumns":
        """Wrap an existing BestMatch list (fallback paths) so callers
        asking for arrays always get the same interface."""
        S = len(ms)
        cols = cls(
            np.array([m.gfam_score for m in ms], np.float32),
            np.array([m.lfam_score for m in ms], np.float32),
            np.array([m.score for m in ms], np.float32),
            np.array([m.weighted_score for m in ms], np.float32),
            np.zeros(S, np.int64), np.zeros(S, bool),
            np.zeros(S, np.int64), np.zeros(S, bool),
            [""] * S, [], [], _patched=dict(enumerate(ms)))
        return cols


def resolve_best_call_function(best: O.BestCall, allow_ambiguous: bool):
    """Ambiguity handling shared by /lookup and FamilyMapper
    (lookup_request.cc:226-247): empty -> "hypothetical protein";
    "F1 ?? F2" either splits (allow_ambiguous) or degrades to
    "hypothetical protein".  Returns (function, ambig_function, do_ambig)."""
    fn = best.function
    if not fn:
        return "hypothetical protein", "", False
    where = fn.find(" ?? ")
    if where < 0:
        return fn, "", False
    if allow_ambiguous:
        return fn[:where], fn[where + 4:], True
    return "hypothetical protein", "", False


def find_best_family_match(
    best: O.BestCall,
    seq_score: dict[int, SeqScore],
    mapping: KmerFamilyMapping,
    kmer_hit_threshold: int = 3,
    allow_ambiguous: bool = False,
    target_genus_id: int = 0,
    genus_filter: bool = True,
) -> BestMatch:
    """The best-match scan (lookup_request.cc:249-326).

    ``genus_filter=False`` reproduces FamilyMapper's variant where the
    genus restriction on the best local family is commented out
    (family_mapper.cc:175-176).
    """
    best_fn, ambig_fn, do_ambig = resolve_best_call_function(best, allow_ambiguous)

    lf_score, lf_fam, lf_fn = np.float32(0.0), "", ""
    pgf_rollup: dict[str, np.float32] = {}
    pgf_rollup_ambig: dict[str, np.float32] = {}

    for fid, s in seq_score.items():
        if s.hit_total < kmer_hit_threshold:
            continue
        if fid < 0 or fid >= len(mapping.families):
            continue
        fd = mapping.families[fid]
        if do_ambig:
            if fd.function == best_fn:
                pgf_rollup[fd.pgf] = np.float32(
                    pgf_rollup.get(fd.pgf, np.float32(0.0)) + s.weighted_total)
            elif fd.function == ambig_fn:
                pgf_rollup_ambig[fd.pgf] = np.float32(
                    pgf_rollup_ambig.get(fd.pgf, np.float32(0.0)) + s.weighted_total)
            else:
                continue
        else:
            if fd.function == best_fn:
                pgf_rollup[fd.pgf] = np.float32(
                    pgf_rollup.get(fd.pgf, np.float32(0.0)) + s.weighted_total)
            else:
                continue
        if s.weighted_total > lf_score and (not genus_filter
                                            or fd.genus_id == target_genus_id):
            lf_score = s.weighted_total
            lf_fam = fd.plf
            lf_fn = fd.function

    rollup = pgf_rollup
    if do_ambig and lf_fn == ambig_fn:
        rollup = pgf_rollup_ambig
    gf_score, gf_fam = np.float32(0.0), ""
    for pgf, score in rollup.items():
        if score > gf_score:
            gf_score = score
            gf_fam = pgf

    return BestMatch(
        gfam_id=gf_fam, gfam_score=float(gf_score),
        lfam_id=lf_fam, lfam_score=float(lf_score),
        function=(lf_fn if do_ambig else best_fn),
        score=best.score, weighted_score=best.weighted_score)


@dataclasses.dataclass
class BestCallReduction:
    """Array form of the native top-3 best-call reduction plus the DB
    function list — lets find_best_family_matches_batch resolve best-call
    functions WITHOUT materializing S BestCall objects or doing S string
    intern lookups (finish_best_call + func_intern.get per row were a
    measurable share of the /lookup?find_best_match serving path)."""
    nf: np.ndarray       # i32[S] distinct functions per seq
    ofi: np.ndarray      # i32[S, 3] top function indexes
    ocnt: np.ndarray     # i32[S, 3] counts
    owt: np.ndarray      # f32[S, 3] weighted
    functions: list      # DB function strings (index -> name)

    def best_call(self, s: int) -> O.BestCall:
        from .engine import finish_best_call
        return finish_best_call(
            int(self.nf[s]), self.ofi[s], self.ocnt[s], self.owt[s],
            lambda i: (self.functions[i]
                       if 0 <= i < len(self.functions)
                       else "INVALID_OFFSET"))


def _db_fi_intern(mapping: KmerFamilyMapping, functions: list) -> np.ndarray:
    """DB function index -> mapping func_intern id (-1 when no family
    uses that function).  Cached on the mapping per (families generation,
    functions identity)."""
    func_intern = mapping.family_meta_arrays()[5]
    key = (mapping._families_gen, len(mapping.families))
    cached = getattr(mapping, "_fi_intern", None)
    # identity check via a pinned reference ('is', not id()): CPython can
    # reuse an id() after the original list is collected, which would
    # silently serve a stale table to a different engine's functions list
    if cached is not None and cached[0] == key and cached[1] is functions:
        return cached[2]
    arr = np.fromiter((func_intern.get(fn, -1) for fn in functions),
                      dtype=np.int64, count=len(functions))
    mapping._fi_intern = (key, functions, arr)
    return arr


def find_best_family_matches_batch(
    bests,
    n_per: np.ndarray, fam: np.ndarray, cnt: np.ndarray, wt: np.ndarray,
    first: np.ndarray,
    mapping: KmerFamilyMapping,
    kmer_hit_threshold: int = 3,
    allow_ambiguous: bool = False,
    target_genus_id: int = 0,
    genus_filter: bool = True,
    as_arrays: bool = False,
) -> list[BestMatch]:
    """Vectorized find_best_family_match over a whole batch, consuming
    the device rollup arrays directly (no per-sequence dicts).

    Exactness: entries are visited in first-hit order (lexsort by (row,
    first)); PGF sums accumulate with np.add.at, which applies updates
    in array order — the same float32 left-fold as the dict loop; the
    strict-``>`` first-wins scans become min-position-of-max.  Rows whose
    best call resolves ambiguously (" ?? " with allow_ambiguous) take the
    scalar path — the dual-rollup selection is stateful and rare.

    Precondition: family ids are unique within a row (the device rollup
    groups by family, so this always holds for its output; the scalar
    dict path would collapse duplicates by overwrite).
    """
    func_id, pgf_id, gen_id, pgf_names, plf_names, func_intern = \
        mapping.family_meta_arrays()
    F = len(mapping.families)
    n_per = np.asarray(n_per, dtype=np.int64)

    if isinstance(bests, BestCallReduction):
        # Vectorized finish_best_call + function resolution: the
        # called/ambiguous classification and intern lookup are pure
        # array ops; only ambiguous rows (rare) go scalar.
        S = len(bests.nf)
        n = np.asarray(bests.nf, dtype=np.int64)
        cnt0 = bests.ocnt[:, 0].astype(np.float32)
        offset = np.where(n <= 1, cnt0,
                          cnt0 - bests.ocnt[:, 1].astype(np.float32))
        called = (n >= 1) & (offset >= np.float32(5.0))
        pair_off = (bests.ocnt[:, 1] - bests.ocnt[:, 2]).astype(np.float32)
        is_amb = (~called) & ((n == 2)
                              | ((n >= 3) & (pair_off > np.float32(5.0))))
        fi0 = bests.ofi[:, 0].astype(np.int64)
        hyp_idx = func_intern.get("hypothetical protein", -1)
        fi_intern = _db_fi_intern(mapping, bests.functions)
        in_range = (fi0 >= 0) & (fi0 < len(fi_intern))
        safe0 = np.where(called & in_range, fi0, 0)
        # called rows with an out-of-range fi0 (corrupt DB fi plane) must
        # match NO family (-1), like the legacy scalar path — not family
        # index 0's function via the safe0 clamp
        bestfn_idx = np.where(called,
                              np.where(in_range, fi_intern[safe0], -1),
                              hyp_idx)
        # BestMatch output fields (finish_best_call semantics): score is
        # set for called and ambiguous rows, weighted only for called /
        # 3-way-ambiguous rows
        scoreA = np.where(called | is_amb, cnt0, np.float32(0.0))
        weightedA = np.where(called | (is_amb & (n >= 3)),
                             bests.owt[:, 0], np.float32(0.0)
                             ).astype(np.float32)
        if allow_ambiguous:
            scalar_rows = np.nonzero(is_amb)[0].tolist()
            bestfn_idx[is_amb] = -2   # matches nothing; rows redone below
        else:
            scalar_rows = []          # ambiguous degrades to hypothetical

        # output function column: called rows name their function, all
        # other rows resolve to "hypothetical protein" (ambiguous rows
        # under allow_ambiguous are overwritten by the scalar path)
        nfn = len(bests.functions)
        fn_col = [bests.functions[f] if (c and 0 <= f < nfn)
                  else ("INVALID_OFFSET" if c else "hypothetical protein")
                  for f, c in zip(fi0.tolist(), called.tolist())]

        scalar_best = bests.best_call
    else:
        S = len(bests)
        bestfn = [""] * S
        bestfn_idx = np.full(S, -1, dtype=np.int64)
        scoreA = np.fromiter((b.score for b in bests), dtype=np.float32,
                             count=S)
        weightedA = np.fromiter((b.weighted_score for b in bests),
                                dtype=np.float32, count=S)
        scalar_rows = []
        for s, b in enumerate(bests):
            fn, _ambig, do_ambig = resolve_best_call_function(
                b, allow_ambiguous)
            bestfn[s] = fn
            if do_ambig:
                scalar_rows.append(s)
            else:
                bestfn_idx[s] = func_intern.get(fn, -1)

        fn_col = bestfn

        def scalar_best(s: int) -> O.BestCall:
            return bests[s]

    N = int(n_per.sum())
    row = np.repeat(np.arange(S, dtype=np.int64), n_per)
    order = np.lexsort((np.asarray(first)[:N], row))
    fam_o = np.asarray(fam)[:N][order].astype(np.int64)
    cnt_o = np.asarray(cnt)[:N][order]
    wt_o = np.asarray(wt)[:N][order].astype(np.float32)

    ok = (fam_o >= 0) & (fam_o < F)
    fid = np.where(ok, fam_o, 0)
    match = (ok & (cnt_o >= kmer_hit_threshold)
             & (func_id[fid] == bestfn_idx[row]) & (bestfn_idx[row] >= 0))

    # local family: first strictly-greatest weighted_total among matched
    # entries (optionally genus-restricted); initial lf_score = 0.0
    lmask = match & (gen_id[fid] == target_genus_id) if genus_filter \
        else match
    neg = np.float32(-np.inf)
    wl = np.where(lmask, wt_o, neg)
    lmax = np.full(S, neg, dtype=np.float32)
    np.maximum.at(lmax, row, wl)
    pos = np.arange(N, dtype=np.int64)
    cand = np.where(lmask & (wl == lmax[row]), pos, N)
    lfirst = np.full(S, N, dtype=np.int64)
    np.minimum.at(lfirst, row, cand)

    # PGF rollup over matched entries, f32 sums in visit order
    P = max(len(pgf_names), 1)
    m_row = row[match]
    m_pos = pos[match]
    gkey = m_row * P + pgf_id[fid[match]]
    uniq, inv = np.unique(gkey, return_inverse=True)
    gsum = np.zeros(len(uniq), dtype=np.float32)
    np.add.at(gsum, inv, wt_o[match])
    gfirstpos = np.full(len(uniq), N, dtype=np.int64)
    np.minimum.at(gfirstpos, inv, m_pos)
    grow = uniq // P
    gpgf = uniq % P
    g_order = np.lexsort((gfirstpos, grow))
    gs, gr, gp = gsum[g_order], grow[g_order], gpgf[g_order]
    G = len(gs)
    gmax = np.zeros(S, dtype=np.float32)
    np.maximum.at(gmax, gr, gs)
    gcand = np.where(gs == gmax[gr], np.arange(G, dtype=np.int64), G)
    gfirst = np.full(S, G, dtype=np.int64)
    np.minimum.at(gfirst, gr, gcand)

    # Column-wise BestMatch construction: the per-row Python loop was
    # ~99% of this function's time at serving batch sizes (cProfile:
    # 0.39 s of 0.40 for 32k rows); string columns come from gated list
    # comps and the object build is one C-level map over columns.
    lvalid = (lfirst < N) & (lmax > np.float32(0.0))
    lk = np.where(lvalid, lfirst, 0)
    lfam_idx = fam_o[lk] if N else np.zeros(S, np.int64)
    lscore_col = np.where(lvalid, wt_o[lk] if N else 0.0, np.float32(0.0))
    gvalid = (gfirst < G) & (gmax > np.float32(0.0))
    gk = np.where(gvalid, gfirst, 0)
    gpgf_idx = gp[gk] if G else np.zeros(S, np.int64)
    gscore_col = np.where(gvalid, gmax, np.float32(0.0))
    if as_arrays:
        cols = BestMatchColumns(
            gscore_col.astype(np.float32), lscore_col.astype(np.float32),
            scoreA.astype(np.float32), weightedA.astype(np.float32),
            gpgf_idx, gvalid, lfam_idx, lvalid, fn_col,
            pgf_names, plf_names)
        if scalar_rows:
            patched = _patch_scalar_rows(
                {}, scalar_rows, n_per, fam, cnt, wt, first, S, N,
                scalar_best, mapping, kmer_hit_threshold,
                allow_ambiguous, target_genus_id, genus_filter)
            cols._patched = patched
        return cols
    plf_col = [plf_names[i] if v else ""
               for i, v in zip(lfam_idx.tolist(), lvalid.tolist())]
    pgf_col = [pgf_names[i] if v else ""
               for i, v in zip(gpgf_idx.tolist(), gvalid.tolist())]
    out: list[BestMatch] = list(map(
        BestMatch, pgf_col, gscore_col.astype(np.float64).tolist(),
        plf_col, lscore_col.astype(np.float64).tolist(),
        fn_col, scoreA.astype(np.float64).tolist(),
        weightedA.astype(np.float64).tolist()))

    if scalar_rows:
        patched = _patch_scalar_rows(
            {}, scalar_rows, n_per, fam, cnt, wt, first, S, N,
            scalar_best, mapping, kmer_hit_threshold, allow_ambiguous,
            target_genus_id, genus_filter)
        for s_i, m_i in patched.items():
            out[s_i] = m_i
    return out


def _patch_scalar_rows(patched, scalar_rows, n_per, fam, cnt, wt, first,
                       S, N, scalar_best, mapping, kmer_hit_threshold,
                       allow_ambiguous, target_genus_id, genus_filter):
    """Exact scalar re-resolution for ambiguous rows (rare): rebuild the
    per-row seq_score dict in first-hit order and run the stateful
    find_best_family_match."""
    row_off = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(n_per, out=row_off[1:])
    fam_n = np.asarray(fam)[:N]
    cnt_n = np.asarray(cnt)[:N]
    wt_n = np.asarray(wt)[:N]
    first_n = np.asarray(first)[:N]
    for s in scalar_rows:
        a, bnd = int(row_off[s]), int(row_off[s + 1])
        sub = np.argsort(first_n[a:bnd], kind="stable")
        seq_score = {
            int(fam_n[a + i]): SeqScore(int(cnt_n[a + i]),
                                        int(cnt_n[a + i]),
                                        np.float32(wt_n[a + i]))
            for i in sub}
        patched[s] = find_best_family_match(
            scalar_best(s), seq_score, mapping, kmer_hit_threshold,
            allow_ambiguous, target_genus_id, genus_filter)
    return patched


def format_best_match_lookup(seq_id: str, m: BestMatch) -> str:
    """/lookup best-match TSV row (lookup_request.cc:326)."""
    return (f"{seq_id}\t{m.gfam_id}\t{O.fmt_float(m.gfam_score)}\t{m.lfam_id}\t"
            f"{O.fmt_float(m.lfam_score)}\t{m.function}\t{O.fmt_float(m.score)}\t"
            f"{O.fmt_float(m.weighted_score)}\n")


def format_best_match_fq(m: BestMatch) -> str:
    """best_match_t stream operator (family_mapper.h:70-75)."""
    return (f"{m.gfam_id}\t{O.fmt_float(m.gfam_score)}\t{m.lfam_id}\t"
            f"{O.fmt_float(m.lfam_score)}\t{m.function}\t{O.fmt_float(m.score)}")


def all_matches_rows(
    seq_score: dict[int, SeqScore],
    mapping: KmerFamilyMapping,
    kmer_hit_threshold: int = 3,
    family_mode: bool = True,
    family_reps=None,
) -> str:
    """The non-best-match report body (lookup_request.cc:328-399):
    entries sorted by weighted score descending; iteration BREAKS at the
    first entry under the hit threshold (lookup_request.cc:348-349)."""
    vec = sorted(seq_score.items(),
                 key=lambda kv: -float(kv[1].weighted_total))
    out = []
    for eid, s in vec:
        if s.hit_total < kmer_hit_threshold:
            break
        if family_mode:
            fd = mapping.families[eid]
            scaled = np.float32(np.float32(s.hit_count) / np.float32(fd.total_size))
            out.append(f"{s.hit_count}\t{s.hit_total}\t{O.fmt_float(s.weighted_total)}\t"
                       f"{fd.pgf}\t{fd.plf}\t{fd.total_size}\t{fd.count}\t"
                       f"{O.fmt_float(scaled)}\t{fd.function}\n")
            if family_reps is not None:
                reps = family_reps.reps.get(fd.plf)
                if reps:
                    for r in reps:
                        out.append(f"{r.feature_id}\t{r.contig}\t{r.contig_length}\t"
                                   f"{r.start}\t{r.end}\t{r.strand}\n")
                out.append("///\n")
        else:
            peg = mapping.decode_peg(eid)
            fam_id = mapping.peg_to_family.get(eid)
            if fam_id is not None:
                fd = mapping.families[fam_id]
                out.append(f"{peg}\t{s.hit_count}\t{fd.pgf}\t{fd.plf}\t{fd.function}\n")
            else:
                out.append(f"{peg}\t{s.hit_count}\n")
    out.append("//\n")
    return "".join(out)


def annotate_best_match(
    engine,
    items: list[tuple[str, str]],
    mapping: KmerFamilyMapping,
    function_of,
    params: EngineParams | None = None,
    kmer_hit_threshold: int = 3,
    allow_ambiguous: bool = False,
    target_genus_id: int = 0,
    genus_filter: bool = True,
) -> list[tuple[str, BestMatch]]:
    """End-to-end /lookup?find_best_match=1 over a batch: probe on device,
    replay calls, accumulate family scores, pick best families."""
    params = params or EngineParams()
    from .engine import replay_hits
    hit_lists = engine.hits_of_batch([s for _, s in items])
    results = []
    for (sid, _seq), hits in zip(items, hit_lists):
        calls: list[O.Call] = []
        replay_hits(hits, params, calls, None)
        best = O.find_best_call(calls, function_of)
        seq_score = accumulate_family_scores(hits, mapping)
        m = find_best_family_match(best, seq_score, mapping,
                                   kmer_hit_threshold, allow_ambiguous,
                                   target_genus_id, genus_filter)
        results.append((sid, m))
    return results
