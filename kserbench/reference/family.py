# Frozen copy of close_kmers_tpu_torch/core/family.py at commit 8a7e9d7b116deea5496cfc89e97fd59b7681397e (SeqScore, accumulate_family_scores, BestMatch, resolve_best_call_function, find_best_family_match, format_best_match_lookup).
"""The plain reference's family placement: per-protein family scores and
the scalar best-match scan (lookup_request.cc:203-326, 446-469), over
the benchmark's own kmer->family CSR and family fields.

The reference iterates std::unordered_map when scanning its scores, so
its float sums and strict-``>`` ties follow libstdc++ bucket order; this
copy, as the port's, uses first-insertion order throughout, which equals
the reference's whenever scores are untied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import oracle as O


@dataclasses.dataclass
class SeqScore:
    """sequence_accumulated_score_t (lookup_request.h:26-42)."""
    hit_count: int = 0
    hit_total: int = 0
    weighted_total: np.float32 = np.float32(0.0)


@dataclasses.dataclass
class FamilyData:
    """The fields of family_data_t (kmer.h:58-68) the scan reads."""
    pgf: str
    plf: str
    genus_id: int
    function: str


def accumulate_family_scores(hits, families_of_kmer) -> dict[int, SeqScore]:
    """Family-mode on_hit accumulation over a hit list in position order
    (lookup_request.cc:446-469): per hit, weight 1/N over the kmer's N
    families.  Returns {family_id: SeqScore} in first-hit order."""
    seq_score: dict[int, SeqScore] = {}
    for h in hits:
        fams = families_of_kmer(h.code)
        if not fams:
            continue
        weight = O.F32(np.float32(1.0) / np.float32(len(fams)))
        for fid in fams:
            s = seq_score.get(fid)
            if s is None:
                s = seq_score[fid] = SeqScore()
            s.hit_count += 1
            s.hit_total += 1
            s.weighted_total = O.F32(s.weighted_total + weight)
    return seq_score


@dataclasses.dataclass
class BestMatch:
    """best_match_t (family_mapper.h:20-28) + the weighted score that the
    /lookup TSV reports (lookup_request.cc:326)."""
    gfam_id: str = ""
    gfam_score: float = 0.0
    lfam_id: str = ""
    lfam_score: float = 0.0
    function: str = ""
    score: float = 0.0
    weighted_score: float = 0.0


def resolve_best_call_function(best: O.BestCall, allow_ambiguous: bool):
    """lookup_request.cc:226-247: empty -> "hypothetical protein";
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
    families: list,
    kmer_hit_threshold: int = 3,
    allow_ambiguous: bool = False,
    target_genus_id: int = 0,
    genus_filter: bool = True,
) -> BestMatch:
    """The best-match scan (lookup_request.cc:249-326) over ``families``
    (:class:`FamilyData` by family id)."""
    best_fn, ambig_fn, do_ambig = resolve_best_call_function(best, allow_ambiguous)

    lf_score, lf_fam, lf_fn = np.float32(0.0), "", ""
    pgf_rollup: dict[str, np.float32] = {}
    pgf_rollup_ambig: dict[str, np.float32] = {}

    for fid, s in seq_score.items():
        if s.hit_total < kmer_hit_threshold:
            continue
        if fid < 0 or fid >= len(families):
            continue
        fd = families[fid]
        if do_ambig:
            if fd.function == best_fn:
                pgf_rollup[fd.pgf] = O.F32(
                    pgf_rollup.get(fd.pgf, np.float32(0.0)) + s.weighted_total)
            elif fd.function == ambig_fn:
                pgf_rollup_ambig[fd.pgf] = O.F32(
                    pgf_rollup_ambig.get(fd.pgf, np.float32(0.0)) + s.weighted_total)
            else:
                continue
        else:
            if fd.function == best_fn:
                pgf_rollup[fd.pgf] = O.F32(
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


def format_best_match_lookup(seq_id: str, m: BestMatch) -> str:
    """/lookup best-match TSV row (lookup_request.cc:326)."""
    return (f"{seq_id}\t{m.gfam_id}\t{O.fmt_float(m.gfam_score)}\t{m.lfam_id}\t"
            f"{O.fmt_float(m.lfam_score)}\t{m.function}\t{O.fmt_float(m.score)}\t"
            f"{O.fmt_float(m.weighted_score)}\n")
