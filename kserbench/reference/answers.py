"""The plain reference's answers: what a served protein's record has to
say, byte for byte, worked out from the benchmark's own DB arrays and
request bodies with the frozen oracle and family scan (no code of the
program)."""

from __future__ import annotations

import numpy as np

from . import family as RF, oracle as O

POW20 = 20 ** np.arange(O.K - 1, -1, -1, dtype=np.int64)


class RefDB:
    """Lookups into the benchmark's DB arrays (``gen.scale_db.DBArrays``),
    and into its family universe (``gen.scale_mapping.Universe``)."""

    def __init__(self, db, universe=None):
        self.db = db
        self.universe = universe
        self.function_of = O.function_of_factory(db.functions)
        self.families = None if universe is None else [
            RF.FamilyData(p, l, g, f) for p, l, g, f in zip(
                universe.pgf, universe.plf, universe.genus_id,
                universe.function)]

    def lookup_fn(self, seq: bytes):
        """The oracle's lookup over every window code ``seq`` holds: one
        searchsorted into the DB's keys, then a dict."""
        off = O.seq_to_offsets(seq).astype(np.int64)
        n = len(off) - O.K + 1
        if n <= 0:
            return lambda code: None
        codes = np.lib.stride_tricks.sliding_window_view(off, O.K) @ POW20
        codes = codes[(np.lib.stride_tricks.sliding_window_view(
            off, O.K) < 20).all(axis=1)]
        keys = self.db.keys
        i = np.minimum(np.searchsorted(keys, codes), len(keys) - 1)
        hit = keys[i] == codes
        db = self.db
        table = {int(c): (int(db.fi[r]), int(db.oi[r]), int(db.avg_off[r]),
                          float(O.F32(db.wt[r])))
                 for c, r in zip(codes[hit], i[hit])}
        return table.get

    def rows_of(self, code: int) -> int:
        return int(np.searchsorted(self.db.keys, code))

    def families_of_kmer(self, code: int) -> list:
        return self.universe.families_of(self.rows_of(code))

    def scan(self, seq: bytes, params: O.EngineParams):
        """(calls, hits, otu) of the oracle's scan of ``seq``."""
        calls, hits, otu = [], [], O.OtuStats()
        O.process_aa_seq(seq, self.lookup_fn(seq), params, calls,
                         hits.append, otu)
        return calls, hits, otu


def query_record(ref: RefDB, sid: str, seq: bytes,
                 params: O.EngineParams) -> str:
    """/query's default record: PROTEIN-ID, CALL lines, OTU-COUNTS
    (query_request.cc:68-152, kguts.cc:939-973)."""
    calls, _hits, otu = ref.scan(seq, params)
    out = [f"PROTEIN-ID\t{sid}\t{len(seq)}\n"]
    out += [O.format_call(c, ref.function_of) for c in calls]
    out.append(O.format_otu_stats(sid, len(seq), otu))
    return "".join(out)


def best_match_record(ref: RefDB, sid: str, seq: bytes,
                      params: O.EngineParams, kmer_hit_threshold: int = 3,
                      target_genus_id: int = 0) -> str:
    """/lookup?find_best_match=1's record in family mode: the best call,
    the family scores of every hit and the best-match scan with the
    genus filter on (lookup_request.cc:203-326)."""
    calls, hits, _otu = ref.scan(seq, params)
    best = O.find_best_call(calls, ref.function_of)
    scores = RF.accumulate_family_scores(hits, ref.families_of_kmer)
    m = RF.find_best_family_match(best, scores, ref.families,
                                  kmer_hit_threshold, False,
                                  target_genus_id, True)
    return RF.format_best_match_lookup(sid, m)
