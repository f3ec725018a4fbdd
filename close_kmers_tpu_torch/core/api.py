"""Engine facade, torch port of ``close_kmers_tpu/core/api.py``: batch
protein annotation with oracle-exact outputs, backed by the device probe
+ native C++ scoring.  This is the layer request handlers talk to.

Ported: ``AnnotationResult``, ``KmerEngine.annotate`` and
``annotate_with_hits``.  The family methods and ``mesh=`` raise
``NotImplementedError`` until ``core/device_family`` and ``parallel/``
are ported.
"""

from __future__ import annotations

import numpy as np

from ..host import EngineParams, SignatureDB, native, oracle as O
from .engine import FastAnnotator, finish_best_call


class AnnotationResult:
    __slots__ = ("seq_id", "seq_len", "calls", "hits", "otu", "best")

    def __init__(self, seq_id, seq_len, calls, hits, otu, best=None):
        self.seq_id = seq_id
        self.seq_len = seq_len
        self.calls = calls
        self.hits = hits
        self.otu = otu
        self.best = best


class KmerEngine:
    """Batch annotation engine with reference-exact semantics."""

    def __init__(self, db: SignatureDB, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError("sharded (mesh) serving is not ported")
        self.db = db
        self.fa = FastAnnotator(db, device)
        self.function_of = db.function_of

    def annotate(self, items: list[tuple[str, str]],
                 params: EngineParams | None = None,
                 want_hits: bool = False, want_otu: bool = False,
                 want_best: bool = False,
                 want_code: bool = True) -> list[AnnotationResult]:
        """process_aa_seq for a batch: device probe, native scoring.
        ``hits`` are oracle.Hit lists (populated only if want_hits);
        ``otu`` are finalized OtuStats (only if want_otu);
        ``best`` are BestCall (only if want_best)."""
        return self.annotate_with_hits(items, params, want_hits, want_otu,
                                       want_best, want_code)[0]

    def annotate_with_hits(self, items, params=None, want_hits=False,
                           want_otu=False, want_best=False, want_code=True):
        """annotate() plus the batch's compact hit arrays as an explicit
        return.  ``want_code=False`` lets callers that never touch
        h["code"] (e.g. /query without details) skip the kmer codes."""
        params = params or EngineParams()
        seqs = [s for _, s in items]
        if not items:
            return [], dict(row_off=np.zeros(1, np.int64))
        # B rounds up to a power of two (pad with empty sequences), as
        # in the JAX engine, so both engines see the same batch shapes.
        B0 = len(seqs)
        Bp = max(16, 1 << (B0 - 1).bit_length())
        offsets, lengths = self.fa.pad_batch(seqs + [""] * (Bp - B0))
        # plane gating (see FastAnnotator.probe_compact): kmer codes feed
        # HIT lines; avg_off feeds HIT lines and the order_constraint
        # drift test; oi feeds OTU voting.
        h = self.fa.probe_compact(
            offsets, lengths,
            want_code=want_hits or want_code,
            want_oi=want_hits or want_otu,
            want_avg=want_hits or bool(params.order_constraint),
            rows_only=True)   # 2-plane hit download (planes rebuild host-side)
        if Bp != B0:
            h["row_off"] = h["row_off"][:B0 + 1]
        n_calls, cs, ce, cc, cf, cw, votes = native.score_batch(
            h["pos"], h["fi"], h["oi"], h["avg_off"], h["wt"], h["row_off"],
            params, max_calls_per_seq=max(64, offsets.shape[1] // 4),
            want_votes=want_otu)
        if want_best:
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
        results = []
        for s, (sid, seq) in enumerate(items):
            calls = [O.Call(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]),
                            int(cf[s, i]), np.float32(cw[s, i]))
                     for i in range(int(n_calls[s]))]
            hits = None
            a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
            if want_hits:
                hits = [O.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                              avg_off=int(h["avg_off"][k]),
                              fI=int(h["fi"][k]), wt=float(h["wt"][k]),
                              code=int(h["code"][k]))
                        for k in range(a, b)]
            otu = None
            if want_otu:
                otu = O.OtuStats()
                for k in range(a, b):
                    if votes[k]:
                        otu.add(int(h["oi"][k]))
                otu.finalize()
            best = None
            if want_best:
                best = finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                        self.function_of)
            results.append(AnnotationResult(sid, len(seq), calls, hits, otu,
                                            best))
        return results, h

    # -- not ported yet ------------------------------------------------------

    def annotate_family(self, *args, **kw):
        raise NotImplementedError("family-mode annotation is not ported")

    def best_family_matches(self, *args, **kw):
        raise NotImplementedError("family best-match is not ported")

    def best_family_matches_padded(self, *args, **kw):
        raise NotImplementedError("family best-match is not ported")

    def family_scores_batch(self, *args, **kw):
        raise NotImplementedError("family score accumulation is not ported")
