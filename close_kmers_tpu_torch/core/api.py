"""Engine facade, torch port of ``close_kmers_tpu/core/api.py``: batch
protein annotation with oracle-exact outputs, backed by the device probe
+ native C++ scoring.  This is the layer request handlers talk to.

Ported: ``AnnotationResult``, ``KmerEngine.annotate`` and
``annotate_with_hits`` (the /query path), and the family path:
``annotate_family``, ``best_family_matches``,
``best_family_matches_padded`` and ``family_scores_batch`` (whose hit
arrays are now a required argument: the port keeps no ``_last_hits``, so
it has no ``hits_compact`` either), ``best_call``, and the sharded engine
(``mesh=``, ``routed=``).

Three deliberate differences from the reference: the engine caches its
family scorer per mapping in a weak-keyed table of its own, never as
``mapping._device_scorer`` (which the JAX engine writes), so engines of
both packages may share a mapping; it keeps its /matrix DeviceMatrix the
same way (``_device_matrix``), never as ``eng._device_matrix``; and
``best_family_matches_padded``
keeps at most ``FAMILY_MATCH_GROUP`` chunks in flight, where the
reference dispatches every chunk of a request up front (ADVICE.md,
medium: unbounded dispatch-ahead).

With ``mesh=`` the engine probes a range-sharded DB
(``parallel.sharding.ShardedEngine``, replicated or ``routed``); the
family program and the /matrix device program then take their host
paths, as in the reference, since both read a single-device table.
"""

from __future__ import annotations

import collections
import os
import weakref

import numpy as np
import torch

from ..db.signature_db import SignatureDB
from ..native import api as native
from ..params import EngineParams
from . import family as F, oracle as O
from .device_family import DeviceFamilyScorer
from .device_score import DeviceScorer
from .engine import FastAnnotator, finish_best_call
from .matrix import DeviceMatrix


class AnnotationResult:
    __slots__ = ("seq_id", "seq_len", "calls", "hits", "otu", "best")

    def __init__(self, seq_id, seq_len, calls, hits, otu, best=None):
        self.seq_id = seq_id
        self.seq_len = seq_len
        self.calls = calls
        self.hits = hits
        self.otu = otu
        self.best = best


class _Readback:
    """A device buffer's copy to the host, started when made (into pinned
    memory, asynchronously, on a card) and waited for by :meth:`result`."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            t = host
        self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class KmerEngine:
    """Batch annotation engine with reference-exact semantics."""

    def __init__(self, db: SignatureDB, device, mesh=None,
                 device_family: bool = True,
                 device_family_min: int | None = None,
                 routed: bool = False):
        """``device``: the one device of the engine; None with ``mesh``
        (a ``parallel.sharding.Mesh``), whose entries name the devices of
        a range-sharded DB.  ``routed``: with a mesh, probe through the
        all_to_all exchange instead of the replicated psum merge.
        ``device_family``: allow the fused device calls + family
        rollup path for family-mode lookups; ``device_family_min``:
        minimum mapping size (distinct kmers) to justify the family table
        upload (default env CLOSE_KMERS_DEVICE_FAMILY_MIN or 50000)."""
        self.db = db
        if mesh is not None:
            if device is not None:
                raise ValueError("give a device or a mesh, not both")
            from ..parallel.sharding import ShardedEngine
            self.fa = ShardedEngine(db, mesh, routed=routed)
        else:
            self.fa = FastAnnotator(db, device)
        self.function_of = db.function_of
        self.device_family = device_family
        self.device_family_min = device_family_min \
            if device_family_min is not None else int(os.environ.get(
                "CLOSE_KMERS_DEVICE_FAMILY_MIN", 50_000))
        # mapping -> (the fam CSR it was built from, scorer or None)
        self._family_scorers = weakref.WeakKeyDictionary()
        # mapping -> its /matrix DeviceMatrix (core/matrix.py)
        self._device_matrices = weakref.WeakKeyDictionary()

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

    # -- family-mode lookup (calls + family scores in one device pass) ------

    DEVICE_FAMILY_MAX_D = 32   # dense fam-table fan-out bound (memory)

    def _device_family_scorer(self, mapping):
        """DeviceFamilyScorer for ``mapping``, cached per engine and
        rebuilt when the mapping's CSR is (every add_fam_mapping clears
        it).  None when the device path does not apply: a sharded
        engine, disabled, mapping too small to justify the family table
        upload, or per-kmer family fan-out too large to densify."""
        if not self.device_family or getattr(self.fa, "ddb", None) is None:
            return None
        csr = mapping.fam_csr()
        if len(csr[0]) < self.device_family_min:
            return None
        cached = self._family_scorers.get(mapping)
        if cached is not None and cached[0] is csr:
            return cached[1]
        # famwide=None: the JAX auto gate for the folded single-read rows
        dfs = DeviceFamilyScorer(self.db, mapping, self.fa.device,
                                 ddb=self.fa.ddb, famwide=None)
        if dfs.fdb.d > self.DEVICE_FAMILY_MAX_D:
            dfs = None
        self._family_scorers[mapping] = (csr, dfs)
        return dfs

    def annotate_family(self, items, mapping,
                        params: EngineParams | None = None,
                        want_best: bool = False):
        """Family-mode batch: (results, seq_scores) where seq_scores[s]
        is {family_id: SeqScore} in FIRST-HIT order, equal to
        family.accumulate_family_scores over the host hit path.

        Runs the fused device calls + rollup program when the mapping
        qualifies, otherwise the compact-hit host path through
        native.family_scores."""
        params = params or EngineParams()
        dfs = self._device_family_scorer(mapping) if items else None
        if dfs is None:
            results, h = self.annotate_with_hits(items, params,
                                                 want_best=want_best)
            out_n, fam, hits_c, weight = self.family_scores_batch(mapping, h)
            seq_scores = []
            w = 0
            for s in range(len(items)):
                n = int(out_n[s])
                seq_scores.append({
                    int(fam[w + i]): F.SeqScore(int(hits_c[w + i]),
                                                int(hits_c[w + i]),
                                                np.float32(weight[w + i]))
                    for i in range(n)})
                w += n
            return results, seq_scores

        offsets, lengths = self.fa.pad_batch([s for _, s in items])
        B = offsets.shape[0]
        ccap = 4
        fcap = None
        while True:
            calls_dev, call_cap, rows_dev, capf, check = \
                dfs.score_family_packed(offsets, lengths, params, ccap, fcap)
            calls_np, rows_np = calls_dev.cpu().numpy(), rows_dev.cpu().numpy()
            check.raise_if_bad()
            dense = DeviceScorer.unpack_dense(calls_np, B, call_cap)
            roll = DeviceFamilyScorer.finish_rollup_rows(rows_np, capf)
            if dense is None:
                ccap *= 4
                continue
            if roll is None:
                fcap = capf * 4
                dfs._default_cap = max(dfs._default_cap, fcap)
                continue
            break
        n_calls, cs, ce, cc, cf, cw = dense
        if want_best:
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
        results = []
        for s, (sid, seq) in enumerate(items):
            calls = [O.Call(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]),
                            int(cf[s, i]), np.float32(cw[s, i]))
                     for i in range(int(n_calls[s]))]
            best = finish_best_call(int(nf[s]), ofi[s], ocnt[s], owt[s],
                                    self.function_of) if want_best else None
            results.append(AnnotationResult(sid, len(seq), calls, None,
                                            None, best))
        n_per, fam, counts, weights, first = roll
        seq_scores = []
        k = 0
        for s in range(B):
            n = int(n_per[s])
            order = np.argsort(first[k:k + n], kind="stable")
            seq_scores.append({
                int(fam[k + i]): F.SeqScore(int(counts[k + i]),
                                            int(counts[k + i]),
                                            np.float32(weights[k + i]))
                for i in order})
            k += n
        return results, seq_scores

    def best_family_matches(self, items, mapping,
                            params: EngineParams | None = None,
                            kmer_hit_threshold: int = 3,
                            allow_ambiguous: bool = False,
                            target_genus_id: int = 0,
                            genus_filter: bool = True):
        """Batch FamilyMapper::find_best_family_match
        (family_mapper.cc:65-205): one fused device pass (calls + family
        rollup) then the vectorized best-match scan.  Returns
        list[family.BestMatch].  Without a device scorer for ``mapping``
        it runs annotate_family + the scalar scan."""
        params = params or EngineParams()
        if not items:
            return []
        if self._device_family_scorer(mapping) is None:
            results, seq_scores = self.annotate_family(items, mapping,
                                                       params, want_best=True)
            return [F.find_best_family_match(
                r.best, seq_scores[i], mapping, kmer_hit_threshold,
                allow_ambiguous, target_genus_id, genus_filter)
                for i, r in enumerate(results)]
        offsets, lengths = self.fa.pad_batch([s for _, s in items])
        return self.best_family_matches_padded(
            offsets, lengths, mapping, params, kmer_hit_threshold,
            allow_ambiguous, target_genus_id, genus_filter)

    FAMILY_MATCH_CHUNK = int(os.environ.get(
        "CLOSE_KMERS_FAMILY_CHUNK", 4096))
    FAMILY_MATCH_GROUP = int(os.environ.get(
        "CLOSE_KMERS_FAMILY_GROUP", 4))   # chunks in flight at most

    def _chunk_rows(self, B0: int, L: int) -> int:
        """Rows per dispatch of best_family_matches_padded, sized as the
        JAX engine sizes them: ~1.5M windows per chunk (at least
        FAMILY_MATCH_CHUNK, at most 65536, a power of two), or the whole
        request rounded up to a power of two (at least 256) when it is
        smaller."""
        W = max(1, L - 8)
        CH = min(65536, max(self.FAMILY_MATCH_CHUNK,
                            1 << max(1, (1_500_000 // W).bit_length() - 1)))
        return CH if B0 > CH else max(256, 1 << max(B0 - 1, 0).bit_length())

    def best_family_matches_padded(self, offsets, lengths, mapping,
                                   params: EngineParams | None = None,
                                   kmer_hit_threshold: int = 3,
                                   allow_ambiguous: bool = False,
                                   target_genus_id: int = 0,
                                   genus_filter: bool = True,
                                   as_arrays: bool = False):
        """Array-native best_family_matches over a pre-padded [B, L]
        offsets grid (e.g. the /fq_lookup ORF batcher,
        translate.batch_orf_arrays).

        The rows go in fixed-size chunks (the tail padded with empty
        sequences), each one fused device pass with global packs for the
        calls and the family groups.  At most FAMILY_MATCH_GROUP chunks
        are in flight: the next chunk is dispatched, and its result's
        copy to the host started, before the oldest is read back and
        finished on the host.  Sticky caps are per sequence; an overflow
        re-runs that chunk with what its readback says it needs."""
        params = params or EngineParams()
        dfs = self._device_family_scorer(mapping)
        if dfs is None:
            items = [(str(i), offsets[i, :int(lengths[i])])
                     for i in range(offsets.shape[0])]
            results, seq_scores = self.annotate_family(items, mapping,
                                                       params, want_best=True)
            ms = [F.find_best_family_match(
                r.best, seq_scores[i], mapping, kmer_hit_threshold,
                allow_ambiguous, target_genus_id, genus_filter)
                for i, r in enumerate(results)]
            return F.BestMatchColumns.from_objects(ms) if as_arrays else ms
        B0 = int(offsets.shape[0])
        if B0 == 0:
            return F.BestMatchColumns.from_objects([]) if as_arrays else []
        B = self._chunk_rows(B0, offsets.shape[1])
        lengths = np.asarray(lengths, dtype=np.int32)
        fold_calls, fold_rows = dfs.pack_flags(offsets.shape[1])
        unpack_calls = DeviceScorer.unpack_dense2 if fold_calls \
            else DeviceScorer.unpack_dense3

        def run(c_off, c_len):
            """One fused pass with the sticky caps; its two packs' copy
            to the host starts at once, as one transfer.  Returns (call
            cap, group cap, length of the calls pack, the readback, the
            row gather's IdCheck)."""
            gcap = dfs.bm_groups_per_seq * B
            calls_dev, call_cap, rows_dev, _, check = dfs.score_family_packed(
                c_off, c_len, params, dfs.bm_calls_per_seq, -gcap,
                slim_calls=True)
            return (call_cap, gcap, calls_dev.shape[0],
                    _Readback(torch.cat([calls_dev, rows_dev])), check)

        def dispatch(a):
            c_off = offsets[a:a + B]
            c_len = lengths[a:a + B]
            n = c_off.shape[0]
            if n < B:
                pad = np.full((B - n, offsets.shape[1]), 20, np.uint8)
                c_off = np.concatenate([c_off, pad])
                c_len = np.concatenate([c_len, np.zeros(B - n, np.int32)])
            return c_off, c_len, n, run(c_off, c_len)

        outs = []

        def finish(chunk):
            c_off, c_len, n, (call_cap, gcap, split, rb, check) = chunk
            while True:
                joined = rb.result()
                check.raise_if_bad()
                calls_np, rows_np = joined[:split], joined[split:]
                dense = unpack_calls(calls_np, B, call_cap)
                roll = DeviceFamilyScorer.finish_rollup_global(
                    rows_np, B, gcap, folded=fold_rows)
                if dense is not None and roll is not None:
                    break
                if dense is None:
                    need = -(-int(calls_np[:B].sum()) // B)
                    dfs.bm_calls_per_seq = max(call_cap // B * 4, need)
                if roll is None:
                    need = -(-int(rows_np[:B].sum()) // B)
                    dfs.bm_groups_per_seq = max(gcap // B * 4, need)
                call_cap, gcap, split, rb, check = run(c_off, c_len)
            n_calls, cc, cf, cw = dense
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, None, None, cc, cf, cw)
            n_per, fam, counts, weights, first = roll
            total = int(np.asarray(n_per[:n]).sum())
            reduction = F.BestCallReduction(nf[:n], ofi[:n], ocnt[:n],
                                            owt[:n], self.db.functions)
            outs.append(F.find_best_family_matches_batch(
                reduction, np.asarray(n_per[:n]), fam[:total],
                counts[:total], weights[:total], first[:total],
                mapping, kmer_hit_threshold, allow_ambiguous,
                target_genus_id, genus_filter, as_arrays=as_arrays))

        in_flight = max(1, self.FAMILY_MATCH_GROUP)
        pending = collections.deque()
        for a in range(0, B0, B):
            if len(pending) >= in_flight:
                finish(pending.popleft())
            pending.append(dispatch(a))
        while pending:
            finish(pending.popleft())

        if not as_arrays:
            return [m for chunk in outs for m in chunk]
        return F.BestMatchColumns.concat(outs)

    def _device_matrix(self, mapping) -> DeviceMatrix:
        """The /matrix DeviceMatrix of ``mapping``, one per mapping and
        engine; it caches the mapping's staged peg CSR
        (:meth:`DeviceMatrix.mapping_csr`)."""
        dm = self._device_matrices.get(mapping)
        if dm is None:
            dm = self._device_matrices[mapping] = DeviceMatrix(self)
        return dm

    def family_scores_batch(self, mapping, h: dict) -> tuple:
        """Per-sequence family score accumulation against ``mapping``'s
        CSR.  ``h``: compact hit arrays from annotate_with_hits."""
        keys, offs, vals = mapping.fam_csr()
        return native.family_scores(h["code"], h["row_off"], keys, offs, vals)

    def best_call(self, calls: list[O.Call]) -> O.BestCall:
        return O.find_best_call(calls, self.function_of)
