"""On-device scoring, torch port of ``close_kmers_tpu/core/device_score.py``:
the gather_hits run/gap/two-hit state machine fused with the probe, and
compaction of the emitted CALLs into one packed int32 buffer.

Ported: ``neutral_scan_state``, ``_scan_score_core`` (whose loop is the
``scan_score`` kernel; the genome program chains it over tiles),
``probe_score`` (the counterpart of ``_probe_score_jit``, with the slim
0/2/3 packs of ``compact_calls``, which the family and genome programs
share), ``probe_best`` (the counterpart of ``_probe_best_jit``: the scan's
calls reduced on the device by the ``best_call`` kernel, the port of
``_best_call_device``) and ``DeviceScorer`` (``score_batch``,
``score_batch_packed``, ``slim_mode``, the unpackers, and the fused
best-call path ``best_batch_packed`` / ``best_calls_batch`` /
``finish_best_batch``).  Left out: the packed-upload arguments of
``score_batch_packed`` (relay packers, see core/engine.py).

Exactness: integer fields match the oracle exactly; weighted sums are
float32 additions in the order the reference performs them.  The
hit-buffer cap (kguts.cc:850-851) is not modeled; the padded width must
stay below HIT_BUFFER_CAP.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import params as P
from ..params import EngineParams
from ..native import api as native
from ..ops.best_call import best_call
from ..ops.scan_score import neutral_scan_state, scan_score  # noqa: F401
from ..utils.device import resolve_device
from .engine import DeviceDB, encode_windows, finish_best_call, \
    probe_windows, stable_true_first

# Copied from close_kmers_tpu/core/device_family.py: slim CALL pack plane
# = (count << CALL_FOLD_SHIFT) | fi, legal when counts fit CALL_CNT_BITS
# (count <= W+1) and fi fits the shift.
CALL_FOLD_SHIFT = 18
CALL_CNT_BITS = 13


def _scan_score_core(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                     max_gap, order_constraint, init=None, pos0=None,
                     want_emit=True, final_flush=None):
    """The gather_hits state machine over [B, W] probe outputs, with the
    chained-tile arguments of the JAX function: ``init`` (13-field carry
    to resume from), ``pos0`` ([B] global position of column 0),
    ``want_emit=False`` (final state only) and ``final_flush`` ([B] bool:
    rows that perform the end-of-sequence flush).  Returns (emit [B,
    W+1], [start, end, count, fi, weighted], state)."""
    if found.shape[1] >= P.HIT_BUFFER_CAP:
        raise ValueError("padded width exceeds the reference hit-buffer cap")
    return scan_score(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                      max_gap, order_constraint, init, pos0, want_emit,
                      final_flush)


def _scan_score(found, h_fi, h_av, h_wt, min_hits, min_weighted_hits,
                max_gap, order_constraint):
    emit, fields, _state = _scan_score_core(
        found, h_fi, h_av, h_wt, min_hits, min_weighted_hits, max_gap,
        order_constraint)
    return emit, fields


def compact_calls(emit, fields, call_cap: int, slim: int = 0):
    """The emitted CALLs of a scan, left-packed into one int32 buffer:
    [B] per-sequence call counts, then the planes of the compacted calls
    -- (start, end, count, fi, wt-bits) for slim 0, (count <<
    CALL_FOLD_SHIFT | fi, wt-bits) for slim 2, (count, fi, wt-bits) for
    slim 3 -- each min(call_cap, B*(W+1)) long.  Shared by probe_score
    and the family program (device_family.score_family)."""
    c_start, c_end, c_cnt, c_fi, c_wt = fields
    n_calls = emit.sum(dim=1, dtype=torch.int32)
    # stable: keeps row-major (= per-sequence, position-ordered) order
    order = stable_true_first(emit.reshape(-1))[:call_cap]

    def take(x):
        return x.reshape(-1)[order]

    wt_bits = take(c_wt).view(torch.int32)
    if slim == 2:
        planes = [(take(c_cnt) << CALL_FOLD_SHIFT) | take(c_fi), wt_bits]
    elif slim == 3:
        planes = [take(c_cnt), take(c_fi), wt_bits]
    else:
        planes = [take(c_start), take(c_end), take(c_cnt), take(c_fi),
                  wt_bits]
    return torch.cat([n_calls, torch.stack(planes).reshape(-1)])


def probe_score(ddb: DeviceDB, offsets, lengths, params: EngineParams,
                call_cap: int, slim: int = 0):
    """Encode + probe + scan + CALL compaction (device_score.py::
    _probe_score_jit).  Returns (out, n_hits_total): ``out`` is the
    :func:`compact_calls` buffer."""
    hi, lo, valid = encode_windows(offsets, lengths)
    found, p_fi, _p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)
    emit, fields = _scan_score(
        found, p_fi, p_av, p_wt, params.min_hits, params.min_weighted_hits,
        params.max_gap, params.order_constraint)
    return (compact_calls(emit, fields, call_cap, slim),
            found.sum(dtype=torch.int32))


def probe_best(ddb: DeviceDB, offsets, lengths, params: EngineParams):
    """Encode + probe + scan + find_best_call's reductions
    (device_score.py::_probe_best_jit).  Returns the [B, 9] int32 pack
    of :func:`ops.best_call.best_call`: n_funcs, fi0, cnt0, wt0 (bits),
    fi1, cnt1, wt1 (bits), vec2 count, overflow (a row with more than 32
    calls, which needs the host fallback)."""
    hi, lo, valid = encode_windows(offsets, lengths)
    found, p_fi, _p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)
    emit, (_start, _end, c_cnt, c_fi, c_wt) = _scan_score(
        found, p_fi, p_av, p_wt, params.min_hits, params.min_weighted_hits,
        params.max_gap, params.order_constraint)
    return best_call(emit, c_cnt, c_fi, c_wt)


def _unpack(out: np.ndarray, B: int, n_planes: int):
    """Packed buffer -> (n_calls, dense [B, maxc] planes), or None when
    the buffer's plane length is shorter than the emitted total."""
    n_calls = out[:B]
    total = int(n_calls.sum())
    # the pack holds min(cap, B*(W+1)) entries: size from the buffer
    pack = out[B:].reshape(n_planes, -1)
    if total > pack.shape[1]:
        return None
    maxc = max(1, int(n_calls.max()) if B else 1)
    rows = np.repeat(np.arange(B), n_calls)
    row_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(n_calls, out=row_off[1:])
    cols = np.arange(total) - row_off[rows]
    dense = []
    for j in range(n_planes):
        d = np.zeros((B, maxc), dtype=np.int32)
        d[rows, cols] = pack[j, :total]
        dense.append(d)
    return n_calls, dense


class DeviceScorer:
    """Fused probe+score engine: uploads a padded batch, downloads only
    the packed compact call lists.  On a CUDA device the probe and the
    scan run as the ``probe_select`` and ``scan_score`` kernels."""

    def __init__(self, db, device, ddb: DeviceDB | None = None):
        """``ddb``: ``db``'s tables already on ``device`` (e.g. built in a
        tier of one's choosing); by default ``DeviceDB.from_db``'s."""
        self.db = db
        self.device = resolve_device(device)
        self.ddb = ddb if ddb is not None else DeviceDB.from_db(db,
                                                                self.device)

    def _upload(self, offsets, lengths):
        return (torch.from_numpy(np.ascontiguousarray(offsets)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(
                    lengths, dtype=np.int32)).to(self.device))

    def score_batch(self, offsets: np.ndarray, lengths: np.ndarray,
                    params: EngineParams | None = None,
                    calls_per_seq_cap: int = 4):
        """Returns (n_calls[B], calls) where calls is a list of per-seq
        lists of (start, end, count, fi, weighted_f32); retries with a
        4x cap when the emitted calls overflow it."""
        params = params or EngineParams()
        B = offsets.shape[0]
        cap = B * calls_per_seq_cap
        out, _ = probe_score(self.ddb, *self._upload(offsets, lengths),
                             params, cap)
        out = out.cpu().numpy()
        n_calls = out[:B]
        if int(n_calls.sum()) > cap:
            return self.score_batch(offsets, lengths, params,
                                    calls_per_seq_cap * 4)
        pack = out[B:].reshape(5, -1)
        starts, ends, cnts, fis = pack[:4]
        wts = pack[4].view(np.float32)
        calls = []
        k = 0
        for b in range(B):
            calls.append([(int(starts[k + i]), int(ends[k + i]),
                           int(cnts[k + i]), int(fis[k + i]),
                           np.float32(wts[k + i]))
                          for i in range(int(n_calls[b]))])
            k += int(n_calls[b])
        return n_calls, calls

    @staticmethod
    def unpack_dense(out: np.ndarray, B: int, cap: int):
        """Packed buffer -> (n_calls[B], dense [B, maxc] call arrays
        (start, end, count, fi, wt)) for native best-call reduction.
        Returns None if the cap overflowed (caller retries bigger)."""
        r = _unpack(out, B, 5)
        if r is None:
            return None
        n_calls, (cs, ce, cc, cf, cw_bits) = r
        return n_calls, cs, ce, cc, cf, cw_bits.view(np.float32)

    @staticmethod
    def unpack_dense3(out: np.ndarray, B: int, cap: int):
        """Slim-pack variant (3 planes: count, fi, wt-bits).  Returns
        (n_calls, cc, cf, cw) or None on cap overflow."""
        r = _unpack(out, B, 3)
        if r is None:
            return None
        n_calls, (cc, cf, cw_bits) = r
        return n_calls, cc, cf, cw_bits.view(np.float32)

    @staticmethod
    def unpack_dense2(out: np.ndarray, B: int, cap: int):
        """Folded slim-pack variant (2 planes: cnt<<18|fi, wt-bits).
        Returns (n_calls, cc, cf, cw) or None on cap overflow."""
        r = _unpack(out, B, 2)
        if r is None:
            return None
        n_calls, (cnt_fi, cw_bits) = r
        return (n_calls, cnt_fi >> CALL_FOLD_SHIFT,
                cnt_fi & ((1 << CALL_FOLD_SHIFT) - 1),
                cw_bits.view(np.float32))

    def slim_mode(self) -> int:
        """The cheapest legal call-pack for best-call-only consumers:
        2 (folded cnt|fi plane) when every fi fits CALL_FOLD_SHIFT bits,
        else 3 (separate cnt/fi planes).  Positions are dropped either
        way -- find_best_call never reads them (kguts.cc:1023-1139)."""
        n_funcs = int(self.db.fi.max()) + 1 if len(self.db) else 1
        return 2 if n_funcs < (1 << CALL_FOLD_SHIFT) else 3

    def score_batch_packed(self, offsets, lengths,
                           params: EngineParams | None = None,
                           calls_per_seq_cap: float = 4, slim: int = 0):
        """Returns (the packed buffer as a device tensor, not yet
        transferred, and its cap).  ``slim`` (0/2/3, see
        :meth:`slim_mode`) selects the call-pack plane count; unpack
        with unpack_dense / unpack_dense2 / unpack_dense3."""
        params = params or EngineParams()
        # fractional caps allowed: the cap bounds TOTAL calls per batch
        cap = int(offsets.shape[0] * calls_per_seq_cap)
        out, _ = probe_score(self.ddb, *self._upload(offsets, lengths),
                             params, cap, slim)
        return out, cap

    def best_batch_packed(self, offsets, lengths,
                          params: EngineParams | None = None):
        """Fully fused best-call path: probe + scan + the device
        find_best_call reductions.  Returns the [B, 9] int32 pack of
        :func:`probe_best` as a device tensor, not yet transferred."""
        params = params or EngineParams()
        return probe_best(self.ddb, *self._upload(offsets, lengths), params)

    def best_calls_batch(self, offsets, lengths, function_of,
                         params: EngineParams | None = None):
        """The complete fused best-call path: device reductions + host
        decision, with the rows that overflow the device call-stream cap
        (more than 32 calls, column 8) scored again exactly through the
        compact-call path and the native top-3 reduction.  Returns one
        oracle.BestCall per row."""
        params = params or EngineParams()
        out = self.best_batch_packed(offsets, lengths, params).cpu().numpy()
        res = self.finish_best_batch(out, function_of, overflow="ignore")
        rows = np.nonzero(out[:, 8])[0]
        if len(rows):
            sub_off = np.ascontiguousarray(offsets[rows])
            sub_len = np.ascontiguousarray(lengths[rows])
            dev, cap = self.score_batch_packed(
                sub_off, sub_len, params,
                calls_per_seq_cap=float(sub_off.shape[1]))
            n_calls, cs, ce, cc, cf, cw = self.unpack_dense(
                dev.cpu().numpy(), len(rows), cap)
            nf, ofi, ocnt, owt = native.best_call_batch(
                n_calls, cs, ce, cc, cf, cw)
            for k, r in enumerate(rows):
                res[r] = finish_best_call(int(nf[k]), ofi[k], ocnt[k],
                                          owt[k], function_of)
        return res

    @staticmethod
    def finish_best_batch(out_np: np.ndarray, function_of,
                          overflow: str = "raise"):
        """Host decision step over the device reductions: one
        oracle.BestCall per row of the [B, 9] pack (exact, including the
        lexicographic ambiguous-pair naming).  ``overflow="raise"``
        raises ``OverflowError`` when a row exceeded the device
        call-stream cap; ``"ignore"`` skips the check (best_calls_batch
        scores those rows again)."""
        if overflow == "raise" and out_np[:, 8].any():
            raise OverflowError(
                "rows exceeded the device call-stream cap; use the "
                "score_batch path for these sequences")
        # plain Python values, row by row: the f32 weights widen exactly,
        # as finish_best_call's float() of an np.float32 does
        wts = out_np[:, [3, 6]].copy().view(np.float32).tolist()
        return [finish_best_call(nf, (fi0, fi1, 0), (cnt0, cnt1, v2c),
                                 (w[0], w[1], 0.0), function_of)
                for (nf, fi0, cnt0, _, fi1, cnt1, _, v2c, *_), w
                in zip(out_np.tolist(), wts)]
