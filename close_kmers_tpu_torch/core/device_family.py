"""On-device family-score rollup, torch port of
``close_kmers_tpu/core/device_family.py``.

The /lookup family path accumulates, per sequence, {family: (hit_count,
weighted_total += 1/N)} over every signature-kmer hit
(lookup_request.cc:446-469).  This module keeps that rollup on the
device, so only the per-(sequence, family) groups leave it:

1. the kmer->family CSR is densified to a degree-padded [N+1, D] int32
   table aligned to the signature DB rows (row N is all pad);
2. each window's family row comes either from the probe's matched row id
   through the ``row_gather`` kernel (the two-gather path), or straight
   from the folded famwide probe row through the ``famwide_select``
   kernel (one row read per window);
3. each sequence's family row is weighted by 1/degree, sorted by
   family, grouped and left-packed by the ``family_group`` kernel, and
   packed per row, globally (:func:`pack_global`), or hierarchically.

Exactness: counts are integer-exact; the 1/degree weights are host-made
IEEE f32 constants (never a device divide); the sort keeps each family
group in (window, family-list) order, the host path's visit order, and
the group sums are sequential f32 adds, so the rollup is bit-identical
to ``native.family_scores``.

Ported: ``DeviceFamilyDB`` (``from_mapping``, ``famwide_from_mapping``,
``_dense_fam``, and ``from_numpy`` for state carried over from the JAX
package), ``_gather_fams``, ``rollup_from_fams`` (all three packs; its
row-local sort and scan are ``ops.family_group``),
``family_rollup`` (``_family_rollup_jit``), ``score_family``
(``_score_family_jit``) and ``DeviceFamilyScorer``.  Left out:
``engine._probe_count_pad``, which only padded the TPU's gather.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..db.signature_db import SignatureDB
from ..params import EngineParams
from ..ops.family_group import family_group
from ..ops.probe_select import famwide_select
from ..ops.row_gather import IdCheck, row_gather
from ..utils.device import resolve_device
from ..utils.metrics import Metrics
from .device_score import CALL_CNT_BITS, CALL_FOLD_SHIFT, _scan_score, \
    compact_calls
from .engine import FUSED_BUCKET_MAX, FUSED_LO_BITS, FUSED_SENTINEL, K, \
    DeviceDB, encode_windows, probe_windows

# D2H fold constants, copied from close_kmers_tpu/core/device_family.py:
# rollup pack plane = (count << ROW_FOLD_SHIFT) | first, legal when both
# fit ROW_FIT_BITS (count, first <= W*D+1).
ROW_FOLD_SHIFT = 16
ROW_FIT_BITS = 15


# CSR keys a block of the family table's host builds (fan_out,
# DeviceFamilyDB._dense_fam): bounds their numpy temporaries
CSR_BLOCK = 1 << 24


def fan_out(mapping) -> int:
    """D of ``mapping``'s dense family table: the most families one kmer
    maps to (at least 1), read from its CSR offsets alone."""
    offs = mapping.fam_csr()[1]
    d = 1
    for a in range(0, len(offs) - 1, CSR_BLOCK):
        seg = offs[a:a + CSR_BLOCK + 1]
        d = max(d, int((seg[1:] - seg[:-1]).max()))
    return d


@dataclasses.dataclass
class DeviceFamilyDB:
    fam: torch.Tensor   # i32[N+1, D] family ids, -1 padded
    d: int

    # The JAX package's gates of the folded famwide table (TPU v5e
    # budgets: HBM bytes, scale), kept as the oracle of its choice
    # (:meth:`jax_famwide`), which tests hold against the JAX package.
    FAMWIDE_MAX_BYTES = 3 << 30
    FAMWIDE_MAX_D = 8
    FAMWIDE_MIN_KEYS = 1_000_000

    @classmethod
    def _dense_fam(cls, db: SignatureDB, mapping):
        """[N+1, D] densified per-DB-row family lists (-1 padded): the JAX
        package's table (device_family.py:66-83), built in blocks of
        CSR_BLOCK mapping keys; where the mapping's keys are the DB's
        own (a family universe over every key), each key's row is its
        index and no search runs."""
        keys, offs, vals = mapping.fam_csr()
        n = len(db)
        D = fan_out(mapping)
        fam = np.full((n + 1, D), -1, dtype=np.int32)
        same = len(keys) == n and (keys is db.keys
                                   or np.array_equal(keys, db.keys))
        last = max(len(vals) - 1, 0)
        for a in range(0, len(keys), CSR_BLOCK):
            b = min(len(keys), a + CSR_BLOCK)
            start = offs[a:b]
            c = offs[a + 1:b + 1] - start
            if same:
                # row i is key i: column j gathers each key's j-th family
                # (a forward read of vals), -1 past the key's degree
                for j in range(D):
                    col = np.take(vals, np.minimum(start + j, last)) \
                        if len(vals) else np.zeros(b - a, np.int32)
                    fam[a:b, j] = np.where(c > j, col, -1)
                continue
            rows = np.searchsorted(db.keys, keys[a:b])
            ok = (rows < n) & (db.keys[np.minimum(rows, n - 1)]
                               == keys[a:b]) if n else np.zeros(b - a, bool)
            for j in range(D):
                m = ok & (c > j)
                fam[rows[m], j] = vals[start[m] + j]
        return fam, D

    @classmethod
    def from_mapping(cls, db: SignatureDB, mapping,
                     device) -> "DeviceFamilyDB":
        fam, D = cls._dense_fam(db, mapping)
        return cls.from_numpy(fam, device, copy=False)

    @classmethod
    def from_numpy(cls, fam, device, copy: bool = True) -> "DeviceFamilyDB":
        """State carry-over: the JAX ``DeviceFamilyDB.fam`` array (or any
        [N+1, D] int32 family table) onto ``device``.  ``copy=False``
        hands an int32 array over: a CPU tensor then shares its memory."""
        fam = np.array(fam, dtype=np.int32) if copy \
            else np.ascontiguousarray(fam, dtype=np.int32)
        return cls(torch.from_numpy(fam).to(resolve_device(device)),
                   fam.shape[1])

    @staticmethod
    def famwide_row_w(db: SignatureDB, D: int) -> int:
        """Ints of one famwide row: (2 + D) planes of the deepest bucket's
        width, lane-padded to a multiple of 128."""
        W = max(1, int(db.max_bucket))
        return -(-((2 + D) * W) // 128) * 128

    @staticmethod
    def famwide_packs(db: SignatureDB) -> bool:
        """Whether ``db`` can have famwide rows at all: keys, and every
        function index narrow enough to pack beside a lo code."""
        return len(db) > 0 and \
            int(db.fi.max()) < (1 << (31 - FUSED_LO_BITS))

    @classmethod
    def jax_famwide(cls, db: SignatureDB, D: int) -> bool:
        """The JAX package's auto gate (device_family.py:109-121) for a
        mapping of fan-out ``D`` over ``db``: the oracle of its choice."""
        return (cls.famwide_packs(db) and D <= cls.FAMWIDE_MAX_D
                and 0 < db.max_bucket <= FUSED_BUCKET_MAX
                and len(db) >= cls.FAMWIDE_MIN_KEYS
                and db.n_hi * cls.famwide_row_w(db, D) * 4
                <= cls.FAMWIDE_MAX_BYTES)

    @classmethod
    def card_famwide(cls, db: SignatureDB, D: int) -> bool:
        """The port's auto gate: whether the family program builds famwide
        rows for a mapping of fan-out ``D`` over ``db`` by itself.  Never
        on one H100 (PERF.md §6, "famwide gate"): the two gathers
        (probe_search, then row_gather) were no slower end to end on the
        query cell and on the uniform 210M-key DB and faster by kernel
        (1.18x and 2.0x), and they need no table beside the probe's.
        ``famwide=True`` still builds the rows."""
        return False

    @classmethod
    def _famwide_table(cls, db: SignatureDB, fam: np.ndarray, D: int,
                       force: bool | None):
        """The numpy half of :meth:`famwide_from_mapping` (JAX
        device_family.py:93-148), given the dense family table."""
        if force is False or not cls.famwide_packs(db):
            return None
        if force is None and not cls.card_famwide(db, D):
            return None
        n = len(db)
        H = db.n_hi
        W = max(1, int(db.max_bucket))
        row_w = cls.famwide_row_w(db, D)
        tab = np.zeros((H, row_w), dtype=np.int32)
        tab[:, :W] = FUSED_SENTINEL          # packed-plane sentinel
        rank = np.arange(n, dtype=np.int64) \
            - db.bucket_start[db.hi].astype(np.int64)
        base = db.hi.astype(np.int64) * row_w + rank
        flat = tab.reshape(-1)
        flat[base] = (db.fi.astype(np.int64) << FUSED_LO_BITS) | db.lo
        flat[base + W] = db.wt.view(np.int32)
        for p in range(D):
            flat[base + (2 + p) * W] = fam[:n, p]
        return tab, W, D

    @classmethod
    def famwide_from_mapping(cls, db: SignatureDB, mapping, device,
                             force: bool | None = None):
        """Folded family probe rows: [(fi<<13|lo) xW | wt-bits xW |
        fam_0 xW .. fam_{D-1} xW] per hi bucket, lane-padded to a
        multiple of 128 ints, so the family program reads one row per
        window.  oi/avg_off are not carried (callers take the two-gather
        path under order_constraint).  Returns (tensor [H, row_w], W, D)
        or None when a gate trips (``force=True`` overrides the byte and
        scale gates, ``force=False`` disables)."""
        fam, D = cls._dense_fam(db, mapping)
        fw = cls._famwide_table(db, fam, D, force)
        if fw is None:
            return None
        return torch.from_numpy(fw[0]).to(resolve_device(device)), fw[1], D


def _gather_fams(fam_tab, idx):
    """[B, W] matched-row ids -> ([B, W, D] family rows, the gather's
    IdCheck) through the ``row_gather`` kernel.  A miss's id is N, the
    table's all-pad row."""
    B, W = idx.shape
    fams, check = row_gather(fam_tab, idx.reshape(-1).contiguous())
    return fams.reshape(B, W, -1), check


def rollup_from_fams(fams, cap_seq: int, row_cap: int = 0):
    """[B, W, D] gathered family rows (-1 = pad/miss) -> per-sequence
    (family, count, weighted, first) groups, in one of three packs:

    * ``cap_seq >= 0``: row-major int32 [B, 1 + 4*c], each row
      [n_per_seq, fam*c, cnt*c, wt-bits*c, first*c] with c =
      min(cap_seq, W*D+1), the JAX package's width (parse with
      DeviceFamilyScorer.finish_rollup_rows);
    * ``cap_seq < 0``: global, a flat [B + P*L] buffer of n_per_seq then
      P planes of L = min(-cap_seq, B*(W*D+1)) entries packed across the
      batch in row-major order: (fam, cnt<<16|first, wt-bits) when W*D+1
      < 2^15 (folded, P = 3), else (fam, cnt, wt-bits, first);
    * ``cap_seq < 0, row_cap > 0``: hierarchical, each row cut to its
      first row_cap groups before the global pack, L = min(-cap_seq,
      B*min(row_cap, W*D+1)).

    ``first`` is each family's first-hit flat (window*D + list) position,
    from which hosts rebuild the reference's first-hit order.
    n_per_seq always carries the true group counts, so parsers detect
    an overflow.  Slots past the emitted groups hold zeros (the JAX
    program leaves scan state there; no parser reads them)."""
    B, W, D = fams.shape
    M = W * D
    if cap_seq >= 0:
        n, fam_d, cnt_d, ws_d, first_d = family_group(fams,
                                                      min(cap_seq, M + 1))
        return torch.cat([n[:, None], fam_d, cnt_d, ws_d.view(torch.int32),
                          first_d], dim=1)
    R = min(row_cap, M + 1) if row_cap > 0 else M + 1
    return pack_global(family_group(fams, R), -cap_seq, M)


def pack_global(groups, gcap: int, M: int):
    """The global pack of :func:`rollup_from_fams`: ``family_group``'s
    (n_groups [B], fam, count, weighted, first [B, R]) -> [B + P*L],
    n_groups then the P planes of each row's first R groups, packed
    across the batch in row-major order, L = min(gcap, B*R), zero past
    the batch's groups; folded (P = 3) when M + 1 < 2^15.  Each packed
    slot gathers its group (its row by a search over the rows' ends), so
    the work scales with L, not with the B*R slots of the planes."""
    n, fam_d, cnt_d, ws_d, first_d = groups
    B, R = fam_d.shape
    dev = fam_d.device
    length = min(gcap, B * R)
    kept = torch.clamp(n, max=R).to(torch.int64)
    ends = torch.cumsum(kept, 0)
    t = torch.arange(length, device=dev)
    row = torch.searchsorted(ends, t, right=True)
    filled = row < B
    row = torch.clamp(row, max=max(B - 1, 0))
    src = torch.where(filled, row * R + t - (ends[row] - kept[row]), 0)

    def pack(x):
        return torch.where(filled, x.reshape(-1)[src], 0)

    fold = (M + 1) < (1 << ROW_FIT_BITS)
    planes = [pack(fam_d)]
    planes.append((pack(cnt_d) << ROW_FOLD_SHIFT) | pack(first_d) if fold
                  else pack(cnt_d))
    planes.append(pack(ws_d.view(torch.int32)))
    if not fold:
        planes.append(pack(first_d))
    return torch.cat([n, torch.stack(planes).reshape(-1)])


def family_rollup(ddb: DeviceDB, fam_tab, offsets, lengths, cap_seq: int):
    """Probe + family rollup in the legacy flat layout
    (``_family_rollup_jit``): [B n_per_seq] ++ [B*c fam] ++ [B*c cnt] ++
    [B*c wt-bits] ++ [B*c first], c = min(cap_seq, W*D+1).  Returns
    (buffer, c, the gather's IdCheck)."""
    hi, lo, valid = encode_windows(offsets, lengths)
    *_, idx = probe_windows(ddb, hi, lo, valid)
    fams, check = _gather_fams(fam_tab, idx)
    rows = rollup_from_fams(fams, cap_seq)
    c = (rows.shape[1] - 1) // 4
    return torch.cat([rows[:, 0]] + [rows[:, 1 + j * c:1 + (j + 1) * c]
                                     .reshape(-1) for j in range(4)]), c, \
        check


def score_family(ddb: DeviceDB, fam_tab, offsets, lengths,
                 params: EngineParams, call_cap: int, cap_seq: int,
                 slim_calls: bool = False, row_cap: int = 0, famwide=None,
                 fold_calls: bool = False):
    """The family-serving program (``_score_family_jit``): one probe
    feeding both the scoring scan (the :func:`compact_calls` buffer) and
    the family rollup (:func:`rollup_from_fams`).  Returns (calls, rows,
    check): ``check`` is the row gather's :class:`IdCheck`, to be raised
    after the caller's copy of ``calls`` or ``rows`` to the host.

    ``famwide``: None for the two-gather path (payload-wide probe, then
    the family rows by matched row id), or (table, fam_w, fam_d) for the
    folded single-read path, which carries no avg_off and so refuses
    ``order_constraint``.  ``slim_calls`` drops the start/end planes of
    the CALL pack; with ``fold_calls`` it folds count and fi into one
    plane (callers guarantee that they fit)."""
    hi, lo, valid = encode_windows(offsets, lengths)
    if famwide is not None:
        if params.order_constraint:
            raise ValueError("the famwide rows carry no avg_off plane, "
                             "which order_constraint needs")
        table, fam_w, fam_d = famwide
        sh = hi.shape
        found, p_fi, p_wt, fams = famwide_select(
            hi.reshape(-1), lo.reshape(-1), valid.reshape(-1), table, fam_w,
            fam_d, FUSED_LO_BITS)
        found, p_fi, p_wt = (x.reshape(sh) for x in (found, p_fi, p_wt))
        p_av = torch.zeros_like(p_fi)
        fams = fams.reshape(*sh, fam_d)
        check = IdCheck()
    else:
        found, p_fi, _oi, p_av, p_wt, idx = probe_windows(ddb, hi, lo, valid)
        fams, check = _gather_fams(fam_tab, idx)
    emit, fields = _scan_score(found, p_fi, p_av, p_wt, params.min_hits,
                               params.min_weighted_hits, params.max_gap,
                               params.order_constraint)
    slim = (2 if fold_calls else 3) if slim_calls else 0
    return (compact_calls(emit, fields, call_cap, slim),
            rollup_from_fams(fams, cap_seq, row_cap), check)


class DeviceFamilyScorer:
    """Fused probe + family rollup engine on one device."""

    _default_cap = 8

    def __init__(self, db: SignatureDB, mapping, device, ddb=None,
                 famwide: bool | None = False):
        """``ddb``: share an existing DeviceDB (e.g. the serving engine's)
        instead of uploading the signature table again.  ``famwide``:
        the folded single-read family rows; True forces them (tests,
        measurements), None applies the port's auto gate
        (:meth:`DeviceFamilyDB.card_famwide`), False disables them;
        ``DeviceFamilyDB.jax_famwide(db, fan_out(mapping))`` gives the
        JAX package's choice.  ``build_seconds`` keeps the host seconds
        of the dense table, the famwide rows and the upload."""
        t0 = time.perf_counter()
        fam, D = DeviceFamilyDB._dense_fam(db, mapping)
        t1 = time.perf_counter()
        fw = DeviceFamilyDB._famwide_table(db, fam, D, famwide)
        t2 = time.perf_counter()
        self._setup(db, device, ddb, fam, fw)
        self.build_seconds = dict(dense_fam=t1 - t0, famwide=t2 - t1,
                                  upload=time.perf_counter() - t2)

    @classmethod
    def from_numpy(cls, db: SignatureDB, fields: dict, device,
                   ddb=None) -> "DeviceFamilyScorer":
        """State carry-over from the JAX ``DeviceFamilyScorer``:
        ``fields`` holds ``fam`` (its ``fdb.fam`` as numpy), ``famwide``
        (numpy, or None) and ``fam_w``."""
        fam = np.array(fields["fam"], dtype=np.int32)     # own copy
        fw = fields.get("famwide")
        fw = None if fw is None else (np.array(fw, dtype=np.int32),
                                      int(fields["fam_w"]), fam.shape[1])
        self = cls.__new__(cls)
        self._setup(db, device, ddb, fam, fw)
        return self

    def _setup(self, db, device, ddb, fam, fw) -> None:
        self.db = db
        self.device = resolve_device(device)
        self.ddb = ddb if ddb is not None else DeviceDB.from_db(db,
                                                                self.device)
        self.fdb = DeviceFamilyDB.from_numpy(fam, self.device, copy=False)
        self.famwide, self.fam_w, self.fam_d = (None, 0, 0) if fw is None \
            else (torch.from_numpy(np.ascontiguousarray(fw[0])).to(
                self.device), fw[1], fw[2])
        self._fi_fold_ok = (int(db.fi.max()) < (1 << CALL_FOLD_SHIFT)) \
            if len(db) else True
        # per-sequence sticky caps of best_family_matches_padded
        # (calls, groups), raised on overflow
        self.bm_calls_per_seq = 1
        self.bm_groups_per_seq = 2
        # where the spans and counters go (its KmerEngine hands over its own)
        self.metrics = Metrics()

    def _upload(self, offsets: np.ndarray, lengths: np.ndarray):
        """A padded batch onto the device: pinned and asynchronous on a
        card, so that dispatching the next batch does not wait for the
        device to drain."""
        o = torch.from_numpy(np.ascontiguousarray(offsets))
        n = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32))
        if self.device.type != "cuda":
            return o, n
        return (o.pin_memory().to(self.device, non_blocking=True),
                n.pin_memory().to(self.device, non_blocking=True))

    def rollup(self, offsets: np.ndarray, lengths: np.ndarray,
               fams_per_seq_cap: int | None = None):
        if fams_per_seq_cap is None:
            # sticky: an overflow escalation raises the default
            fams_per_seq_cap = self._default_cap
        return self._rollup(offsets, lengths, fams_per_seq_cap)

    def rollup_packed(self, offsets: np.ndarray, lengths: np.ndarray,
                      fams_per_seq_cap: int | None = None):
        """Dispatches the probe + rollup and returns the packed device
        buffer (legacy flat layout), its per-row cap and the row gather's
        IdCheck, not yet read back.  Unpack with finish_rollup (None =
        cap overflow) after the check."""
        if fams_per_seq_cap is None:
            fams_per_seq_cap = self._default_cap
        return family_rollup(self.ddb, self.fdb.fam,
                             *self._upload(offsets, lengths),
                             fams_per_seq_cap)

    # finish_rollup, finish_rollup_rows and finish_rollup_global are
    # copied from close_kmers_tpu/core/device_family.py (pure numpy).
    @staticmethod
    def finish_rollup(out_np: np.ndarray, B: int, cap_seq: int):
        """Packed buffer -> (n_per_seq [B], fam, count, weight, first flat
        arrays in (sequence, family-id) order).  Returns None when any row
        overflowed cap_seq (caller retries with a bigger cap)."""
        n_per_seq = out_np[:B]
        if len(n_per_seq) and int(n_per_seq.max(initial=0)) > cap_seq:
            return None
        body = out_np[B:].reshape(4, B, cap_seq)
        mask = np.arange(cap_seq)[None, :] < n_per_seq[:, None]
        run_f = body[0][mask]
        counts = body[1][mask]
        weights = body[2][mask].copy().view(np.float32)
        first = body[3][mask]
        return n_per_seq, run_f, counts, weights, first

    @staticmethod
    def finish_rollup_rows(rows_np: np.ndarray, cap_seq: int):
        """Row-major rollup buffer (rollup_from_fams: [B, 1+4*cap_seq])
        -> same tuple as finish_rollup; None on per-row cap overflow."""
        n_per_seq = rows_np[:, 0]
        if len(n_per_seq) and int(n_per_seq.max(initial=0)) > cap_seq:
            return None
        mask = np.arange(cap_seq)[None, :] < n_per_seq[:, None]
        c = cap_seq
        run_f = rows_np[:, 1:1 + c][mask]
        counts = rows_np[:, 1 + c:1 + 2 * c][mask]
        weights = rows_np[:, 1 + 2 * c:1 + 3 * c][mask].copy() \
            .view(np.float32)
        first = rows_np[:, 1 + 3 * c:1 + 4 * c][mask]
        return n_per_seq, run_f, counts, weights, first

    @staticmethod
    def finish_rollup_global(flat_np: np.ndarray, B: int, gcap: int,
                             row_cap: int = 0, folded: bool = False):
        """Globally-packed rollup buffer ([B + 4*L], or [B + 3*L] when
        count|first were folded into one plane -- pass ``folded``
        matching pack_flags) -> same tuple as finish_rollup; None when
        the batch's total group count overflows the pack, or
        (hierarchical packs) when any single row overflows row_cap."""
        n_per_seq = flat_np[:B]
        if row_cap > 0 and len(n_per_seq) \
                and int(n_per_seq.max(initial=0)) > row_cap:
            return None
        total = int(n_per_seq.sum())
        # size from the buffer, not `gcap`: the pack holds
        # min(gcap, B*(W*D+1)) entries
        pack = flat_np[B:].reshape(3 if folded else 4, -1)
        if total > pack.shape[1]:
            return None
        t = slice(0, total)
        if folded:
            return (n_per_seq, pack[0, t],
                    pack[1, t] >> ROW_FOLD_SHIFT,
                    pack[2, t].copy().view(np.float32),
                    pack[1, t] & ((1 << ROW_FOLD_SHIFT) - 1))
        return (n_per_seq, pack[0, t], pack[1, t],
                pack[2, t].copy().view(np.float32), pack[3, t])

    def pack_flags(self, L: int) -> tuple[bool, bool]:
        """D2H fold flags for a padded width L: (fold_calls -- the slim
        CALL pack ships (cnt<<18|fi, wt); fold_rows -- the global rollup
        pack ships (fam, cnt<<16|first, wt)).  The same arithmetic runs
        in score_family / rollup_from_fams on the batch's shape."""
        W = L - 8
        return (self._fi_fold_ok and (W + 1) < (1 << CALL_CNT_BITS),
                (W * self.fdb.d + 1) < (1 << ROW_FIT_BITS))

    def score_family_packed(self, offsets, lengths, params: EngineParams,
                            calls_per_seq_cap: int = 4,
                            fams_per_seq_cap: int | None = None,
                            slim_calls: bool = False, row_cap: int = 0):
        """Fused calls + family rollup (one probe).  Returns (calls_dev,
        call_cap, rows_dev, cap_seq, check) with both device buffers not
        yet read back; ``check.raise_if_bad()`` goes after their copy to
        the host.  calls_dev parses with DeviceScorer.unpack_dense
        (unpack_dense2/3 when slim_calls, per pack_flags), rows_dev with
        finish_rollup_rows (cap_seq >= 0; the returned cap_seq is the
        buffer's row width, min(cap, W*D+1)) or finish_rollup_global."""
        if fams_per_seq_cap is None:
            fams_per_seq_cap = self._default_cap
        call_cap = offsets.shape[0] * calls_per_seq_cap
        # the folded rows carry no avg_off plane, which order_constraint
        # scoring needs: take the two-gather path there
        use_fw = self.famwide is not None and not params.order_constraint
        fold_calls, _ = self.pack_flags(offsets.shape[1])
        m = self.metrics
        m.count("windows_padded", offsets.shape[0] * (offsets.shape[1] - K))
        with m.span("device_program"):
            calls_out, rows, check = score_family(
                self.ddb, self.fdb.fam, *self._upload(offsets, lengths),
                params, call_cap, fams_per_seq_cap, slim_calls, row_cap,
                (self.famwide, self.fam_w, self.fam_d) if use_fw else None,
                fold_calls and slim_calls)
        cap_seq = (rows.shape[1] - 1) // 4 if fams_per_seq_cap >= 0 \
            else fams_per_seq_cap
        return calls_out, call_cap, rows, cap_seq, check

    def _rollup(self, offsets: np.ndarray, lengths: np.ndarray,
                fams_per_seq_cap: int):
        """Returns (n_per_seq [B], fam, count, weight, first arrays
        concatenated in (sequence, family-id) order); ``first`` recovers
        the host path's first-hit order."""
        B = offsets.shape[0]
        out, capf, check = self.rollup_packed(offsets, lengths,
                                              fams_per_seq_cap)
        out = out.cpu().numpy()
        check.raise_if_bad()
        res = self.finish_rollup(out, B, capf)
        if res is None:
            self._default_cap = max(self._default_cap, fams_per_seq_cap * 4)
            return self._rollup(offsets, lengths, fams_per_seq_cap * 4)
        return res
