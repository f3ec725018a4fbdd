"""Device-resident /matrix pair counting, torch port of
``close_kmers_tpu/core/matrix.py``: the all-vs-all shared-kmer workload
as one device program per protein chunk.

The reference walks a ``map<pair<id,id>, int>`` per hit
(matrix_request.cc:130-161).  Here the whole count stays on the device:

  probe (the ``probe_select`` kernel on the payload-wide and sub-block
  tiers) -> matched DB row -> CSR degree/peg gathers (``max_deg``
  unrolled steps) -> registration-rank filter (rank[o] < rank[s]: protein
  s counts only pegs registered before it, never itself) -> pack (s_rank
  << PAIR_SHIFT | o_rank) -> one int32 sort -> run-length boundaries ->
  the compacted (pair, count) table, the only download.

The CSR gathers, the pair sort and the run-length stay torch, as XLA ran
them on the TPU.

Gates (the server's host walk answers otherwise): P <= 2^15 proteins (the
pair key packs into int32), unique peg ids, CSR max degree <= ``max_deg``,
peg-id space <= 2^22 and ``ddb.n`` <= 2^27.

Deliberate differences from the reference (ADVICE.md, high): nothing is
cached by ``id()``.  The rank array is uploaded on every request; the
row-aligned CSR and its device copy are cached against the mapping's
``peg_csr()`` tuple, held by reference and compared with ``is``; the
engine keeps one DeviceMatrix per mapping in a weak-keyed table
(``KmerEngine._device_matrix``), never as ``eng._device_matrix``.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import DeviceDB, device_db_of, encode_windows, probe_windows

PAIR_SHIFT = 15                 # ranks < 2^15; key = s << 15 | o
PAIR_SENTINEL = 1 << 30         # sorts after every real key


def _matrix_pairs(ddb: DeviceDB, offsets, lengths, rank0: int, peg_offs,
                  peg_vals, rank, max_deg: int, pair_cap: int):
    """One protein chunk of the matrix program (JAX
    ``_matrix_pairs_jit``).

    ``peg_offs`` must be padded to [n_db + 2] with its tail repeated so
    the miss row (idx = n_db) decodes as an empty peg range.  ``rank``
    maps peg id -> registration index (>= 2^15 for pegs that are not
    matrix proteins); ``rank0`` is this chunk's first registration index.
    Returns a packed [1 + 2 * pair_cap] int32 buffer: [n_pairs, keys...,
    counts...], the pad slots as JAX fills them; n_pairs > pair_cap means
    overflow (the caller retries with a bigger cap)."""
    B, _L = offsets.shape
    dev = offsets.device
    hi, lo, valid = encode_windows(offsets, lengths)
    found, _fi, _oi, _av, _wt, idx = probe_windows(ddb, hi, lo, valid)

    idxf = torch.where(found, idx, ddb.n).reshape(-1).long()     # [B*W]
    st = peg_offs[idxf]
    en = peg_offs[idxf + 1]
    srow = (rank0 + torch.arange(B, dtype=torch.int32, device=dev)
            ).repeat_interleave(hi.shape[1])
    n_rank = rank.shape[0]

    keys_parts = []
    for d in range(max_deg):
        has = st + d < en
        peg = peg_vals[torch.where(has, st + d, 0).long()]
        orank = rank[peg.clamp(0, n_rank - 1).long()]
        ok = has & (orank < srow)     # registered earlier, never self
        keys_parts.append(torch.where(
            ok, (srow << PAIR_SHIFT) | orank, PAIR_SENTINEL))
    sk = torch.sort(torch.cat(keys_parts)).values
    N = sk.shape[0]
    real = sk < PAIR_SENTINEL
    total = real.sum(dtype=torch.int32)
    change = torch.cat([real.new_ones(1), sk[1:] != sk[:-1]]) & real
    n_pairs = change.sum(dtype=torch.int32)
    # jnp.nonzero(size=pair_cap, fill_value=N): the first pair_cap
    # boundaries, padded with N
    bpos = torch.nonzero(change).reshape(-1)[:pair_cap].to(torch.int32)
    bpos = torch.cat([bpos, bpos.new_full((pair_cap - bpos.shape[0],), N)])
    ends = torch.cat([bpos[1:], bpos.new_full((1,), N)])
    counts = torch.minimum(ends, total) - torch.minimum(bpos, total)
    keys_out = sk[torch.clamp(bpos, max=N - 1).long()]
    return torch.cat([n_pairs[None], keys_out, counts])


def matrix_distance(eng, mapping, items):
    """Full-request device /matrix for the server handler: returns
    {(eid_s, eid_o): count} with handle_matrix's exact semantics, or None
    when a gate fails (the caller answers by the host walk).

    Gates: P <= 2^15 proteins, unique peg ids, CSR max degree <=
    DeviceMatrix.max_deg, peg-id space <= 2^22, and a signature DB small
    enough that the row-aligned CSR upload stays reasonable (n <= 2^27).
    The mapping's kmer->peg CSR is re-indexed onto signature-DB rows
    (mapping kmers absent from the signature DB can never be probe hits,
    matrix_request.cc:130-140) and staged by :meth:`DeviceMatrix.
    mapping_csr`.  Engine parameters change no probe hit, so they do not
    enter here."""
    ddb = eng.fa.ddb
    if ddb.n > (1 << 27):
        return None
    P = len(items)
    if not (0 < P <= (1 << PAIR_SHIFT)):
        return None
    eids = [mapping.encode_peg(sid) for sid, _ in items]
    if len(set(eids)) != P:
        return None
    _keys_m, offs_m, vals_m = mapping.peg_csr()
    n_rank = max(len(mapping.peg_to_id) + 1,
                 (int(vals_m.max()) + 1 if len(vals_m) else 1))
    if n_rank > (1 << 22):
        return None
    dm = eng._device_matrix(mapping)
    if len(offs_m) > 1 and dm.max_degree(offs_m) > dm.max_deg:
        return None
    po, pv = dm.mapping_csr(eng.db.keys, mapping)
    rank = np.full(n_rank, 1 << 20, dtype=np.int64)
    rank[np.asarray(eids)] = np.arange(P)
    offsets, lengths = eng.fa.pad_batch([s for _, s in items])
    pairs = dm.count_pairs(offsets, lengths, po, pv, rank)
    return {(eids[s], eids[o]): c for (s, o), c in pairs.items()}


class DeviceMatrix:
    """Batched /matrix pair counting on the device.

    ``count_pairs(offsets, lengths, *stage_csr(peg_offs, peg_vals),
    rank)`` returns {(s_rank, o_rank): count} with the reference's
    registration-order semantics; proteins are ranked by their row order
    (the caller registers them in arrival order, matrix_request.cc:83-95).

    It probes ``device_db_of(db_or_engine, device)``'s table."""

    CHUNK = 2048

    def __init__(self, db_or_engine, max_deg: int = 8, device="cuda"):
        self.ddb = device_db_of(db_or_engine, device)
        self.device = self.ddb.payload.device
        self.max_deg = max_deg
        self._csr = None    # (the mapping's peg_csr() tuple, staged CSR)

    def stage_csr(self, peg_offs: np.ndarray, peg_vals: np.ndarray):
        """The CSR as the device program reads it: (peg_offs padded to
        n_db + 2 so the miss row decodes empty, peg_vals), int32 tensors
        on the device.  Raises ValueError when the offsets pass int32."""
        n_db = self.ddb.n
        po = np.asarray(peg_offs)
        if po.dtype != np.int32:
            if po[-1] >= 2**31:
                raise ValueError("CSR too large for int32 offsets")
            po = po.astype(np.int32)
        pad = np.full(n_db + 2 - len(po), po[-1], dtype=np.int32)
        po = np.concatenate([po, pad])
        pv = np.asarray(peg_vals).astype(np.int32)
        if len(pv) == 0:
            pv = np.zeros(1, dtype=np.int32)
        return (torch.from_numpy(po).to(self.device),
                torch.from_numpy(pv).to(self.device))

    def mapping_csr(self, db_keys: np.ndarray, mapping):
        """``mapping``'s kmer->peg CSR re-indexed onto the DB's rows and
        staged (:meth:`stage_csr`), cached against the mapping's
        ``peg_csr()`` tuple: every ``add_peg_mapping`` makes a new one."""
        csr = mapping.peg_csr()
        if self._csr is not None and self._csr[0] is csr:
            return self._csr[1]
        staged = self.stage_csr(*self.align_csr_to_db(db_keys, *csr))
        self._csr = (csr, staged)
        return staged

    def max_degree(self, peg_offs: np.ndarray) -> int:
        d = np.diff(peg_offs)
        return int(d.max()) if len(d) else 0

    @staticmethod
    def align_csr_to_db(db_keys: np.ndarray, csr_keys: np.ndarray,
                        csr_offs: np.ndarray, csr_vals: np.ndarray):
        """Re-index a kmer-keyed CSR onto signature-DB row numbers
        (probe_windows returns DB rows, not kmer codes).  Mapping kmers
        absent from the DB are dropped: they can never be hits.
        ``csr_keys`` must be sorted (KmerFamilyMapping._to_csr emits
        sorted keys)."""
        n_db = len(db_keys)
        deg = np.diff(csr_offs)
        row_deg = np.zeros(n_db, dtype=np.int64)
        if len(csr_keys):
            rows = np.searchsorted(db_keys, csr_keys)
            rows_c = np.minimum(rows, n_db - 1)
            ok = (rows < n_db) & (db_keys[rows_c] == csr_keys)
            row_deg[rows_c[ok]] = deg[ok]
            vals_db = np.asarray(csr_vals)[np.repeat(ok, deg)]
        else:
            vals_db = np.zeros(0, dtype=np.int64)
        offs_db = np.zeros(n_db + 1, dtype=np.int64)
        np.cumsum(row_deg, out=offs_db[1:])
        return offs_db, vals_db

    def count_pairs(self, offsets: np.ndarray, lengths: np.ndarray,
                    peg_offs: torch.Tensor, peg_vals: torch.Tensor,
                    rank: np.ndarray, pair_cap: int = 32768):
        """Returns {(s_rank, o_rank): count} over all chunks.  The CSR is
        :meth:`stage_csr`'s tensors; ``rank`` is uploaded on every call.
        A chunk whose pairs overflow ``pair_cap`` reruns the whole
        request with 4x the cap."""
        P = offsets.shape[0]
        if P > (1 << PAIR_SHIFT):
            raise ValueError(f"P={P} exceeds the int32 pair-key gate")
        rk = torch.from_numpy(np.asarray(rank).astype(np.int32)).to(
            self.device)
        outs = []
        for a in range(0, P, self.CHUNK):
            chunk = offsets[a:a + self.CHUNK]
            lens = lengths[a:a + self.CHUNK]
            if len(chunk) < self.CHUNK:   # pad to one shape
                padn = self.CHUNK - len(chunk)
                chunk = np.concatenate(
                    [chunk, np.full((padn, chunk.shape[1]), 20, np.uint8)])
                lens = np.concatenate(
                    [lens, np.zeros(padn, dtype=lens.dtype)])
            outs.append(_matrix_pairs(
                self.ddb, torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(
                    lens, dtype=np.int32)).to(self.device),
                a, peg_offs, peg_vals, rk, self.max_deg, pair_cap))
        pairs: dict[tuple[int, int], int] = {}
        for out in outs:
            buf = out.cpu().numpy()
            n_pairs = int(buf[0])
            if n_pairs > pair_cap:
                return self.count_pairs(offsets, lengths, peg_offs,
                                        peg_vals, rank, pair_cap * 4)
            keys = buf[1:1 + n_pairs]
            counts = buf[1 + pair_cap:1 + pair_cap + n_pairs]
            for k, c in zip(keys.tolist(), counts.tolist()):
                pairs[(k >> PAIR_SHIFT, k & ((1 << PAIR_SHIFT) - 1))] = c
        return pairs
