"""Multi-device sharding, torch port of ``close_kmers_tpu/parallel/
sharding.py``: the signature DB range-sharded across a ("data", "table")
mesh, probed shard by shard and merged by collectives over "table".

The design is the JAX module's:

* batch rows are data-parallel over ``data``; the DB's sorted key space
  is split into contiguous **bucket-aligned hi ranges** over ``table``,
  so that each shard keeps a single-device layout over its own hi span:
  the binary search, the card's tier, or under the JAX module's gates
  its payload-wide rows or sub-bucket blocks;
* the replicated probe: each entry probes its data row's batch against
  its table shard; every key lives in exactly one shard, so a ``psum``
  over ``table`` of the zero-masked payloads merges the shards;
* the kmer->family table shards by the same row ranges
  (:func:`shard_fam_table`), and the family rows merge the same way;
* the routed probe: the batch splits over both axes; each entry sorts its
  windows by owning shard, ships them with one ``all_to_all``, probes
  only the windows it owns and ships the results back; windows past the
  static per-(source, destination) capacity take an exact ``all_gather``
  + ``psum`` fallback, and windows past both capacities are dropped and
  counted;
* :func:`serve_step_sharded`: either probe, then the run/gap/two-hit
  scan (``scan_score``), the best-call pack (``best_call``) and, with
  family rows, the family rollup (``row_gather``, ``family_group``).

JAX runs that as one SPMD program under ``shard_map``.  Here the
per-device program is written once, as stages on each mesh entry's
tensors, and :class:`Mesh` runs the collectives between the stages over
the entries of each data row.  A mesh held by one process
(:func:`make_mesh`) runs them as tensor copies and sums across its
entries' devices; its device list may repeat a device (``[cpu] * 8`` in
the tests, ``[cuda:0] * 4`` on one card), where JAX uses virtual
devices, and the exchange between table shards is then device-local
copies.  A mesh from ``multihost.pod_mesh`` carries a torch.distributed
process group instead: each process owns one entry, its rank's, and the
collectives are ``all_reduce``, ``all_to_all_single`` and an all-gather
on its data row's group (NCCL on cards, gloo on the CPU).

Outputs are global arrays in the row order of JAX's: a ``P("data")``
split concatenates the data rows' blocks, ``P(("data", "table"))`` the
entries' blocks data-major, and the per-device counters follow mesh
order.  They land on the caller's entry device: entry (0, 0)'s for a
one-process mesh; in a multi-process mesh every process gets the whole
array on its own entry's device.

Left out: ``engine._probe_count_pad``, which only padded the TPU's
gather and changes no value.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch
import torch.distributed as dist

from ..db.signature_db import SignatureDB
from ..params import HI_CARD, LO_CARD, EngineParams
from ..core import engine as E
from ..core.engine import DeviceDB, encode_windows, probe_windows
from ..utils.device import resolve_device


class Mesh:
    """An [n_data, n_table] grid of mesh entries, each a torch.device.

    ``devices[d][t]`` is entry (d, t)'s device.  Without ``rank`` this
    process holds every entry.  With ``rank`` (a multi-process mesh) it
    owns only entry ``divmod(rank, n_table)``, the other entries' devices
    are None, and ``row_group`` is the torch.distributed group of its
    data row (None: the default group)."""

    def __init__(self, devices, rank: int | None = None, row_group=None):
        self.devices = [list(row) for row in devices]
        n_data, n_table = len(self.devices), len(self.devices[0])
        self.shape = {"data": n_data, "table": n_table}
        self.rank = rank
        self.row_group = row_group
        self.entries = ([(d, t) for d in range(n_data)
                         for t in range(n_table)] if rank is None
                        else [divmod(rank, n_table)])

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def device(self, e) -> torch.device:
        return self.devices[e[0]][e[1]]

    def block(self, e, split: str) -> int:
        """Entry ``e``'s block of rows under a ``split`` of "data" (its
        data row's) or "both" (its own, data-major)."""
        return e[0] if split == "data" else e[0] * self.shape["table"] + e[1]

    def n_blocks(self, split: str) -> int:
        n = self.shape["data"]
        return n if split == "data" else n * self.shape["table"]

    def scatter(self, arr: np.ndarray, split: str) -> dict:
        """Each local entry's block of ``arr``'s rows on its device; one
        upload per (block, device)."""
        nb = self.n_blocks(split)
        if arr.shape[0] % nb:
            raise ValueError(f"{arr.shape[0]} batch rows do not divide "
                             f"into {nb} blocks of the mesh")
        rows = arr.shape[0] // nb
        placed, out = {}, {}
        for e in self.entries:
            b = self.block(e, split)
            key = (b, self.device(e))
            if key not in placed:
                placed[key] = torch.from_numpy(np.ascontiguousarray(
                    arr[b * rows:(b + 1) * rows])).to(self.device(e))
            out[e] = placed[key]
        return out

    def _row(self, d):
        return [(d, t) for t in range(self.shape["table"])]

    def psum(self, xs: dict) -> dict:
        """The elementwise sum over each data row's S tensors, on each
        entry's device."""
        if self.distributed:
            (e, x), = xs.items()
            x = x.clone()
            dist.all_reduce(x, group=self.row_group)
            return {e: x}
        out = {}
        for d in range(self.shape["data"]):
            row = self._row(d)
            tot = xs[row[0]].clone()
            for e in row[1:]:
                tot += xs[e].to(tot.device)
            for e in row:
                out[e] = tot.to(self.device(e))
        return out

    def all_to_all(self, xs: dict) -> dict:
        """Tiled on axis 0: each entry's [S * c, ...] tensor is S chunks;
        chunk s of source t lands as chunk t at destination s."""
        S = self.shape["table"]
        if self.distributed:
            (e, x), = xs.items()
            x = x.contiguous()
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.row_group)
            return {e: out}
        out = {}
        for d in range(self.shape["data"]):
            row = self._row(d)
            parts = {e: xs[e].reshape(S, -1, *xs[e].shape[1:]) for e in row}
            for s, dst in enumerate(row):
                out[dst] = torch.cat([parts[src][s].to(self.device(dst))
                                      for src in row])
        return out

    def all_gather(self, xs: dict) -> dict:
        """[S, ...]: each data row's S tensors stacked in table order, on
        each entry's device."""
        S = self.shape["table"]
        if self.distributed:
            (e, x), = xs.items()
            x = x.contiguous()
            out = x.new_empty((S * x.shape[0],) + x.shape[1:])
            _all_gather(out, x, self.row_group)
            return {e: out.reshape(S, *x.shape)}
        out = {}
        for d in range(self.shape["data"]):
            row = self._row(d)
            for dst in row:
                out[dst] = torch.stack([xs[src].to(self.device(dst))
                                        for src in row])
        return out

    def home(self, outs: dict, split: str) -> torch.Tensor:
        """The global array of the per-entry ``outs`` under ``split``
        ("data": replicated over table, one block a data row; "both": one
        block an entry), on the caller's entry device."""
        if not self.distributed:
            dev = self.device((0, 0))
            keys = ([(d, 0) for d in range(self.shape["data"])]
                    if split == "data" else self.entries)
            return torch.cat([outs[e].to(dev) for e in keys])
        (e, x), = outs.items()
        x = x.contiguous()
        world = self.shape["data"] * self.shape["table"]
        buf = x.new_empty((world * x.shape[0],) + x.shape[1:])
        _all_gather(buf, x, None)
        if split == "data":
            buf = buf.reshape(self.shape["data"], self.shape["table"],
                              *x.shape)[:, 0].reshape(-1, *x.shape[1:])
        return buf


def _all_gather(out, x, group) -> None:
    """``out`` [world * n, ...] = every rank's ``x`` [n, ...] in rank
    order, by the collective this torch names (``all_gather_single``
    where it has one, else ``all_gather_into_tensor``)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def make_mesh(n_data: int | None = None, n_table: int | None = None,
              devices=None) -> Mesh:
    """A ("data", "table") mesh held by this process.

    ``devices``: the entries' devices in mesh order (a device may repeat:
    several entries on one card, or on the CPU); then n_data * n_table
    must equal their count.  Default: the first n_data * n_table visible
    cards, and it raises when the machine has fewer (never the CPU).
    With neither size given every device goes on "table"."""
    explicit = devices is not None
    if explicit:
        devices = [resolve_device(d) for d in devices]
    else:
        n_cards = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    n = len(devices)
    if n_data is None and n_table is None:
        n_data, n_table = 1, n
    elif n_data is None:
        n_data = n // n_table
    elif n_table is None:
        n_table = n // n_data
    need = n_data * n_table
    if need < 1 or need > n or (explicit and need != n):
        raise RuntimeError(
            f"a {n_data} x {n_table} mesh needs {need} devices; "
            + (f"{n} were given" if explicit else
               f"this machine has {n} CUDA card(s)"))
    return Mesh([devices[d * n_table:(d + 1) * n_table]
                 for d in range(n_data)])


def _hi_range_bounds(db: SignatureDB, S: int) -> np.ndarray:
    """Bucket-aligned shard boundaries: S+1 hi values splitting the key
    space into contiguous ranges of ~equal key counts."""
    n = len(db)
    bs = db.bucket_start
    targets = (np.arange(1, S, dtype=np.int64) * n) // S
    mids = np.searchsorted(bs, targets, side="left").astype(np.int64)
    return np.concatenate([[0], mids, [HI_CARD]])


class Sharded:
    """A [S, ...] array split over the mesh's "table" axis: each local
    entry (d, t) holds part t on its device.  Entries that share a device
    share one copy of a part."""

    def __init__(self, parts: dict, shape: tuple):
        self.parts = parts
        self.shape = tuple(shape)

    @classmethod
    def place(cls, arr: np.ndarray, mesh: Mesh) -> "Sharded":
        arr = np.asarray(arr)
        if arr.dtype != np.int32:
            raise TypeError(f"sharded tables are int32, not {arr.dtype}")
        if arr.shape[0] != mesh.shape["table"]:
            raise ValueError(f"{arr.shape[0]} shards for a mesh of "
                             f"{mesh.shape['table']} table entries")
        placed, parts = {}, {}
        for e in mesh.entries:
            key = (e[1], mesh.device(e))
            if key not in placed:
                part = np.ascontiguousarray(arr[e[1]])
                if not part.flags.writeable:     # e.g. a JAX array's view
                    part = part.copy()
                placed[key] = torch.from_numpy(part).to(mesh.device(e))
            parts[e] = placed[key]
        return cls(parts, arr.shape)

    def numpy(self) -> np.ndarray:
        """The [S, ...] array from the local parts (every shard must be
        local: a one-process mesh)."""
        by_t = {e[1]: p for e, p in self.parts.items()}
        return np.stack([by_t[t].cpu().numpy()
                         for t in range(self.shape[0])])


@dataclasses.dataclass
class ShardedDB:
    """Signature DB split into ``S`` contiguous bucket-aligned key ranges,
    padded to equal length M, as [S, ...] arrays sharded over "table".
    Each shard binary-searches its local rows (the card's tier,
    ``engine.CARD_TIER``).  Under the JAX module's per-shard gates
    (:meth:`from_db` with ``jax_layouts`` or ``wide_payload``), where the
    single-device JAX engine would take the payload-wide layout, each
    shard carries its own wide rows over just its hi range ([S, Hmax,
    1+5W], local-hi indexed via ``hi_base``); where buckets are too deep
    for wide rows, its own sub-bucket blocks (local hi and local row
    ids); else the binary search."""

    bucket_pair: Sharded     # i32[S, HI_CARD, 2] (bounds into local rows)
    lo: Sharded              # i32[S, M+1]
    payload: Sharded         # i32[S, M+1, 4]
    hi_base: Sharded         # i32[S, 1] first hi value of each shard
    n_steps: int
    m: int                   # max rows per shard (excluding the pad row)
    n_shards: int
    mesh: Mesh
    payload_wide: Sharded | None = None    # i32[S, Hmax, lane_pad(1+5W)]
    row_base: np.ndarray | None = None     # i64[S+1] global row offsets
    wide_w: int = 0
    sub_header: Sharded | None = None      # i32[S, Hmax, SUB]
    sub_blocks: Sharded | None = None      # i32[S, NBmax+1, lane_pad(...)]
    sub_w: int = 0
    h_bounds: np.ndarray | None = None     # i64[S+1] shard hi boundaries

    ARRAYS = ("bucket_pair", "lo", "payload", "hi_base", "payload_wide",
              "sub_header", "sub_blocks")

    def __post_init__(self):
        # each local entry's shard as a port DeviceDB with n = m: the
        # probe tiers then run on it unchanged; and the shard bounds on
        # its device, for the routed probe's owner map
        self.local, self.bounds = {}, {}
        h_bounds = torch.from_numpy(self.h_bounds.astype(np.int32))
        for e in self.mesh.entries:
            self.bounds[e] = h_bounds.to(self.mesh.device(e))
            part = {k: (getattr(self, k).parts[e]
                        if getattr(self, k) is not None else None)
                    for k in self.ARRAYS}
            self.local[e] = DeviceDB(
                part["bucket_pair"], part["lo"], part["payload"],
                self.n_steps, self.m, payload_wide=part["payload_wide"],
                wide_w=self.wide_w, sub_header=part["sub_header"],
                sub_blocks=part["sub_blocks"], sub_w=self.sub_w)

    # Copied from close_kmers_tpu/parallel/sharding.py::ShardedDB.from_db
    # (the numpy table build), then placed on the mesh.
    @classmethod
    def from_db(cls, db: SignatureDB, mesh: Mesh,
                wide_payload: bool | None = None,
                jax_layouts: bool = False) -> "ShardedDB":
        """``db`` range-sharded over ``mesh``'s table axis.  With no flags
        every shard takes the binary search, the card's tier (PERF.md §6,
        "per-shard tier"; the single card's ``CARD_TIER``).
        ``jax_layouts=True`` builds the JAX module's per-shard choice
        (payload-wide rows, else sub-bucket blocks, else the binary
        search, under its v5e gates), and ``wide_payload`` forces its
        wide rows on or off within that choice; the tables then equal
        the JAX ``ShardedDB``'s."""
        S = mesh.shape["table"]
        n = len(db)
        bs = db.bucket_start
        h_bounds = _hi_range_bounds(db, S)
        row_base = bs[h_bounds].astype(np.int64)
        m = max(1, int(np.max(row_base[1:] - row_base[:-1]))) if n else 1
        Hmax = max(1, int(np.max(h_bounds[1:] - h_bounds[:-1])))

        WIDE = max(1, int(db.max_bucket))
        jax_layouts = jax_layouts or wide_payload is not None
        if not jax_layouts:
            wide_payload = False
        elif wide_payload is None:
            wide_payload = (
                n > 0 and 0 < db.max_bucket <= E.WIDE_BUCKET_MAX
                and S * Hmax * (1 + 5 * WIDE) * 4
                <= S * E.WIDE_PAYLOAD_MAX_BYTES)

        bp = np.zeros((S, HI_CARD, 2), dtype=np.int32)
        lo = np.full((S, m + 1), -1, dtype=np.int32)
        payload = np.zeros((S, m + 1, 4), dtype=np.int32)
        payload[:, :, 0] = -1
        payload[:, :, 1] = -1
        pw = None
        if wide_payload:
            row_w = E._lane_pad(1 + 5 * WIDE)
            pw = np.zeros((S, Hmax, row_w), dtype=np.int32)
            pw[:, :, 1:1 + WIDE] = E.LO_SENTINEL
        max_bucket = 0
        planes = (db.lo, db.fi, db.oi, db.avg_off, db.wt.view(np.int32))
        for s in range(S):
            a, b = int(row_base[s]), int(row_base[s + 1])
            cnt = b - a
            # bucket bounds remapped to local rows; out-of-range buckets
            # become empty (start == end after the clip)
            loc = np.clip(bs - a, 0, cnt).astype(np.int32)
            bp[s, :, 0] = loc[:-1]
            bp[s, :, 1] = loc[1:]
            if cnt:
                lo[s, :cnt] = db.lo[a:b]
                payload[s, :cnt, 0] = db.fi[a:b]
                payload[s, :cnt, 1] = db.oi[a:b]
                payload[s, :cnt, 2] = db.avg_off[a:b]
                payload[s, :cnt, 3] = db.wt[a:b].view(np.int32)
                h0, h1 = int(h_bounds[s]), int(h_bounds[s + 1])
                starts_l = (bs[h0:h1] - a).astype(np.int64)
                counts_l = bs[h0 + 1:h1 + 1] - bs[h0:h1]
                max_bucket = max(max_bucket, int(counts_l.max(initial=0)))
                if pw is not None:
                    pw[s, :h1 - h0, 0] = starts_l
                    for j in range(WIDE):
                        mk = counts_l > j
                        rows = a + starts_l[mk] + j
                        for p, plane in enumerate(planes):
                            pw[s, :h1 - h0][mk, 1 + p * WIDE + j] = \
                                plane[rows]
        n_steps = max(1, math.ceil(math.log2(max_bucket + 1))) \
            if max_bucket else 1
        hi_base = h_bounds[:-1].astype(np.int32).reshape(S, 1)

        sub_h = sub_b = None
        sub_w = 0
        if jax_layouts and pw is None and n:
            sub_h, sub_b, sub_w = cls._build_sub(db, S, h_bounds, row_base,
                                                 Hmax)
        return cls.from_numpy(dict(
            bucket_pair=bp, lo=lo, payload=payload, hi_base=hi_base,
            payload_wide=pw, sub_header=sub_h, sub_blocks=sub_b,
            n_steps=n_steps, m=m, wide_w=WIDE if pw is not None else 0,
            sub_w=sub_w, row_base=row_base, h_bounds=h_bounds), mesh)

    # Copied from close_kmers_tpu/parallel/sharding.py (pure numpy).
    @staticmethod
    def _build_sub(db: SignatureDB, S, h_bounds, row_base, Hmax):
        """Per-shard sub-bucket layout (engine.DeviceDB.from_db's deep
        path with local hi and local block starts), padded to uniform
        [S, ...] shapes.  Returns (header [S, Hmax, SUB],
        blocks [S, NBmax+1, 1+5*max_sub (+pad)], max_sub) or
        (None, None, 0) if gated."""
        SUB = E.SUB
        shift = (LO_CARD - 1).bit_length() - (SUB.bit_length() - 1)
        skey = db.hi.astype(np.int64) * SUB + (db.lo >> shift)
        per = []
        max_sub = 0
        nb_max = 0
        for s in range(S):
            a, b = int(row_base[s]), int(row_base[s + 1])
            uk, us, uc = np.unique(skey[a:b], return_index=True,
                                   return_counts=True)
            per.append((uk, us, uc, a))
            if len(uc):
                max_sub = max(max_sub, int(uc.max()))
            nb_max = max(nb_max, len(uk))
        if max_sub == 0 or max_sub > E.SUB_BUCKET_MAX:
            return None, None, 0
        row_w = E._lane_pad(1 + 5 * max_sub)
        if S * (nb_max + 1) * row_w * 4 > S * E.SUB_MAX_BYTES:
            return None, None, 0
        header = np.full((S, Hmax, SUB), nb_max, dtype=np.int32)
        blocks = np.zeros((S, nb_max + 1, row_w), dtype=np.int32)
        blocks[:, :, 1:1 + max_sub] = E.LO_SENTINEL
        planes = (db.lo, db.fi, db.oi, db.avg_off, db.wt.view(np.int32))
        for s, (uk, us, uc, a) in enumerate(per):
            nb = len(uk)
            m_loc = int(row_base[s + 1] - row_base[s])
            blocks[s, :, 0] = m_loc           # miss/pad rows -> local miss
            if not nb:
                continue
            blocks[s, :nb, 0] = us            # local start (us is local)
            h0 = int(h_bounds[s])
            header[s, (uk // SUB).astype(np.int64) - h0, uk % SUB] = \
                np.arange(nb, dtype=np.int32)
            for j in range(max_sub):
                mk = uc > j
                rows = a + us[mk] + j
                for p, plane in enumerate(planes):
                    blocks[s, :nb][mk, 1 + p * max_sub + j] = plane[rows]
        return header, blocks, max_sub

    @classmethod
    def from_numpy(cls, fields: dict, mesh: Mesh) -> "ShardedDB":
        """A ShardedDB placed on ``mesh`` from numpy arrays: the state
        carry-over from the JAX ``ShardedDB`` (``np.asarray`` of each of
        its :attr:`ARRAYS`, None where the JAX field is None) plus its
        ``n_steps``, ``m``, ``wide_w``, ``sub_w``, ``row_base`` and
        ``h_bounds``."""
        arrays = {k: (Sharded.place(fields[k], mesh)
                      if fields.get(k) is not None else None)
                  for k in cls.ARRAYS}
        for k in ("bucket_pair", "lo", "payload", "hi_base"):
            if arrays[k] is None:
                raise KeyError(f"ShardedDB field {k} is required")
        return cls(**arrays, n_steps=int(fields["n_steps"]),
                   m=int(fields["m"]), n_shards=mesh.shape["table"],
                   mesh=mesh, row_base=np.asarray(fields["row_base"]),
                   wide_w=int(fields.get("wide_w", 0)),
                   sub_w=int(fields.get("sub_w", 0)),
                   h_bounds=np.asarray(fields["h_bounds"]))

def _probe_local_windows(sdb: ShardedDB, e, hi_q, lo_q, valid):
    """Probe encoded windows (any shape) against entry ``e``'s table
    shard.  Returns probe_windows' (found, fi, oi, avg_off, wt, idx): the
    found rows are the shard's, everything outside its key range misses,
    and idx is the local row (m = miss)."""
    ddb = sdb.local[e]
    table = ddb.payload_wide if ddb.payload_wide is not None \
        else ddb.sub_header
    if table is None:
        return probe_windows(ddb, hi_q, lo_q, valid)
    # shard-local hi-indexed layout: localize hi and mask the range
    H = table.shape[0]
    hi_loc = hi_q - int(sdb.h_bounds[e[1]])
    in_r = (hi_loc >= 0) & (hi_loc < H)
    return probe_windows(ddb, hi_loc.clamp(0, H - 1), lo_q, valid & in_r)


def _merge_probe(mesh: Mesh, local: dict) -> dict:
    """psum-merge each entry's (found, fi, oi, avg_off, wt) probe planes
    over table (each key lives in exactly one shard, so masked sums
    rebuild the single-device fields).  Returns {entry: (found as int32,
    fi, oi, avg_off, wt)}; misses read 0."""
    planes = [mesh.psum({e: p[0].to(torch.int32) for e, p in local.items()})]
    for j, zero in ((1, 0), (2, 0), (3, 0), (4, 0.0)):
        planes.append(mesh.psum({e: torch.where(p[0], p[j], zero)
                                 for e, p in local.items()}))
    return {e: tuple(pl[e] for pl in planes) for e in local}


def _windows(mesh: Mesh, offsets, lengths, split: str) -> dict:
    """Each local entry's block of the batch, encoded: {entry: (hi, lo,
    valid)}."""
    off = mesh.scatter(np.asarray(offsets, dtype=np.uint8), split)
    lens = mesh.scatter(np.asarray(lengths, dtype=np.int32), split)
    return {e: encode_windows(off[e], lens[e]) for e in mesh.entries}


def probe_sharded(sdb: ShardedDB, offsets, lengths):
    """Probe a [B, L] batch against the sharded DB (replicated over
    table, merged by psum).  Returns (found, fi, oi, avg_off, wt, hi, lo)
    with found as int32 0/1 and the miss values 0; batch rows must be
    divisible by the data axis size."""
    mesh = sdb.mesh
    win = _windows(mesh, offsets, lengths, "data")
    local = {e: _probe_local_windows(sdb, e, *w)[:5] for e, w in win.items()}
    merged = _merge_probe(mesh, local)
    outs = [{e: merged[e][j] for e in mesh.entries} for j in range(5)]
    outs += [{e: win[e][j] for e in mesh.entries} for j in (0, 1)]
    return tuple(mesh.home(o, "data") for o in outs)


def shard_fam_table(fam_np: np.ndarray, sdb: ShardedDB) -> Sharded:
    """Split a [N+1, D] kmer->family table (device_family.DeviceFamilyDB
    layout: row i = families of DB row i, -1 padded, last row = miss) by
    the ShardedDB's row ranges into [S, M+1, D] sharded over "table"."""
    S, m = sdb.n_shards, sdb.m
    D = fam_np.shape[1]
    out = np.full((S, m + 1, D), -1, dtype=np.int32)
    rb = sdb.row_base
    for s in range(S):
        a, b = int(rb[s]), int(rb[s + 1])
        if b > a:
            out[s, :b - a] = fam_np[a:b]
    return Sharded.place(out, sdb.mesh)


def _probe_planes(sdb: ShardedDB, e, p_hi, p_lo, fam_tab, checks: list):
    """Probe flat windows on entry ``e``'s shard (hi < 0: a pad slot);
    returns [N, P] int32 planes (fi + 1, oi, avg_off, wt-bits[, fam_j +
    1 ...]), 0 on a miss, so that sums over shards merge them."""
    from ..core.device_family import _gather_fams
    p_hi, p_lo = p_hi.reshape(1, -1), p_lo.reshape(1, -1)
    fnd, fi, oi, av, wt, idx = _probe_local_windows(sdb, e, p_hi, p_lo,
                                                    p_hi >= 0)
    planes = [torch.where(fnd, fi + 1, 0), torch.where(fnd, oi, 0),
              torch.where(fnd, av, 0),
              torch.where(fnd, wt.view(torch.int32), 0)]
    if fam_tab is not None:
        fams, check = _gather_fams(fam_tab.parts[e], idx)     # [1, N, D]
        checks.append(check)
        planes += [torch.where(fnd, fams[..., j] + 1, 0)
                   for j in range(fams.shape[-1])]
    return torch.stack([p.reshape(-1) for p in planes], dim=-1)


@dataclasses.dataclass
class _Route:
    """One entry's windows in owner order (the routed probe's state)."""
    perm: torch.Tensor       # i64[Nw]: sorted position -> window
    s_owner: torch.Tensor    # i32[Nw]: owning shard, S = invalid
    s_hi: torch.Tensor
    s_lo: torch.Tensor
    start: torch.Tensor      # i32[S+1]: each shard's first sorted slot
    rank: torch.Tensor       # i32[Nw]: slot within the owner's segment


def _route_send(hi_q, lo_q, valid, bounds, S: int, cap: int):
    """Stage 1 of the routed probe on one entry: the owner map, the
    stable owner sort and the [S * cap, 2] send buffer (contiguous
    copies of the owner-sorted stream, rows past a destination's count
    -1).  Returns (route state, send)."""
    dev = hi_q.device
    i32 = torch.int32
    Nw = hi_q.numel()
    hif = torch.where(valid, hi_q, 0).reshape(-1)
    lof = torch.where(valid, lo_q, -2).reshape(-1)
    vf = valid.reshape(-1)
    # owning table shard of each window, S = invalid (never routed): a
    # broadcast compare-sum over the S-1 inner bounds (the JAX module's
    # choice over searchsorted); bounds[0] <= every valid hi
    owner = (hif[:, None] >= bounds[None, 1:S]).sum(dim=1, dtype=i32)
    owner = torch.where(vf, owner.clamp(0, S - 1), S)
    s_owner, perm = torch.sort(owner, stable=True)
    s_hi, s_lo = hif[perm], lof[perm]
    start = torch.searchsorted(
        s_owner, torch.arange(S + 1, dtype=i32, device=dev)).to(i32)
    iota = torch.arange(Nw, dtype=i32, device=dev)
    rank = iota - start[s_owner.clamp(max=S - 1).long()]
    # the sorted stream is contiguous per destination: each destination's
    # [cap] rows are one slice of it (device index arithmetic, no host
    # read), rows past its count masked to -1; cap rows of slack keep
    # every slice inside the buffer
    sorted2 = torch.cat([torch.stack([s_hi, s_lo], dim=-1),
                         torch.full((cap, 2), -1, dtype=i32, device=dev)])
    r = torch.arange(cap, dtype=i32, device=dev)
    rows = sorted2[(start[:S, None] + r[None, :]).long()]     # [S, cap, 2]
    keep = r[None, :] < (start[1:] - start[:-1])[:, None]
    send = torch.where(keep[..., None], rows, -1)
    return _Route(perm, s_owner, s_hi, s_lo, start, rank), \
        send.reshape(S * cap, 2)


def _routed_probe_core(sdb: ShardedDB, fam_tab, win: dict, cap: int,
                       ov_cap: int, checks: list) -> dict:
    """The routed probe over every local entry's windows ``win`` {entry:
    (hi, lo, valid)}: one all_to_all each way, probing only owned
    windows, with the exact all_gather + psum fallback for windows past
    ``cap`` (at most ``ov_cap`` a source; the rest drop).

    Returns {entry: (found, fi, oi, av, wt, fams | None, n_overflow,
    n_dropped)}: planes shaped like the entry's hi (misses: fi, oi, av 0,
    wt 0.0, fams -1), the counts as [1] vectors."""
    mesh = sdb.mesh
    S = mesh.shape["table"]
    i32 = torch.int32
    route, send = {}, {}
    for e, (hi_q, lo_q, valid) in win.items():
        route[e], send[e] = _route_send(hi_q, lo_q, valid, sdb.bounds[e],
                                        S, cap)
    recv = mesh.all_to_all(send)
    back = {e: _probe_planes(sdb, e, r[:, 0], r[:, 1], fam_tab, checks)
            for e, r in recv.items()}
    ret = mesh.all_to_all(back)

    ov, res, ovs = {}, {}, {}
    for e, rt in route.items():
        Nw = rt.s_owner.numel()
        P_ = ret[e].shape[-1]
        dev = rt.s_owner.device
        # results land back in sorted order by the mirrored contiguous
        # copies, in ascending s: a shorter segment's pad rows overlap the
        # next segment and are overwritten by it; overflow positions (rank
        # >= cap) are touched by no copy and keep 0
        ret_s = ret[e].reshape(S, cap, P_)
        buf = torch.zeros((Nw + cap, P_), dtype=i32, device=dev)
        r = torch.arange(cap, device=dev)
        for s in range(S):
            buf.index_copy_(0, rt.start[s].long() + r, ret_s[s])
        res[e] = buf[:Nw]
        # windows past the per-pair capacity: compacted into ov_cap slots
        ovf = (rt.s_owner < S) & (rt.rank >= cap)
        ov_rank = torch.cumsum(ovf.to(i32), 0, dtype=i32) - 1
        in_ov = ovf & (ov_rank < ov_cap)
        ov_slot = torch.where(in_ov, ov_rank, ov_cap).long()
        slots = torch.empty((ov_cap + 1, 2), dtype=i32, device=dev)
        slots[:, 0], slots[:, 1] = -1, -2
        slots[ov_slot] = torch.stack([rt.s_hi, rt.s_lo], dim=-1)
        ov[e] = slots[:ov_cap]
        ovs[e] = (ovf, in_ov, ov_slot)
    g = mesh.all_gather(ov)
    gplanes = {e: _probe_planes(sdb, e, x[..., 0], x[..., 1], fam_tab,
                                checks).reshape(S, ov_cap, -1)
               for e, x in g.items()}
    merged = mesh.psum(gplanes)

    out = {}
    for e, rt in route.items():
        ovf, in_ov, ov_slot = ovs[e]
        mine = merged[e][e[1]]                             # [ov_cap, P]
        ov_res = torch.where(in_ov[:, None],
                             mine[ov_slot.clamp(max=ov_cap - 1)], 0)
        res_sorted = torch.where(ovf[:, None], ov_res, res[e])
        # unsort by the inverse permutation
        inv = torch.empty_like(rt.perm)
        inv[rt.perm] = torch.arange(rt.perm.numel(), device=inv.device)
        o = res_sorted[inv]
        shp = win[e][0].shape
        fi1 = o[:, 0].reshape(shp)
        found = fi1 > 0
        fams = None
        if fam_tab is not None:
            fams = o[:, 4:].reshape(*shp, -1) - 1
        out[e] = (found, torch.where(found, fi1 - 1, 0),
                  o[:, 1].reshape(shp), o[:, 2].reshape(shp),
                  o[:, 3].contiguous().view(torch.float32).reshape(shp),
                  fams, ovf.sum(dtype=i32).reshape(1),
                  (ovf & ~in_ov).sum(dtype=i32).reshape(1))
    return out


# Copied from close_kmers_tpu/parallel/sharding.py (pure Python).
def _routing_caps(sdb: ShardedDB, B: int, L: int,
                  capacity_factor: float | None = 2.0,
                  ov_frac: float = 8.0) -> tuple[int, int]:
    """Static routing capacities for a [B, L] batch: ``cap`` windows per
    (source, destination) pair sized at ``capacity_factor`` x the uniform
    expectation, ``ov_cap`` fallback slots at 1/``ov_frac`` of a device's
    windows.  ``capacity_factor=None`` sets cap to a device's FULL window
    count — provably drop-free regardless of the query hi distribution
    (a source can never send more than all its windows to one shard), at
    S x the exchange buffer memory; right for tests and small batches."""
    from ..params import K
    S = sdb.n_shards
    n_data = sdb.mesh.shape["data"]
    Bl = max(1, B // (n_data * S))
    Nw = Bl * max(1, L - (K - 1))
    if capacity_factor is None:
        return max(8, Nw), max(8, Nw)
    cap = max(8, -(-int(Nw * capacity_factor) // S))
    ov_cap = max(8, int(Nw // ov_frac))
    return cap, ov_cap


def probe_routed(sdb: ShardedDB, offsets, lengths,
                 capacity_factor: float | None = 2.0, ov_frac: float = 8.0):
    """Routed-probe equivalent of :func:`probe_sharded` (same 7-tuple),
    plus (n_overflow, n_dropped) per-device count vectors in mesh order.
    Batch rows must divide by n_data * S.  ``n_dropped`` > 0 means some
    windows exceeded both routing capacities and report found=0 —
    re-dispatch with a bigger ``capacity_factor``."""
    mesh = sdb.mesh
    B, L = np.shape(offsets)
    cap, ov_cap = _routing_caps(sdb, B, L, capacity_factor, ov_frac)
    win = _windows(mesh, offsets, lengths, "both")
    got = _routed_probe_core(sdb, None, win, cap, ov_cap, [])
    outs = [{e: got[e][0].to(torch.int32) for e in got}]
    outs += [{e: got[e][j] for e in got} for j in (1, 2, 3, 4)]
    outs += [{e: win[e][j] for e in got} for j in (0, 1)]
    outs += [{e: got[e][j] for e in got} for j in (6, 7)]
    return tuple(mesh.home(o, "both") for o in outs)


def serve_step_sharded(sdb: ShardedDB, offsets, lengths,
                       params: EngineParams | None = None,
                       fam_shards: Sharded | None = None,
                       cap_seq: int = 8, routed: bool = True,
                       capacity_factor: float | None = 2.0):
    """The multi-device SERVING step: returns (best_pack, n_overflow,
    n_dropped[, rollup_rows]).

    * ``best_pack`` [B, 9]: the device find_best_call pack (same columns
      as DeviceScorer.best_batch_packed; finish with
      DeviceScorer.finish_best_batch, column 8 = host-fallback flag);
    * ``rollup_rows`` [B, 1 + 4*c]: per-sequence family rollup rows
      (parse with DeviceFamilyScorer.finish_rollup_rows), present when
      ``fam_shards`` (from :func:`shard_fam_table`) is given;
    * ``n_overflow``/``n_dropped``: per-device routing counters in mesh
      order (all zero, one per data row, when ``routed=False``, which
      selects the replicated probe + psum merge).

    ``params`` is a real EngineParams (per-request overrides flow here).
    Raises IndexError after the step when a family row gather met an id
    outside its table."""
    from ..core.device_family import _gather_fams, rollup_from_fams
    from ..core.device_score import _scan_score
    from ..ops.best_call import best_call
    params = params or EngineParams()
    mesh = sdb.mesh
    B, L = np.shape(offsets)
    split = "both" if routed else "data"
    win = _windows(mesh, offsets, lengths, split)
    checks = []
    if routed:
        cap, ov_cap = _routing_caps(sdb, B, L, capacity_factor)
        got = _routed_probe_core(sdb, fam_shards, win, cap, ov_cap, checks)
        probed = {e: (g[0], g[1], g[3], g[4], g[5], g[6], g[7])
                  for e, g in got.items()}
    else:
        local = {e: _probe_local_windows(sdb, e, *w)
                 for e, w in win.items()}
        merged = _merge_probe(mesh, {e: p[:5] for e, p in local.items()})
        merged_fams = {e: None for e in local}
        if fam_shards is not None:
            contrib = {}
            for e, p in local.items():
                fams_l, check = _gather_fams(fam_shards.parts[e], p[5])
                checks.append(check)
                contrib[e] = torch.where(p[0][..., None], fams_l + 1, 0)
            merged_fams = {e: x - 1 for e, x in mesh.psum(contrib).items()}
        probed = {}
        for e, (fnd32, p_fi, _oi, p_av, p_wt) in merged.items():
            zero1 = torch.zeros(1, dtype=torch.int32, device=fnd32.device)
            probed[e] = (fnd32 > 0, p_fi, p_av, p_wt, merged_fams[e], zero1,
                         zero1)
    best, rows = {}, {}
    for e, (found, p_fi, p_av, p_wt, fams, _, _) in probed.items():
        emit, (_s, _e, c_cnt, c_fi, c_wt) = _scan_score(
            found, p_fi, p_av, p_wt, params.min_hits,
            params.min_weighted_hits, params.max_gap,
            params.order_constraint)
        best[e] = best_call(emit, c_cnt, c_fi, c_wt)
        if fams is not None:
            rows[e] = rollup_from_fams(fams, cap_seq)
    outs = (mesh.home(best, split),
            mesh.home({e: p[5] for e, p in probed.items()}, split),
            mesh.home({e: p[6] for e, p in probed.items()}, split))
    if fam_shards is not None:
        outs += (mesh.home(rows, split),)
    for check in checks:
        check.raise_if_bad()
    return outs


class ShardedEngine:
    """Drop-in engine over a sharded DB: the compact-hit interface of
    FastAnnotator.probe_compact, batch sharded over "data".

    ``routed=True`` probes through the exchange path (:func:`probe_routed`)
    instead of the replicated psum merge at capacity factor
    ROUTED_CAPACITY, and re-dispatches with larger capacities when that
    one drops windows."""

    # The first rung of the routed probe's capacity ladder (JAX: 2.0, the
    # default of probe_routed and _routing_caps): on one H100 factor 2
    # dropped 4,436,962 windows a 65,536-protein pass on the deep DB and
    # 4 none, and 4 was no slower on the query, deep and skewed 210M-key
    # DBs (PERF.md §6, "capacity sweep").
    ROUTED_CAPACITY = 4.0

    def __init__(self, db: SignatureDB, mesh: Mesh | None = None,
                 routed: bool = False):
        self.mesh = mesh or make_mesh()
        self.db = db
        self.routed = routed
        self.sdb = ShardedDB.from_db(db, self.mesh)

    def pad_to_data_axis(self, B: int) -> int:
        d = self.mesh.shape["data"]
        return -(-B // d) * d

    def pad_batch(self, seqs, pad_to=None):
        return E.FastAnnotator.pad_batch(self, seqs, pad_to)

    def hits_of_batch(self, seqs, pad_to=None):
        """Compact per-sequence oracle.Hit lists (FastAnnotator-compatible
        interface for NR preload and handlers)."""
        from ..core import oracle as Orc
        h = self.probe_compact(*self.pad_batch(seqs, pad_to))
        out = []
        for s in range(len(seqs)):
            a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
            out.append([Orc.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                                avg_off=int(h["avg_off"][k]),
                                fI=int(h["fi"][k]), wt=float(h["wt"][k]),
                                code=int(h["code"][k]))
                        for k in range(a, b)])
        return out

    def probe_compact(self, offsets: np.ndarray, lengths: np.ndarray,
                      hits_per_seq_cap: int = 64, want_code: bool = True,
                      want_oi: bool = True, want_avg: bool = True,
                      rows_only: bool = False):
        """Same contract as FastAnnotator.probe_compact.  The plane flags
        exist for interface parity: the sharded step reads full grids
        back regardless, so they only shape the returned dict (zeros /
        omitted "code")."""
        B = offsets.shape[0]
        Bp = self.pad_to_data_axis(B)
        if Bp != B:
            offsets = np.concatenate(
                [offsets, np.full((Bp - B, offsets.shape[1]), 20, np.uint8)])
            lengths = np.concatenate([lengths, np.zeros(Bp - B, np.int32)])
        if self.routed:
            nd = self.mesh.shape["data"] * self.mesh.shape["table"]
            Bq = -(-Bp // nd) * nd
            if Bq != Bp:
                offsets = np.concatenate(
                    [offsets,
                     np.full((Bq - Bp, offsets.shape[1]), 20, np.uint8)])
                lengths = np.concatenate(
                    [lengths, np.zeros(Bq - Bp, np.int32)])
            out = probe_routed(self.sdb, offsets, lengths,
                               capacity_factor=self.ROUTED_CAPACITY)
            # the drop counts are the whole mesh's (every process holds
            # the global vector), so every process takes the same branch
            if int(out[8].sum()):
                # a skewed query hi distribution exceeded both routing
                # capacities: escalate geometrically before the drop-free
                # capacity (a device's full window count), whose S-fold
                # exchange buffers can run out of memory at large S
                for cf in (8.0, None):
                    logging.getLogger(__name__).warning(
                        "routed probe dropped windows; re-dispatching "
                        "with capacity_factor=%s", cf)
                    out = probe_routed(self.sdb, offsets, lengths,
                                       capacity_factor=cf)
                    if not int(out[8].sum()):
                        break
            found, fi, oi, av, wt, hi, lo = out[:7]
        else:
            found, fi, oi, av, wt, hi, lo = probe_sharded(
                self.sdb, offsets, lengths)
        found = found.cpu().numpy()[:B] > 0
        rows, cols = np.nonzero(found)
        row_off = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=B), out=row_off[1:])
        zeros = np.zeros(len(rows), dtype=np.int32)

        def pick(x):
            return x.cpu().numpy()[:B][rows, cols]

        h = dict(pos=cols.astype(np.int32), fi=pick(fi),
                 oi=pick(oi) if want_oi else zeros,
                 avg_off=pick(av) if want_avg else zeros,
                 wt=pick(wt), row_off=row_off)
        if want_code:
            h["code"] = (pick(hi).astype(np.int64) * LO_CARD
                         + pick(lo).astype(np.int64))
        return h
