# Copied from close_kmers_tpu/io/kmc.py.
"""KMC binary kmer-database reader/writer (.kmc_pre / .kmc_suf).

The reference's kmerge tool reads per-genome KMC databases through the
external kmc_api (kmerge.cc:106-118, :375-400 — OpenForListing + Info +
ReadNextKmer over sorted kmers), linked from ../KMC (Makefile:92-94).
This module implements the KMC1 database format directly in numpy so
`kmerge` can consume binary DBs without the KMC dependency, plus a
writer used for interop tests and fixture generation.

Layout implemented (KMC1, database version 0):

``<base>.kmc_pre``
    ``"KMCP"`` marker, then a ``uint64[4**lut_prefix_length + 1]``
    little-endian LUT — entry *i* is the index of the first suffix-file
    record whose kmer starts with prefix *i* (bases A=0,C=1,G=2,T=3,
    most-significant-first), with a final guard entry = total_kmers —
    then the header::

        uint32 kmer_length, mode, counter_size, lut_prefix_length,
               min_count, max_count
        uint64 total_kmers
        uint8  both_strands;  uint8 pad[3]

    then ``uint32 header_offset`` (bytes from header start to this
    field), ``uint32 kmc_version`` (0 = KMC1), and a trailing ``"KMCP"``
    marker.

``<base>.kmc_suf``
    ``"KMCS"`` marker, then ``total_kmers`` records sorted by full kmer:
    the suffix (kmer minus its prefix) packed 2 bits/base,
    first-base-in-top-bits, ``ceil((kmer_length-lut_prefix_length)/4)``
    bytes, followed by a ``counter_size``-byte little-endian count; then
    a trailing ``"KMCS"`` marker.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

_PRE_MARKER = b"KMCP"
_SUF_MARKER = b"KMCS"
_HEADER = struct.Struct("<6IQB3x")   # see module docstring
_BASES = "ACGT"
_BASE_CODE = {c: i for i, c in enumerate(_BASES)}


@dataclasses.dataclass
class KmcInfo:
    """CKMCFile::Info fields (kmerge.cc:388)."""
    kmer_length: int
    mode: int
    counter_size: int
    lut_prefix_length: int
    min_count: int
    max_count: int
    total_kmers: int
    both_strands: bool = True


def _strip_base(path: str) -> str:
    for ext in (".kmc_pre", ".kmc_suf"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path


def read_kmc_info(base: str) -> KmcInfo:
    base = _strip_base(base)
    with open(base + ".kmc_pre", "rb") as f:
        data = f.read()
    if data[:4] != _PRE_MARKER or data[-4:] != _PRE_MARKER:
        raise ValueError(f"{base}.kmc_pre: bad KMCP markers")
    kmc_version = struct.unpack_from("<I", data, len(data) - 8)[0]
    if kmc_version != 0:
        raise ValueError(f"{base}.kmc_pre: unsupported KMC database "
                         f"version 0x{kmc_version:x} (only KMC1/v0)")
    header_offset = struct.unpack_from("<I", data, len(data) - 12)[0]
    hstart = len(data) - 12 - header_offset
    (kmer_length, mode, counter_size, lut_prefix_length, min_count,
     max_count, total_kmers, both) = _HEADER.unpack_from(data, hstart)
    return KmcInfo(kmer_length, mode, counter_size, lut_prefix_length,
                   min_count, max_count, total_kmers, bool(both))


def read_kmc_db(base: str):
    """Yield (kmer_string, count) in sorted order — the ReadNextKmer
    iteration kmerge consumes (kmerge.cc:394-400)."""
    base = _strip_base(base)
    info = read_kmc_info(base)
    with open(base + ".kmc_pre", "rb") as f:
        pre = f.read()
    n_pref = (1 << (2 * info.lut_prefix_length)) + 1
    lut = np.frombuffer(pre, dtype="<u8", count=n_pref, offset=4)
    if int(lut[-1]) != info.total_kmers:
        raise ValueError(f"{base}: LUT guard {int(lut[-1])} != "
                         f"total_kmers {info.total_kmers}")

    suf_len = info.kmer_length - info.lut_prefix_length
    suf_bytes = (suf_len + 3) // 4
    rec = suf_bytes + info.counter_size
    with open(base + ".kmc_suf", "rb") as f:
        suf = f.read()
    if suf[:4] != _SUF_MARKER or suf[-4:] != _SUF_MARKER:
        raise ValueError(f"{base}.kmc_suf: bad KMCS markers")
    body = np.frombuffer(suf, dtype=np.uint8,
                         count=info.total_kmers * rec, offset=4)
    recs = body.reshape(info.total_kmers, rec)

    # unpack suffixes: 2 bits/base, first base in the top bits of byte 0
    packed = recs[:, :suf_bytes]
    shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
    codes = (packed[:, :, None] >> shifts[None, None, :]) & 3
    codes = codes.reshape(info.total_kmers, suf_bytes * 4)[:, :suf_len]
    base_chars = np.frombuffer(_BASES.encode(), dtype=np.uint8)
    suffix_strs = base_chars[codes].tobytes()

    counts = np.zeros(info.total_kmers, dtype=np.uint64)
    for b in range(info.counter_size):           # little-endian counter
        counts |= recs[:, suf_bytes + b].astype(np.uint64) << np.uint64(8 * b)

    p = info.lut_prefix_length
    starts = lut[:-1]
    ends = lut[1:]
    for pref_idx in range(n_pref - 1):
        s, e = int(starts[pref_idx]), int(ends[pref_idx])
        if e <= s:
            continue
        prefix = "".join(_BASES[(pref_idx >> (2 * (p - 1 - j))) & 3]
                         for j in range(p))
        for r in range(s, e):
            suffix = suffix_strs[r * suf_len:(r + 1) * suf_len].decode()
            yield prefix + suffix, int(counts[r])


def write_kmc_db(base: str, items, kmer_length: int,
                 lut_prefix_length: int = 4, counter_size: int = 4,
                 mode: int = 0, min_count: int = 1,
                 max_count: int = 255, both_strands: bool = True) -> None:
    """Write a KMC1 database from (kmer_string, count) pairs."""
    base = _strip_base(base)
    items = sorted(items)
    p = lut_prefix_length
    if p <= 0 or p >= kmer_length:
        raise ValueError("lut_prefix_length must be in (0, kmer_length)")
    suf_len = kmer_length - p
    suf_bytes = (suf_len + 3) // 4
    n_pref = 1 << (2 * p)

    lut = np.zeros(n_pref + 1, dtype="<u8")
    suf_records = bytearray()
    pref_counts = np.zeros(n_pref, dtype=np.int64)
    for kmer, count in items:
        if len(kmer) != kmer_length:
            raise ValueError(f"kmer {kmer!r} length != {kmer_length}")
        codes = [_BASE_CODE[c] for c in kmer.upper()]
        pref_idx = 0
        for c in codes[:p]:
            pref_idx = pref_idx * 4 + c
        pref_counts[pref_idx] += 1
        packed = bytearray(suf_bytes)
        for j, c in enumerate(codes[p:]):
            packed[j // 4] |= c << (6 - 2 * (j % 4))
        suf_records += bytes(packed)
        # KMC saturates counters at the field's capacity instead of
        # overflowing; clamp so counter_size=1/2 writers can't raise
        # OverflowError from to_bytes.
        cap = (1 << (8 * counter_size)) - 1
        suf_records += min(int(count), cap).to_bytes(counter_size, "little")
    np.cumsum(pref_counts, out=lut[1:])

    header = _HEADER.pack(kmer_length, mode, counter_size, p, min_count,
                          max_count, len(items), int(both_strands))
    with open(base + ".kmc_pre", "wb") as f:
        f.write(_PRE_MARKER)
        f.write(lut.tobytes())
        f.write(header)
        f.write(struct.pack("<II", len(header), 0))
        f.write(_PRE_MARKER)
    with open(base + ".kmc_suf", "wb") as f:
        f.write(_SUF_MARKER)
        f.write(bytes(suf_records))
        f.write(_SUF_MARKER)


def is_kmc_db(path: str) -> bool:
    """kmerge input sniffing (kmerge.cc:325-338): explicit
    .kmc_pre/.kmc_suf name, or a sibling <path>.kmc_pre existing."""
    if path.endswith(".kmc_pre") or path.endswith(".kmc_suf"):
        return True
    return os.path.isfile(path + ".kmc_pre")
