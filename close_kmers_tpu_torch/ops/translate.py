# Copied from close_kmers_tpu/ops/translate.py.
"""DNA handling: complement, reverse-complement, codon translation,
six-frame protein generation.

Parity targets:

* ``GENETIC_CODE`` — the engine-internal bacterial code table used by
  KmerGuts::translate for DNA inputs (kguts.cc:24-29);
  ambiguous codons produce ``'x'`` (offset 20) (kguts.cc:529-532).
* ``TABLE_11`` — the NCBI-style table-11 built from the 5-row raw spec
  (trans_table.cc:8-15,36-63); ambiguous codons produce
  ``'X'``.  Used by the FASTQ path (fq_process_request.cc:306).
* complement table — the full-IUPAC complement shared by KmerGuts::comp
  (kguts.cc:341-425) and DNASequence::complement (dna_seq.h:28-111),
  including its quirks ('s'->'S' uppercases, 'w'->'w' does not).
* ``get_possible_proteins`` — 6 frames, each split on stop codons with
  run-compression (dna_seq.cc:9-23, boost token_compress_on).
"""

from __future__ import annotations

import re

import numpy as np

from ..params import K

# Indexed by c1*16 + c2*4 + c3 with A=0, C=1, G=2, T/U=3 (kguts.cc:24-29).
GENETIC_CODE = (
    "KNKNTTTTRSRSIIMI"
    "QHQHPPPPRRRRLLLL"
    "EDEDAAAAGGGGVVVV"
    "*Y*YSSSS*CWCLFLF"
)

# trans_table.cc:8-15 raw table-11 spec rows (Base1*16+Base2*4+Base3
# indexing, same A=0,C=1,G=2,T=3 encoding; trans_table.h:72-83).
_T11_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_T11_B1 = "TTTTTTTTTTTTTTTTCCCCCCCCCCCCCCCCAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGG"
_T11_B2 = "TTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGG"
_T11_B3 = "TCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAG"

_DNA_CHAR = np.full(256, 4, dtype=np.uint8)  # kguts.cc:486-511 / trans_table.h:45-70
for _c, _v in (("aA", 0), ("cC", 1), ("gG", 2), ("tTuU", 3)):
    for _ch in _c:
        _DNA_CHAR[ord(_ch)] = _v


def _build_table(aas: str, b1: str, b2: str, b3: str) -> np.ndarray:
    tbl = np.full(65, ord("X"), dtype=np.uint8)
    for aa, c1, c2, c3 in zip(aas, b1, b2, b3):
        idx = _DNA_CHAR[ord(c1)] * 16 + _DNA_CHAR[ord(c2)] * 4 + _DNA_CHAR[ord(c3)]
        tbl[idx] = ord(aa)
    tbl[64] = ord("X")
    return tbl


TABLE_11 = _build_table(_T11_AAS, _T11_B1, _T11_B2, _T11_B3)

# KmerGuts internal table: same codon indexing, ambiguous -> 'x'
# (lowercase, kguts.cc:530).
KGUTS_TABLE = np.frombuffer(GENETIC_CODE.encode(), dtype=np.uint8).copy()
KGUTS_TABLE = np.concatenate([KGUTS_TABLE, np.array([ord("x")], dtype=np.uint8)])

# Full IUPAC complement (kguts.cc:341-425 == dna_seq.h:28-111, including
# the 's'->'S' uppercase quirk and 'w'->'w' non-quirk).
_COMP = np.arange(256, dtype=np.uint8)  # default: identity (kguts.cc:422-423)
for _src, _dst in [
    ("a", "t"), ("A", "T"), ("c", "g"), ("C", "G"), ("g", "c"), ("G", "C"),
    ("t", "a"), ("u", "a"), ("T", "A"), ("U", "A"),
    ("m", "k"), ("M", "K"), ("r", "y"), ("R", "Y"),
    ("w", "w"), ("W", "W"), ("s", "S"), ("S", "S"),
    ("y", "r"), ("Y", "R"), ("k", "m"), ("K", "M"),
    ("b", "v"), ("B", "V"), ("d", "h"), ("D", "H"),
    ("h", "d"), ("H", "D"), ("v", "b"), ("V", "B"),
    ("n", "n"), ("N", "N"),
]:
    _COMP[ord(_src)] = ord(_dst)
COMPLEMENT = _COMP


def _to_bytes(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    return np.frombuffer(seq, dtype=np.uint8)


def rev_comp(seq: str | bytes) -> str:
    """Reverse complement (kguts.cc:427-436 / dna_seq.cc:39-47)."""
    b = _to_bytes(seq)
    return COMPLEMENT[b[::-1]].tobytes().decode("latin-1")


def _translate_frame(b: np.ndarray, off: int, table: np.ndarray) -> str:
    """Translate bytes from offset ``off`` in codon steps.

    Codon count = floor((len-off)/3), matching both KmerGuts::translate
    (kguts.cc:513-539: loop while start <= len-3) and
    TranslationTable::translate (trans_table.cc:65-84).
    """
    n = (len(b) - off) // 3
    if n <= 0:
        return ""
    c = b[off : off + 3 * n].reshape(n, 3)
    d = _DNA_CHAR[c]
    idx = d[:, 0] * 16 + d[:, 1] * 4 + d[:, 2]
    idx = np.where((d >= 4).any(axis=1), 64, idx)
    return table[idx].tobytes().decode("latin-1")


def translate_kguts(seq: str | bytes, off: int) -> str:
    """KmerGuts::translate parity: engine-internal code, ambiguous->'x'."""
    return _translate_frame(_to_bytes(seq), off, KGUTS_TABLE)


def translate_t11(seq: str | bytes, off: int = 0) -> str:
    """TranslationTable(11) parity: ambiguous->'X'."""
    return _translate_frame(_to_bytes(seq), off, TABLE_11)


def six_frames_kguts(seq: str | bytes) -> list[tuple[str, int, str]]:
    """The six (strand, offset, protein) translations in KmerGuts::process_seq
    order (kguts.cc:910-937): +0,+1,+2 then -0,-1,-2 on the reverse
    complement."""
    out = []
    for off in range(3):
        out.append(("+", off, translate_kguts(seq, off)))
    rc = rev_comp(seq)
    for off in range(3):
        out.append(("-", off, translate_kguts(rc, off)))
    return out


# -- digit-space fast path (no string round-trips) ----------------------
#
# The string pipeline (DNA str -> translate -> protein str ->
# seq_to_offsets) pays two latin-1 encode/decode passes per frame; at
# genome scale (30M codons across 6 frames) that is ~0.2 s/pass of pure
# conversion.  These helpers stay in uint8 digit space end-to-end and
# produce the aa OFFSET arrays the engine consumes directly.
#
# Base-5 codon table: digits are 0-3 (acgt) or 4 (ambiguous), so
# idx5 = d0*25 + d1*5 + d2 < 125 and any codon containing a 4 lands on
# an entry precomputed to the offset of 'x' (= 20, invalid) — the
# ambiguity test disappears into the table.

_DIGIT_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # a<->t, c<->g


def _codon5_offsets(table: np.ndarray) -> np.ndarray:
    from .encoder import AA_TO_OFFSET
    t = np.empty(125, dtype=np.uint8)
    for d0 in range(5):
        for d1 in range(5):
            for d2 in range(5):
                if d0 > 3 or d1 > 3 or d2 > 3:
                    idx = 64
                else:
                    idx = d0 * 16 + d1 * 4 + d2
                t[d0 * 25 + d1 * 5 + d2] = AA_TO_OFFSET[table[idx]]
    return t


_KGUTS_OFF5 = _codon5_offsets(KGUTS_TABLE)


def _frame_offsets(d: np.ndarray, off: int) -> np.ndarray:
    n = (len(d) - off) // 3
    if n <= 0:
        return np.empty(0, dtype=np.uint8)
    c = d[off:off + 3 * n].reshape(n, 3)
    return _KGUTS_OFF5[c[:, 0] * np.uint8(25) + c[:, 1] * np.uint8(5)
                       + c[:, 2]]


def six_frame_kguts_offsets(seq: str | bytes) -> list[tuple[str, int, np.ndarray]]:
    """six_frames_kguts in digit space: (strand, offset, aa-offset uint8
    array) per frame, byte-equal to seq_to_offsets(translate_kguts(...))
    (tested), ~3x faster at genome scale."""
    d = _DNA_CHAR[_to_bytes(seq)]
    dc = _DIGIT_COMP[d][::-1]
    return ([("+", off, _frame_offsets(d, off)) for off in range(3)]
            + [("-", off, _frame_offsets(dc, off)) for off in range(3)])


_T11_OFF5 = _codon5_offsets(TABLE_11)
_T11_STOP5 = np.zeros(125, dtype=bool)
for _d0 in range(4):
    for _d1 in range(4):
        for _d2 in range(4):
            _T11_STOP5[_d0 * 25 + _d1 * 5 + _d2] = \
                TABLE_11[_d0 * 16 + _d1 * 4 + _d2] == ord("*")


def _row_tokens(stops: list, n_aa: int):
    """Token (start, end) spans of re.split('\\*+') given a row's sorted
    stop positions: interior stop runs compress; leading/trailing stops
    produce empty edge tokens (dna_seq.cc:9-23, token_compress_on)."""
    spans = []
    tok_start = 0
    prev = -2
    for s in stops:
        if s != prev + 1:          # run break: close the open token
            spans.append((tok_start, s))
        tok_start = s + 1
        prev = s
    spans.append((tok_start, n_aa))
    return spans


def batch_possible_protein_orfs(seqs: list, min_len: int = 10):
    """Vectorized get_possible_proteins over a batch of DNA reads, in
    digit space (no string round-trips — the per-read regex pipeline
    costs ~17 us/read-frame, which dominates FASTQ serving).

    Returns (orfs, read_frames):
      orfs — list of uint8 aa-offset arrays, one per token with
        len > min_len, in (read, frame, token) order — feed directly to
        pad_batch;
      read_frames — per read, the 6 (frame, [(tok_len, orf_idx)])
        entries in reference frame order (1,2,3,-1,-2,-3;
        fq_process_request.cc:298-317); orf_idx is -1 for short tokens.

    Token lists match get_possible_proteins exactly (tested): interior
    stop runs compress, leading/trailing stops give empty edge tokens.
    """
    R = len(seqs)
    if R == 0:
        return [], []
    rows = [_DNA_CHAR[_to_bytes(s)] for s in seqs]
    n = np.array([len(r) for r in rows], dtype=np.int64)
    Lmax = max(int(n.max()), 3)
    d = np.full((R, Lmax), 4, dtype=np.uint8)
    for r, row in enumerate(rows):
        d[r, :len(row)] = row
    # reverse complement, vectorized over the ragged rows
    j = np.arange(Lmax, dtype=np.int64)[None, :]
    src = n[:, None] - 1 - j
    rc = np.where(src >= 0,
                  _DIGIT_COMP[d[np.arange(R)[:, None],
                                np.clip(src, 0, Lmax - 1)]],
                  np.uint8(4))

    frames = []  # (frame, off_mat [R, W], per-row stop lists, n_aa [R])
    for sign, mat in ((1, d), (-1, rc)):
        for off in range(3):
            W = (Lmax - off) // 3
            if W <= 0:
                W = 0
            c = mat[:, off:off + 3 * W]
            idx5 = (c[:, 0::3] * np.uint8(25) + c[:, 1::3] * np.uint8(5)
                    + c[:, 2::3]) if W else np.zeros((R, 0), np.uint8)
            # one global nonzero per frame instead of one per row (pad
            # digits are 4, so positions beyond a read's n_aa are never
            # stops and need no clipping)
            srows, scols = np.nonzero(_T11_STOP5[idx5])
            row_ptr = np.searchsorted(srows, np.arange(R + 1))
            scols = scols.tolist()
            frames.append((sign * (off + 1), _T11_OFF5[idx5],
                           (row_ptr, scols),
                           np.maximum((n - off) // 3, 0)))

    orfs: list[np.ndarray] = []
    read_frames = []
    for r in range(R):
        per_read = []
        for frame, off_mat, (row_ptr, scols), n_aa in frames:
            toks = []
            stops = scols[row_ptr[r]:row_ptr[r + 1]]
            for a, b in _row_tokens(stops, int(n_aa[r])):
                ln = b - a
                if ln > min_len:
                    toks.append((ln, len(orfs)))
                    orfs.append(off_mat[r, a:b])
                else:
                    toks.append((ln, -1))
            per_read.append((frame, toks))
        read_frames.append(per_read)
    return orfs, read_frames


def _frame_token_spans(srows: np.ndarray, scols: np.ndarray,
                       n_aa: np.ndarray):
    """Vectorized _row_tokens over all rows of one frame: given the
    frame's stop positions (row-major sorted) and per-row aa counts,
    return (tok_row, tok_start, tok_end) for every re.split('\\*+')
    token — interior stop runs compress, leading/trailing stops produce
    empty edge tokens (dna_seq.cc:9-23, token_compress_on)."""
    R = len(n_aa)
    m = len(srows)
    if m:
        new_run = np.ones(m, dtype=bool)
        new_run[1:] = (srows[1:] != srows[:-1]) | (scols[1:] != scols[:-1] + 1)
        run_idx = np.nonzero(new_run)[0]
        run_row = srows[run_idx]
        run_start = scols[run_idx]
        run_end = scols[np.append(run_idx[1:] - 1, m - 1)]
    else:
        run_row = np.zeros(0, np.int64)
        run_start = run_end = np.zeros(0, np.int64)
    runs_per_row = np.bincount(run_row, minlength=R)
    ntok = runs_per_row + 1
    total = int(ntok.sum())
    tok_row = np.repeat(np.arange(R, dtype=np.int64), ntok)
    row_ptr = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(ntok, out=row_ptr[1:])
    pos = np.arange(total, dtype=np.int64) - row_ptr[tok_row]
    if len(run_start) == 0:   # no stops anywhere: one [0, n_aa) token/row
        return tok_row, np.zeros(total, np.int64), n_aa[tok_row]
    run_ptr = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(runs_per_row, out=run_ptr[1:])
    guard = len(run_end) - 1
    start = np.where(pos == 0, 0,
                     run_end[np.clip(run_ptr[tok_row] + pos - 1, 0, guard)]
                     + 1)
    last = pos == ntok[tok_row] - 1
    end = np.where(last, n_aa[tok_row],
                   run_start[np.clip(run_ptr[tok_row] + pos, 0, guard)])
    return tok_row, start, end


def batch_orf_arrays(seqs: list, min_len: int = 10,
                     pad_pow2: bool = True):
    """Array-native batch_possible_protein_orfs: identical token
    semantics (tested equal), but everything stays numpy — no per-token
    Python objects and no per-ORF slicing, the dominant host cost of
    /fq_lookup serving (fq_process_request.cc:298-317 is the reference
    path being batched).

    Returns (offsets, lengths, toks):
      offsets — uint8 [n_orfs, L] aa-offset grid (20-padded, L padded to
        a power of two like FastAnnotator.pad_batch), device-ready;
      lengths — int32 [n_orfs];
      toks — dict of int32/int8 arrays over ALL tokens in (read, frame,
        token) order: ``read``, ``fpos`` (0..5 = frames 1,2,3,-1,-2,-3),
        ``len``, ``orf`` (row into offsets, -1 for tokens <= min_len).
    """
    R = len(seqs)
    empty_toks = dict(read=np.zeros(0, np.int32), fpos=np.zeros(0, np.int8),
                      len=np.zeros(0, np.int32), orf=np.zeros(0, np.int32))
    if R == 0:
        return (np.zeros((0, K + 2), np.uint8), np.zeros(0, np.int32),
                empty_toks)
    # one-shot digit conversion: join -> frombuffer -> masked row scatter
    # (the per-read LUT/copy loop cost ~0.1 s of a 20k-read pass)
    if isinstance(seqs[0], (bytes, bytearray)):
        joined = b"".join(seqs)
    else:
        joined = "".join(seqs).encode("latin-1")
    n = np.array([len(s) for s in seqs], dtype=np.int64)
    flat = _DNA_CHAR[np.frombuffer(joined, dtype=np.uint8)]
    Lmax = max(int(n.max()), 3)
    d = np.full((R, Lmax), 4, dtype=np.uint8)
    j = np.arange(Lmax, dtype=np.int32)[None, :]
    d[j < n[:, None]] = flat     # row-major fill = reads in order
    src = (n[:, None] - 1 - j).astype(np.int32)
    rc = np.where(src >= 0,
                  _DIGIT_COMP[d[np.arange(R, dtype=np.int32)[:, None],
                                np.maximum(src, 0)]],
                  np.uint8(4))

    # one sliding-window codon value per strand (v[c] = digits c,c+1,c+2
    # in base 5) serves all three frames as stride-3 views — one
    # multiply-add + one LUT gather + one nonzero per strand instead of
    # three of each
    f_mats, f_tok = [], []
    Wall = Lmax - 2
    for sign, mat in ((1, d), (-1, rc)):
        if Wall > 0:
            v = (mat[:, 0:Wall] * np.uint8(25)
                 + mat[:, 1:Wall + 1] * np.uint8(5) + mat[:, 2:Wall + 2])
            off_all = _T11_OFF5[v]
            sr_all, sc_all = np.nonzero(_T11_STOP5[v])
            sc_mod = sc_all % 3
        for off in range(3):
            W = (Lmax - off) // 3
            if W > 0:
                m3 = sc_mod == off
                srows = sr_all[m3]
                scols = (sc_all[m3] - off) // 3
                off_mat = off_all[:, off::3][:, :W]
            else:
                srows = scols = np.zeros(0, np.int64)
                off_mat = np.zeros((R, 0), np.uint8)
            n_aa = np.maximum((n - off) // 3, 0)
            f_mats.append(off_mat)
            f_tok.append(_frame_token_spans(srows, scols, n_aa))

    # global (read, frame, token) ordering
    tok_row = np.concatenate([t[0] for t in f_tok])
    tok_start = np.concatenate([t[1] for t in f_tok])
    tok_end = np.concatenate([t[2] for t in f_tok])
    tok_fpos = np.concatenate([np.full(len(t[0]), f, np.int8)
                               for f, t in enumerate(f_tok)])
    tok_pos = np.concatenate([np.arange(len(t[0])) for t in f_tok])
    order = np.lexsort((tok_pos, tok_fpos, tok_row))
    tok_row, tok_start, tok_end = (tok_row[order], tok_start[order],
                                   tok_end[order])
    tok_fpos = tok_fpos[order]
    tok_len = (tok_end - tok_start).astype(np.int32)

    kept = tok_len > min_len
    n_orfs = int(kept.sum())
    tok_orf = np.full(len(tok_len), -1, dtype=np.int32)
    tok_orf[kept] = np.arange(n_orfs, dtype=np.int32)

    maxlen = int(tok_len[kept].max()) if n_orfs else 0
    L = max(maxlen + 1, K + 2)
    if pad_pow2:
        L = 1 << (L - 1).bit_length()
    lengths = tok_len[kept].astype(np.int32)
    # single flat gather over a stacked all-frames matrix: tok_orf[kept]
    # is arange(n_orfs) by construction, so the gather result IS the
    # offsets grid — no per-frame scatter passes (this fill was ~40% of
    # the batcher's time as 6 fancy-index loops)
    Wmax = max((m.shape[1] for m in f_mats), default=0) + 1
    big = np.full((6 * R, Wmax), 20, dtype=np.uint8)
    for f, mat in enumerate(f_mats):
        if mat.shape[1]:
            big[f * R:(f + 1) * R, :mat.shape[1]] = mat
    # guard pad instead of a per-element clip; int32 indices for the
    # common read-sized regime (the int64 index grid alone was ~100
    # MB/pass), int64 when the stacked frame matrix could wrap int32
    # (many long contigs: 6*R*Wmax + L can exceed 2^31)
    bigf = np.concatenate([big.reshape(-1),
                           np.full(L, 20, dtype=np.uint8)])
    idt = np.int64 if 6 * R * Wmax + L >= 2**31 else np.int32
    krow = tok_fpos[kept].astype(idt) * idt(R) \
        + tok_row[kept].astype(idt)
    base = krow * idt(Wmax) + tok_start[kept].astype(idt)
    idxf = base[:, None] + np.arange(L, dtype=idt)[None, :]
    offsets = bigf[idxf]
    offsets[np.arange(L, dtype=np.int32)[None, :] >= lengths[:, None]] = 20

    toks = dict(read=tok_row.astype(np.int32), fpos=tok_fpos,
                len=tok_len, orf=tok_orf)
    return offsets, lengths, toks


def get_possible_proteins(seq: str | bytes) -> list[tuple[int, list[str]]]:
    """DNASequence::get_possible_proteins parity (dna_seq.cc:9-23): frames
    1,2,3,-1,-2,-3 translated with table 11, each split on runs of '*'
    (boost token_compress_on keeps leading/trailing empty tokens)."""
    b = _to_bytes(seq)
    rc = _to_bytes(rev_comp(seq))
    out = []
    for frame in (1, 2, 3, -1, -2, -3):
        src = rc if frame < 0 else b
        p = _translate_frame(src, abs(frame) - 1, TABLE_11)
        out.append((frame, re.split(r"\*+", p)))
    return out
