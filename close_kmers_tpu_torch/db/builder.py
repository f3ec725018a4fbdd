# Copied from close_kmers_tpu/db/builder.py.
"""Offline signature-kmer database builder.

Re-implements build_signature_kmers (build_signature_kmers.cc)
with vectorized extraction and sort/segment group-by in place of the TBB
concurrent multimap + parallel_for pipeline:

* FunctionMap — id→function assignments from def files
  (build_signature_kmers.cc:270-295) and fasta deflines (:308-414),
  function→genome occurrence sets, and the keep rule: >= min_reps genomes
  OR in the good-functions list OR any role in the good-roles list
  (:432-488); kept functions get dense indexes in sorted-function order
  (:481-487, std::set iteration).
* SEED function hygiene — strip_func_comment and roles_of_function
  (seed_utils.h:10-39).
* Kmer extraction — every 8-char window of every kept-function protein
  whose characters are in the ok_prot set (UPPER+lower alphabet,
  :569-632); note offset-from-end n = len - i INCLUDES the kmer itself,
  and unlike the query engine's scan bound, the final window IS extracted.
* Signature selection (process_set, :663-710) — per kmer group: plurality
  function (ties keep the smallest function index, std::max_element), keep
  iff best_count >= 0.8 * group size; median offset = sorted[size/2].
* Weight formula (:841-853) —
  w = log((NSiFj+1)/(NSi-NSiFj+1)) + log((NSF-NFj+KS)/(NFj+KS)).
* Outputs (:1310-1376) — function.index, empty otu.index, stub genomes
  file, final.kmers text, and the two-level sorted-array DB (plus a
  reference-compatible mem_map on request).

Kmers containing lowercase letters survive extraction and statistics but
encode to the invalid sentinel at table-insert time and are therefore
dropped from the probe table, exactly like insert_kmer (kguts.cc:202-210).

Determinism: the reference's concurrent_vector fill makes its final.kmers
order nondeterministic; this builder orders kept kmers by raw kmer bytes.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..params import K
from .signature_db import SignatureDB, write_index_file

STRIP_FUNC_COMMENT_RE = re.compile(r"(\s*\#.*$)")
SPLIT_FUNCTION_RE = re.compile(r"\s+[/@]\s+|\s*;\s+")
GENOME_RE = re.compile(r"\s+(.*)\s+\[([^]]+)\]$")
FIGID_RE = re.compile(r"fig\|(\d+\.\d+)")
GENOME_ID_RE = re.compile(r"\d+\.\d+")

MAX_SEQUENCES_PER_FILE = 1 << 32

# ok_prot (build_signature_kmers.cc:569-570): upper AND lower case.
_OK_PROT = np.zeros(256, dtype=bool)
for _c in "ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy":
    _OK_PROT[ord(_c)] = True


def strip_func_comment(s: str) -> str:
    return STRIP_FUNC_COMMENT_RE.sub("", s)


def roles_of_function(function: str) -> list[str]:
    return SPLIT_FUNCTION_RE.split(strip_func_comment(function))


class FunctionMap:
    """build_signature_kmers.cc:264-559."""

    def __init__(self) -> None:
        self.id_function: dict[str, str] = {}
        self.function_genomes: dict[str, set[str]] = {}
        self.good_functions: set[str] = set()
        self.good_roles: set[str] = set()
        self.function_index: dict[str, int] = {}

    def load_id_assignments(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                s = line.find("\t")
                if s < 0:
                    continue
                s2 = line.find("\t", s + 1)
                func = line[s + 1:] if s2 < 0 else line[s + 1:s2]
                self.id_function[line[:s]] = strip_func_comment(func)

    def load_fasta_file(self, path: str, keep_function_flag: bool = False) -> None:
        from ..io.fasta import parse_fasta_file
        genome = ""
        for sid, defline, seq in parse_fasta_file(path):
            if not sid:
                continue
            func = ""
            if defline:
                x = len(defline) - len(defline.lstrip(" \t"))
                func = defline[x:]
            genome_loc = ""
            m = GENOME_RE.fullmatch(defline)
            if m:
                func = strip_func_comment(m.group(1))
                genome_loc = m.group(2)
            if not genome:
                if not defline:
                    m2 = FIGID_RE.search(sid)
                    if m2:
                        genome = m2.group(1)
                elif genome_loc:
                    genome = genome_loc
            if not genome:
                genome = os.path.basename(path)
            cur = self.id_function.get(sid, "")
            if not cur:
                if func:
                    self.id_function[sid] = func
            else:
                func = cur
            if func:
                self.function_genomes.setdefault(func, set()).add(genome)
                if keep_function_flag:
                    self.good_functions.add(func)

    def process_kept_functions(self, min_reps_required: int = 5) -> None:
        kept = set()
        for function, genomes in self.function_genomes.items():
            ok = len(genomes) >= min_reps_required \
                or function in self.good_functions
            if not ok:
                for role in roles_of_function(function):
                    if role in self.good_roles:
                        ok = True
                        break
            if ok:
                kept.add(function)
        for i, f in enumerate(sorted(kept)):
            self.function_index[f] = i

    def lookup_function(self, sid: str) -> str:
        return self.id_function.get(sid, "")

    def lookup_index(self, func: str) -> int:
        return self.function_index.get(func, -1)

    def functions_by_index(self) -> list[str]:
        out = [""] * len(self.function_index)
        for f, i in self.function_index.items():
            out[i] = f
        return out


def _iter_seq_kmers(fm: FunctionMap, path: str, file_number: int,
                    seqs_with_func: np.ndarray):
    """load_fasta/load_sequence (:572-656): yield per-sequence
    (key, func, off, seq_id) arrays — raw-byte kmer keys with attributes
    for every valid window of every kept-function protein."""
    from ..io.fasta import parse_fasta_file
    next_seq_id = file_number * MAX_SEQUENCES_PER_FILE
    for sid, _d, seq in parse_fasta_file(path):
        if not sid:
            continue
        func = fm.lookup_function(sid)
        if not func:
            continue
        seq_id = next_seq_id
        next_seq_id += 1
        fi = fm.lookup_index(func)
        if fi < 0:
            continue
        seqs_with_func[fi] += 1
        b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
        n = len(b) - K + 1
        if n <= 0:
            continue
        ok = np.ones(n, dtype=bool)
        okc = _OK_PROT[b]
        key = np.zeros(n, dtype=np.uint64)
        for j in range(K):
            ok &= okc[j:j + n]
            key = (key << np.uint64(8)) | b[j:j + n].astype(np.uint64)
        idx = np.nonzero(ok)[0]
        # offset from end INCLUDING this kmer: n_dist = len - i  (:609)
        yield (key[idx], np.full(len(idx), fi, dtype=np.int32),
               (len(b) - idx).astype(np.int32),
               np.full(len(idx), seq_id, dtype=np.int64))


def _group_kept(key_s, func_s, off_s, seq_s):
    """Vectorized process_set (:663-710) over record arrays sorted by
    (key, func): per kmer group take the plurality function (ties keep
    the smallest index, std::max_element over an ordered map), keep iff
    float(best_count) >= float(count) * 0.8f — FLOAT32 math, :673-682 —
    and record the median offset sorted[size/2].

    Returns (kept_keys, med_off, best_func, nsi, nsifj, kept_seq_ids)
    where kept_seq_ids are the (non-unique) seq ids of entries in kept
    groups (for the NSF tally, :699)."""
    n = len(key_s)
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0, np.int64),
             np.zeros(0, np.int64), np.zeros(0, np.int64))
    if n == 0:
        return empty
    new_key = np.empty(n, dtype=bool)
    new_key[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=new_key[1:])
    new_pair = new_key.copy()
    new_pair[1:] |= func_s[1:] != func_s[:-1]
    pair_idx = np.nonzero(new_pair)[0]
    pair_count = np.diff(np.append(pair_idx, n)).astype(np.int64)
    pair_func = func_s[pair_idx].astype(np.int64)
    grp_first_pair = np.nonzero(new_key[pair_idx])[0]
    grp_start = pair_idx[grp_first_pair]
    grp_count = np.diff(np.append(grp_start, n)).astype(np.int64)
    # encode (count, -func) so a single max gives plurality with
    # smallest-func tie-breaking
    M = int(pair_func.max()) + 2
    v = pair_count * M + (M - 1 - pair_func)
    best_v = np.maximum.reduceat(v, grp_first_pair)
    best_count = best_v // M
    best_func = (M - 1) - (best_v % M)
    thresh = grp_count.astype(np.float32) * np.float32(0.8)
    keep = best_count.astype(np.float32) >= thresh

    # median offset: offsets sorted within each group
    off_sorted = off_s[np.lexsort((off_s, key_s))]
    med = off_sorted[grp_start + grp_count // 2]

    kept_seq = seq_s[np.repeat(keep, grp_count)]
    return (key_s[grp_start[keep]], med[keep].astype(np.int32),
            best_func[keep].astype(np.int32), grp_count[keep],
            best_count[keep], kept_seq)


def _key_to_kmer(key: int) -> str:
    return int(key).to_bytes(8, "big").decode("latin-1")


class BuildResult:
    def __init__(self, fm, kept_keys, median_off, best_func, weights, stats):
        self.fm = fm
        self.kept_keys = kept_keys        # uint64 raw-byte kmer keys
        self.median_off = median_off
        self.best_func = best_func
        self.weights = weights
        self.stats = stats

    def kept_kmer_strings(self):
        return [_key_to_kmer(k) for k in self.kept_keys]

    def to_signature_db(self) -> SignatureDB:
        """Insertable entries only (valid uppercase encodings), like
        write_hashtable + insert_kmer (:886-892, kguts.cc:202-210)."""
        entries = []
        for i, key in enumerate(self.kept_keys):
            entries.append((_key_to_kmer(key), int(self.median_off[i]),
                            int(self.best_func[i]), float(self.weights[i]),
                            -1))
        return SignatureDB.from_entries(entries,
                                        functions=self.fm.functions_by_index())

    def write_final_kmers(self, path: str) -> None:
        with open(path, "w") as f:
            for i, key in enumerate(self.kept_keys):
                f.write(f"{_key_to_kmer(key)}\t{int(self.median_off[i])}\t"
                        f"{int(self.best_func[i])}\t"
                        f"{'%g' % np.float32(self.weights[i])}\t-1\n")

    def write_data_dir(self, out_dir: str, mem_map: bool = False) -> None:
        """:1310-1323, 1363-1376."""
        os.makedirs(out_dir, exist_ok=True)
        write_index_file(os.path.join(out_dir, "function.index"),
                         self.fm.functions_by_index())
        open(os.path.join(out_dir, "otu.index"), "w").close()
        with open(os.path.join(out_dir, "genomes"), "w") as f:
            f.write("empty genomes\n")
        self.write_final_kmers(os.path.join(out_dir, "final.kmers"))
        db = self.to_signature_db()
        db.save_npz(os.path.join(out_dir, "signature_db.npz"))
        if mem_map:
            db.save_mem_map(os.path.join(out_dir, "kmer.table.mem_map"))


def build_signature_kmers(
    fasta_paths: list[str],
    kept_function_fasta_paths: list[str] = (),
    def_paths: list[str] = (),
    min_reps_required: int = 5,
    good_functions: list[str] = (),
    good_roles: list[str] = (),
) -> BuildResult:
    """The full builder pipeline (main, :1170-1376)."""
    fm = FunctionMap()
    fm.good_functions.update(good_functions)
    fm.good_roles.update(good_roles)
    for p in def_paths:
        fm.load_id_assignments(p)
    all_fastas = []
    for p in fasta_paths:
        fm.load_fasta_file(p, False)
        all_fastas.append(p)
    for p in kept_function_fasta_paths:
        fm.load_fasta_file(p, True)
        all_fastas.append(p)
    fm.process_kept_functions(min_reps_required)

    n_funcs = len(fm.function_index)
    seqs_with_func = np.zeros(max(n_funcs, 1), dtype=np.int64)
    keys, funcs, offs, seq_ids = [], [], [], []
    for file_number, p in enumerate(all_fastas):
        for k, f, o, s in _iter_seq_kmers(fm, p, file_number, seqs_with_func):
            keys.append(k)
            funcs.append(f)
            offs.append(o)
            seq_ids.append(s)

    if keys:
        key = np.concatenate(keys)
        func = np.concatenate(funcs)
        off = np.concatenate(offs)
        seq_id = np.concatenate(seq_ids)
    else:
        key = np.zeros(0, dtype=np.uint64)
        func = off = np.zeros(0, dtype=np.int32)
        seq_id = np.zeros(0, dtype=np.int64)

    # ---- group by kmer (sort-based replacement for the TBB multimap) ----
    order = np.lexsort((func, key))
    kept_keys, med_off, best_funcs, nsi, nsifj, kept_seq = _group_kept(
        key[order], func[order], off[order], seq_id[order])

    nsf = len(np.unique(kept_seq))  # NSF: distinct seqs w/ a signature (:699)
    ks = len(kept_keys)             # distinct_signatures (:705)
    weights = _signature_weights(nsi, nsifj, best_funcs, seqs_with_func,
                                 nsf, ks, n_funcs)

    stats = dict(
        distinct_signatures=ks,
        num_seqs_with_a_signature=nsf,
        seqs_with_func=seqs_with_func,
        total_kmers_extracted=int(len(key)),
    )
    return BuildResult(fm, kept_keys, med_off, best_funcs, weights, stats)


def _signature_weights(nsi, nsifj, best_funcs, seqs_with_func,
                       nsf: int, ks: int, n_funcs: int) -> np.ndarray:
    """compute_weight_of_signature (:841-853): float32 operands, double
    log math."""
    NSF = np.float64(np.float32(nsf))
    KS = np.float64(np.float32(ks))
    NSi = np.float32(nsi).astype(np.float64)
    NSiFj = np.float32(nsifj).astype(np.float64)
    NFj = np.float32(seqs_with_func[best_funcs] if n_funcs else
                     np.zeros(0)).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (np.log((NSiFj + 1.0) / (NSi - NSiFj + 1.0))
             + np.log((NSF - NFj + KS) / (NFj + KS)))
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# Out-of-core builder: disk-backed shard spill -> per-shard sort/group.
#
# The reference holds every extracted kmer in a TBB concurrent multimap
# (build_signature_kmers.cc:572-656, 1338-1348) — ~56 B/entry of RAM, which
# caps it far below the 1e9-kmer PATRIC target on ordinary hosts.  Here
# extraction streams 24-byte records into per-prefix spill files bucketed
# by the kmer's first two raw bytes (an order-preserving range partition,
# the host-side analogue of SURVEY §2.8's all-to-all kmer shuffle), then
# each shard is sorted and grouped independently; concatenating shards in
# prefix order reproduces the in-memory path's global kmer order, so the
# outputs are byte-identical.
# ---------------------------------------------------------------------------

_SPILL_DTYPE = np.dtype([("key", "<u8"), ("func", "<i4"), ("off", "<i4"),
                         ("seq", "<i8")])
_KEPT_DTYPE = np.dtype([("key", "<u8"), ("med", "<i4"), ("func", "<i4"),
                        ("nsi", "<i8"), ("nsifj", "<i8")])


class _ShardSpiller:
    """Buffered order-preserving range partition on the first two kmer
    bytes (<= ~1600 live prefixes over the 40-char ok_prot alphabet)."""

    def __init__(self, work_dir: str, buffer_records: int):
        self.dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        # Spill files are opened append-mode by flush(); stale ones from an
        # interrupted run in a reused --work-dir would silently mix records
        # from two runs (corrupting counts/medians/weights), so clear them.
        for f in os.listdir(work_dir):
            if f.endswith(".spill"):
                os.remove(os.path.join(work_dir, f))
        self.buffer_records = buffer_records
        self.buf: list[np.ndarray] = []
        self.buffered = 0

    def add(self, key, func, off, seq) -> None:
        rec = np.empty(len(key), dtype=_SPILL_DTYPE)
        rec["key"], rec["func"], rec["off"], rec["seq"] = key, func, off, seq
        self.buf.append(rec)
        self.buffered += len(rec)
        if self.buffered >= self.buffer_records:
            self.flush()

    def flush(self) -> None:
        if not self.buf:
            return
        rec = np.concatenate(self.buf)
        self.buf, self.buffered = [], 0
        shard = (rec["key"] >> np.uint64(48)).astype(np.int64)
        order = np.argsort(shard, kind="stable")
        rec = rec[order]
        shard = shard[order]
        starts = np.nonzero(np.concatenate([[True], shard[1:] != shard[:-1]]))[0]
        ends = np.append(starts[1:], len(rec))
        for a, b in zip(starts, ends):
            with open(os.path.join(self.dir, f"{int(shard[a]):05x}.spill"),
                      "ab") as f:
                f.write(rec[a:b].tobytes())

    def shard_files(self) -> list[str]:
        self.flush()
        return sorted(os.path.join(self.dir, f)
                      for f in os.listdir(self.dir) if f.endswith(".spill"))


class ExternalBuildResult:
    """Same products as BuildResult, streamed shard by shard."""

    def __init__(self, fm, kept_paths: list[str], seqs_with_func,
                 nsf: int, ks: int, stats: dict):
        self.fm = fm
        self.kept_paths = kept_paths
        self.seqs_with_func = seqs_with_func
        self.nsf = nsf
        self.ks = ks
        self.stats = stats

    def iter_kept_chunks(self):
        """Yield (keys_u64, med_off, best_func, weights) per shard, in
        global kmer order."""
        n_funcs = len(self.fm.function_index)
        for p in self.kept_paths:
            kept = np.fromfile(p, dtype=_KEPT_DTYPE)
            w = _signature_weights(kept["nsi"], kept["nsifj"], kept["func"],
                                   self.seqs_with_func, self.nsf, self.ks,
                                   n_funcs)
            yield kept["key"], kept["med"], kept["func"], w

    def write_final_kmers(self, path: str) -> None:
        with open(path, "w") as f:
            for keys, med, func, w in self.iter_kept_chunks():
                for i in range(len(keys)):
                    f.write(f"{_key_to_kmer(keys[i])}\t{int(med[i])}\t"
                            f"{int(func[i])}\t{'%g' % np.float32(w[i])}\t-1\n")

    def to_arrays(self):
        """Vectorized probe-table assembly: encode each kept chunk's raw
        kmer bytes to base-20 codes, drop invalid (lowercase) encodings
        like insert_kmer (kguts.cc:202-210), and concatenate in global
        kmer order.  O(output arrays) RAM — no per-entry Python tuples,
        so `build_db --external` survives the 1e8+-key scale the flag
        exists for.  Returns (keys i64, fi i32, oi i32, avg_off i32,
        wt f32)."""
        from ..ops.encoder import raw_keys_to_encoded
        keys_l, fi_l, off_l, wt_l = [], [], [], []
        for keys, med, func, w in self.iter_kept_chunks():
            code, valid = raw_keys_to_encoded(keys)
            keys_l.append(code[valid])
            fi_l.append(func[valid].astype(np.int32))
            off_l.append(med[valid].astype(np.int32))
            wt_l.append(w[valid].astype(np.float32))
        keys = (np.concatenate(keys_l) if keys_l
                else np.zeros(0, np.int64))
        return (keys,
                np.concatenate(fi_l) if fi_l else np.zeros(0, np.int32),
                np.full(len(keys), -1, dtype=np.int32),
                np.concatenate(off_l) if off_l else np.zeros(0, np.int32),
                np.concatenate(wt_l) if wt_l else np.zeros(0, np.float32))

    def to_signature_db(self) -> SignatureDB:
        keys, fi, oi, avg_off, wt = self.to_arrays()
        return SignatureDB(keys, fi, oi, avg_off, wt,
                           functions=self.fm.functions_by_index())

    def write_data_dir(self, out_dir: str, mem_map: bool = False,
                       final_kmers: bool = True, npz: bool = True) -> None:
        os.makedirs(out_dir, exist_ok=True)
        write_index_file(os.path.join(out_dir, "function.index"),
                         self.fm.functions_by_index())
        open(os.path.join(out_dir, "otu.index"), "w").close()
        with open(os.path.join(out_dir, "genomes"), "w") as f:
            f.write("empty genomes\n")
        if final_kmers:
            self.write_final_kmers(os.path.join(out_dir, "final.kmers"))
        if npz or mem_map:
            db = self.to_signature_db()
            if npz:
                db.save_npz(os.path.join(out_dir, "signature_db.npz"))
            if mem_map:
                db.save_mem_map(os.path.join(out_dir, "kmer.table.mem_map"))


def build_signature_kmers_external(
    fasta_paths: list[str],
    kept_function_fasta_paths: list[str] = (),
    def_paths: list[str] = (),
    min_reps_required: int = 5,
    good_functions: list[str] = (),
    good_roles: list[str] = (),
    work_dir: str | None = None,
    buffer_records: int = 16_000_000,
    progress=None,
) -> ExternalBuildResult:
    """Out-of-core variant of build_signature_kmers: peak RAM is
    O(buffer_records + largest shard), not O(total kmers).  Outputs are
    byte-identical to the in-memory path."""
    import tempfile

    fm = FunctionMap()
    fm.good_functions.update(good_functions)
    fm.good_roles.update(good_roles)
    for p in def_paths:
        fm.load_id_assignments(p)
    all_fastas = []
    for p in fasta_paths:
        fm.load_fasta_file(p, False)
        all_fastas.append(p)
    for p in kept_function_fasta_paths:
        fm.load_fasta_file(p, True)
        all_fastas.append(p)
    fm.process_kept_functions(min_reps_required)

    n_funcs = len(fm.function_index)
    seqs_with_func = np.zeros(max(n_funcs, 1), dtype=np.int64)
    work = work_dir or tempfile.mkdtemp(prefix="ck_build_")
    spill = _ShardSpiller(os.path.join(work, "spill"), buffer_records)
    total_extracted = 0
    for file_number, p in enumerate(all_fastas):
        for k, f, o, s in _iter_seq_kmers(fm, p, file_number, seqs_with_func):
            spill.add(k, f, o, s)
            total_extracted += len(k)
        if progress:
            progress(f"extracted {file_number + 1}/{len(all_fastas)} files, "
                     f"{total_extracted:,} kmers")

    kept_dir = os.path.join(work, "kept")
    os.makedirs(kept_dir, exist_ok=True)
    kept_paths: list[str] = []
    ks = 0
    seq_uniques: list[np.ndarray] = []
    shard_files = spill.shard_files()
    for i, sf in enumerate(shard_files):
        rec = np.fromfile(sf, dtype=_SPILL_DTYPE)
        order = np.lexsort((rec["func"], rec["key"]))
        keys, med, func, nsi, nsifj, kept_seq = _group_kept(
            rec["key"][order], rec["func"][order], rec["off"][order],
            rec["seq"][order])
        del rec, order
        kept = np.empty(len(keys), dtype=_KEPT_DTYPE)
        kept["key"], kept["med"], kept["func"] = keys, med, func
        kept["nsi"], kept["nsifj"] = nsi, nsifj
        kp = os.path.join(kept_dir, os.path.basename(sf) + ".kept")
        kept.tofile(kp)
        kept_paths.append(kp)
        ks += len(keys)
        seq_uniques.append(np.unique(kept_seq))
        os.remove(sf)
        if progress and (i + 1) % 64 == 0:
            progress(f"grouped shard {i + 1}/{len(shard_files)}")

    nsf = len(np.unique(np.concatenate(seq_uniques))) if seq_uniques else 0
    stats = dict(
        distinct_signatures=ks,
        num_seqs_with_a_signature=nsf,
        seqs_with_func=seqs_with_func,
        total_kmers_extracted=total_extracted,
    )
    return ExternalBuildResult(fm, kept_paths, seqs_with_func, nsf, ks, stats)
