# Copied from close_kmers_tpu/cli/kmerge.py.
"""kmerge: merge per-genome DNA-kmer files into a presence/absence (or
count) matrix over resistant/susceptible genome sets, with an optional
in-tool Adaboost feature selector.

Parity with kmerge.cc:

* inputs: a resistant list file + susceptible list file of kmer files
  (``kmer \\t count`` text; names resolved against --kmer-dir unless
  absolute, kmerge.cc:180-199);
* boolean mode: resistant columns default 0 / present=1, susceptible
  columns are INVERTED (default 1 / present=0), so every cell reads
  "indicative of resistance" (:246-250, 348-363);
* count mode (--use-kmer-counts): raw counts, no inversion (:200-240);
* header line ``labels \\t 1...1 \\t 0...0`` unless --no-header;
* --adaboost: deduplicate identical matrix rows (:450-473), then rounds
  of the classic reweighting loop: error = sum of probability mass on
  0-cells, alpha = |0.5*log((1-err+eps)/(err+eps))|, probabilities
  reweighted by exp(∓alpha) and renormalized (:494-607).  Each round
  prints ``error \\t alpha \\t kmers-sharing-the-pattern...``.

KMC binary databases (.kmc_pre/.kmc_suf, kmerge.cc:106-118, :375-400)
are read natively via io.kmc — a file whose name ends in .kmc_pre or
.kmc_suf, or that has a sibling <name>.kmc_pre, is treated as a KMC1
database (same sniffing as kmerge.cc:325-338).

Row order is input order (the reference iterates an unordered_map, so
its row order is unspecified).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


class KmerSet:
    def __init__(self, counts_mode: bool):
        self.counts_mode = counts_mode
        self.files: list[str] = []
        self.default_value: list[int] = []
        self.rows: dict[str, np.ndarray] = {}
        self.pattern_groups: dict[bytes, list[str]] = {}

    def add_files(self, files: list[str], invert: bool) -> None:
        for f in files:
            if f in self.files:
                print(f"error: file {f} is repeated", file=sys.stderr)
                sys.exit(1)
            self.files.append(f)
            self.default_value.append(1 if invert else 0)

    def process_files(self, files: list[str], invert: bool) -> None:
        from ..io.kmc import is_kmc_db
        for f in files:
            idx = self.files.index(f)
            if is_kmc_db(f):
                self._process_kmc(f, idx, invert)
            else:
                self._process_text(f, idx, invert)

    def _process_kmc(self, path: str, idx: int, invert: bool) -> None:
        """kmerge.cc:375-400: ReadNextKmer over a KMC database; counts
        go through the same parse_value as text input."""
        from ..io.kmc import read_kmc_db
        for kmer, raw in read_kmc_db(path):
            self._add(kmer, raw, idx, invert)

    def _process_text(self, path: str, idx: int, invert: bool) -> None:
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.rstrip("\n")
                pos = line.find("\t")
                if pos < 0:
                    print(f"Missing tab in {path} line {ln}", file=sys.stderr)
                    sys.exit(1)
                self._add(line[:pos], int(line[pos + 1:]), idx, invert)

    def _add(self, kmer: str, raw: int, idx: int, invert: bool) -> None:
        if self.counts_mode:
            val = raw
        else:
            val = 1 if raw else 0
            if invert:
                val = 1 - val
        row = self.rows.get(kmer)
        if row is None:
            row = np.array(self.default_value, dtype=np.int64)
            self.rows[kmer] = row
        row[idx] = val

    def remove_duplicate_values(self) -> None:
        """kmerge.cc:450-473: keep one representative row per distinct
        pattern; remember all kmers sharing it."""
        kept: dict[str, np.ndarray] = {}
        for kmer, row in self.rows.items():
            key = row.tobytes()
            grp = self.pattern_groups.get(key)
            if grp is None:
                self.pattern_groups[key] = [kmer]
                kept[kmer] = row
            else:
                grp.append(kmer)
        self.rows = kept

    def dump(self, out) -> None:
        for kmer, row in self.rows.items():
            out.write(kmer + "".join(f"\t{int(v)}" for v in row) + "\n")


def adaboost(kset: KmerSet, n_rounds: int, out=sys.stdout) -> None:
    """kmerge.cc:494-607 with the error scan vectorized: each round is a
    matrix-vector product over the (patterns x samples) 0/1 matrix."""
    n = len(kset.default_value)
    eps = 1e-10
    kmers = list(kset.rows.keys())
    mat = np.array([kset.rows[k] for k in kmers], dtype=np.float64)
    alive = np.ones(len(kmers), dtype=bool)
    prob = np.full(n, 1.0 / n)

    for _ in range(n_rounds):
        if not alive.any():
            print("No bestk found", file=sys.stderr)
            sys.exit(1)
        errors = (1.0 - mat) @ prob
        # replicate `error < error_min + epsilon` over iteration order:
        # later entries win near-ties, so choose the LAST index within
        # epsilon of the running minimum.
        err_alive = np.where(alive, errors, np.inf)
        best = None
        error_min = 1.0
        for i in range(len(kmers)):
            if alive[i] and errors[i] < error_min + eps:
                error_min = errors[i]
                best = i
        if best is None:
            print("No bestk found", file=sys.stderr)
            sys.exit(1)
        alpha = abs(0.5 * math.log((1 - error_min + eps) / (error_min + eps)))
        group = kset.pattern_groups.get(mat[best].astype(np.int64).tobytes(),
                                        [kmers[best]])
        out.write(f"{'%g' % error_min}\t{'%g' % alpha}\t"
                  + "\t".join(group) + "\n")
        kvec = mat[best]
        unprob = np.where(kvec > 0, math.exp(-alpha), math.exp(alpha)) * prob
        prob = unprob / unprob.sum()
        alive[best] = False


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmerge")
    ap.add_argument("resistant_file")
    ap.add_argument("susceptible_file")
    ap.add_argument("-d", "--kmer-dir", default="KMERS")
    ap.add_argument("-o", "--output-file", default=None)
    ap.add_argument("--use-kmer-counts", action="store_true")
    ap.add_argument("-a", "--adaboost", action="store_true")
    ap.add_argument("-r", "--rounds", type=int, default=10)
    ap.add_argument("--no-header", action="store_true")
    ap.add_argument("--max-files", type=int, default=-1)
    args = ap.parse_args(argv)

    def read_list(path):
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                if args.max_files >= 0 and i >= args.max_files:
                    break
                line = line.rstrip("\n")
                if not line:
                    continue
                out.append(line if line.startswith("/")
                           else f"{args.kmer_dir}/{line}")
        return out

    res_files = read_list(args.resistant_file)
    sus_files = read_list(args.susceptible_file)

    kset = KmerSet(args.use_kmer_counts)
    invert_sus = not args.use_kmer_counts
    kset.add_files(res_files, False)
    kset.add_files(sus_files, invert_sus)
    kset.process_files(res_files, False)
    kset.process_files(sus_files, invert_sus)

    out = open(args.output_file, "w") if args.output_file else sys.stdout
    if args.adaboost and not args.use_kmer_counts:
        kset.remove_duplicate_values()
        adaboost(kset, args.rounds, out)
    else:
        if not args.no_header:
            out.write("labels" + "\t1" * len(res_files)
                      + "\t0" * len(sus_files) + "\n")
        kset.dump(out)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
