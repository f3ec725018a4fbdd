"""build_signature_kmers CLI: construct a signature-kmer data directory.
Torch port of ``close_kmers_tpu/cli/build_db.py``.

Mirrors the reference builder's main options
(build_signature_kmers.cc:1071-1168): fasta inputs,
kept-function fasta inputs, function definition files, good-function /
good-role lists, min-reps threshold, and the output data dir; plus the
recall and validation harness modes, which annotate through a
``KmerEngine`` on ``--device`` (default ``cuda``, which raises without a
card, before the build; ``cpu`` is the explicit CPU mode).
"""

from __future__ import annotations

import argparse
import os
import sys


def _read_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="build_signature_kmers")
    ap.add_argument("kmer_data_dir", nargs="?", default=None,
                    help="output data directory")
    ap.add_argument("--kmer-data-dir", dest="kmer_data_dir_flag",
                    default=None,
                    help="flag form of the output dir "
                         "(build_signature_kmers.cc:1111)")
    ap.add_argument("--fasta", action="append", default=[],
                    help="annotated protein fasta file (repeatable)")
    ap.add_argument("-F", "--fasta-dir", action="append", default=[],
                    nargs="+",
                    help="directory of annotated protein fastas")
    ap.add_argument("--fasta-keep-functions", action="append", default=[],
                    help="fasta whose functions are always kept")
    ap.add_argument("-K", "--fasta-keep-functions-dir", action="append",
                    default=[], nargs="+",
                    help="directory of kept-function fastas")
    ap.add_argument("--function-defs", action="append", default=[],
                    help="id<TAB>function assignment file")
    ap.add_argument("-D", "--definition-dir", action="append", default=[],
                    nargs="+",
                    help="directory of function definition files")
    ap.add_argument("--good-functions", action="append", default=[],
                    help="file of functions to always keep (repeatable)")
    ap.add_argument("--good-roles", action="append", default=[],
                    help="file of roles to always keep (repeatable)")
    ap.add_argument("--min-reps-required", type=int, default=5)
    ap.add_argument("--final-kmers", default=None,
                    help="extra path for the text kmer table")
    ap.add_argument("--mem-map", action="store_true",
                    help="also write the reference-format kmer.table.mem_map")
    ap.add_argument("--recall-output", default=None,
                    help="directory for recall mode output (Calls/, New/)")
    ap.add_argument("--recall-min-hits", type=int, default=5)
    ap.add_argument("--recall-max-gap", type=int, default=200)
    ap.add_argument("--validation-folder", default=None,
                    help="folder with anno/ + seq/ for validation mode")
    ap.add_argument("--validation-verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the recall and validation "
                         "engine: cuda (default; raises without a card) "
                         "or cpu")
    ap.add_argument("--n-threads", type=int, default=1,
                    help="accepted for reference CLI compat; the batched "
                         "engine replaces thread-level parallelism")
    ap.add_argument("--external", action="store_true",
                    help="out-of-core build: spill extracted kmers to "
                         "disk shards (RAM stays O(buffer + one shard))")
    ap.add_argument("--work-dir", default=None,
                    help="spill directory for --external (default: temp)")
    ap.add_argument("--buffer-records", type=int, default=16_000_000,
                    help="spill buffer size for --external")
    args = ap.parse_args(argv)

    out_dir = args.kmer_data_dir or args.kmer_data_dir_flag
    if not out_dir:
        ap.error("output data dir required (positional or --kmer-data-dir)")

    device = None
    if args.recall_output or args.validation_folder:
        from ..utils.device import resolve_device
        device = resolve_device(args.device)   # raises for cuda without a card

    from ..db.builder import (build_signature_kmers,
                               build_signature_kmers_external)

    def expand(dir_groups):
        files = []
        for group in dir_groups:
            for d in (group if isinstance(group, list) else [group]):
                files.extend(os.path.join(d, f)
                             for f in sorted(os.listdir(d)))
        return files

    fastas = list(args.fasta) + expand(args.fasta_dir)
    keeps = list(args.fasta_keep_functions) \
        + expand(args.fasta_keep_functions_dir)
    defs = list(args.function_defs) + expand(args.definition_dir)

    good_functions = [g for p in args.good_functions for g in _read_list(p)]
    good_roles = [g for p in args.good_roles for g in _read_list(p)]

    if args.external:
        result = build_signature_kmers_external(
            fastas, keeps, defs,
            args.min_reps_required, good_functions, good_roles,
            work_dir=args.work_dir, buffer_records=args.buffer_records,
            progress=lambda m: print(m, file=sys.stderr))
    else:
        result = build_signature_kmers(
            fastas, keeps, defs,
            args.min_reps_required, good_functions, good_roles)
    print(f"kept {len(result.fm.function_index)} functions", file=sys.stderr)
    print(f"Kept {result.stats['distinct_signatures']} kmers", file=sys.stderr)
    print(f"distinct_signatures={result.stats['distinct_signatures']}",
          file=sys.stderr)
    print("num_seqs_with_a_signature="
          f"{result.stats['num_seqs_with_a_signature']}", file=sys.stderr)

    result.write_data_dir(out_dir, mem_map=args.mem_map)
    if args.final_kmers:
        result.write_final_kmers(args.final_kmers)

    if args.recall_output or args.validation_folder:
        from ..db.recall import run_recall, run_validation
        from ..core.api import KmerEngine
        eng = KmerEngine(result.to_signature_db(), device)
        if args.recall_output:
            run_recall(eng, result.fm, fastas, args.recall_output,
                       args.recall_min_hits, args.recall_max_gap)
        if args.validation_folder:
            run_validation(eng, args.validation_folder,
                           args.recall_min_hits, args.recall_max_gap,
                           verbose=args.validation_verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
