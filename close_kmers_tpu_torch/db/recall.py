# Copied from close_kmers_tpu/db/recall.py.
"""Recall and validation harness: the builder's built-in accuracy check
(build_signature_kmers.cc:909-1026).

* recall: re-annotate the training fastas with the just-built signatures;
  write per-genome Calls/ (``id \\t new_function \\t score \\t weighted``)
  and New/ (``id \\t old \\t new`` for changed annotations) files
  (:947-978).
* validation: annotate seq/ fastas and compare against the anno/ truth
  set, printing ``<file>: count=N correct=N incorrect=N missing=N``
  (:984-1026).
"""

from __future__ import annotations

import os
import sys

from ..params import EngineParams
from ..core import oracle as O
from ..io.fasta import parse_fasta_file


def _batched_best_calls(engine, items, params):
    out = []
    B = 2048
    for a in range(0, len(items), B):
        res = engine.annotate(items[a:a + B], params, want_best=True)
        out.extend(r.best for r in res)
    return out


def run_recall(engine, fm, fasta_files, out_dir: str,
               min_hits: int = 5, max_gap: int = 200) -> None:
    params = EngineParams(min_hits=min_hits, max_gap=max_gap)
    calls_dir = os.path.join(out_dir, "Calls")
    new_dir = os.path.join(out_dir, "New")
    os.makedirs(calls_dir, exist_ok=True)
    os.makedirs(new_dir, exist_ok=True)
    for path in fasta_files:
        items = [(i, s) for i, _d, s in parse_fasta_file(path) if i]
        bests = _batched_best_calls(engine, items, params)
        leaf = os.path.basename(path)
        with open(os.path.join(calls_dir, leaf), "w") as calls_stream, \
                open(os.path.join(new_dir, leaf), "w") as new_stream:
            for (sid, _seq), best in zip(items, bests):
                old = fm.lookup_function(sid)
                if best.function != old:
                    new_stream.write(f"{sid}\t{old}\t{best.function}\n")
                calls_stream.write(
                    f"{sid}\t{best.function}\t{O.fmt_float(best.score)}\t"
                    f"{O.fmt_float(best.weighted_score)}\n")


def run_validation(engine, validation_folder: str,
                   min_hits: int = 5, max_gap: int = 200,
                   verbose: bool = False, out=sys.stdout) -> dict:
    """anno/ holds id<TAB>function truth files; seq/ holds fastas."""
    from .builder import FunctionMap

    params = EngineParams(min_hits=min_hits, max_gap=max_gap)
    correct = FunctionMap()
    anno_dir = os.path.join(validation_folder, "anno")
    seq_dir = os.path.join(validation_folder, "seq")
    for f in sorted(os.listdir(anno_dir)):
        correct.load_id_assignments(os.path.join(anno_dir, f))

    totals = dict(count=0, correct=0, incorrect=0, missing=0)
    for f in sorted(os.listdir(seq_dir)):
        path = os.path.join(seq_dir, f)
        # Keep empty-id records: recall_sequence returns an empty optional
        # for them (build_signature_kmers.cc:914-915) and validate_fasta
        # then counts them — as `missing` when the truth map knows the id
        # (:1012-1019).  validate_fasta also calls parse_complete() a
        # second time after parse() (:1023-1024), firing one phantom
        # ("", "") record per file that inflates `count` by 1.
        items = [(i, s) for i, _d, s in parse_fasta_file(path)]
        items.append(("", ""))
        called = [(j, it) for j, it in enumerate(items) if it[0]]
        bests = _batched_best_calls(engine, [it for _, it in called], params)
        best_by_pos = {j: b for (j, _), b in zip(called, bests)}
        n_correct = n_incorrect = n_missing = count = 0
        for j, (sid, _seq) in enumerate(items):
            correct_function = correct.lookup_function(sid)
            count += 1
            if not sid:
                if correct_function:
                    n_missing += 1
                continue
            best = best_by_pos[j]
            if best.function == correct_function:
                n_correct += 1
            else:
                if verbose:
                    out.write(f"incorrect\t{sid}\t{correct_function}\t"
                              f"{best.function}\n")
                n_incorrect += 1
        out.write(f"{path}: count={count} correct={n_correct} "
                  f"incorrect={n_incorrect} missing={n_missing}\n")
        totals["count"] += count
        totals["correct"] += n_correct
        totals["incorrect"] += n_incorrect
        totals["missing"] += n_missing
    return totals
