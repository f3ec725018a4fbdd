"""Run one cell traced and report what its result line does not hold: the
program's own readings, the device's idle gaps by the program's innermost
span, and the traced run's end-to-end metrics, with the program's tracing
on or off (its cost).

    python3 kserbench/trace_report.py --workload <cell> --seed <n> \\
        --seconds <s> [--program-spans 0|1]

from the root of a checkout, as ``run.py``.  The last line of standard
output is one JSON object: ``result`` (``run.py``'s result line),
``end_to_end`` (the cell's end-to-end metrics read on the traced run),
``program`` (``harness/program_spans.py`` ``readings``),
``idle_by_program_span`` (seconds, ``idle_by_span``), ``span_totals``
(the window's jobs' and requests' program spans by name: count, wall s,
thread CPU s) and ``program_spans``; the program's parts are empty with
``--program-spans 0`` or a program without spans.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.monotonic()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None, spec=None, device: str = "cuda") -> int:
    """``spec`` and ``device``: as :func:`harness.cell.run_cell`'s (tests:
    a tiny cell on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from kserbench.harness import cell, program_spans as P
    from kserbench.harness.spec import Spec
    spec = spec or Spec()
    runs = []

    class Captured(cell.Run):
        def __init__(self, **kw):
            super().__init__(**kw)
            runs.append(self)

    saved = cell.Run
    cell.Run = Captured
    try:
        with (P.program_tracing() if args.program_spans
              else contextlib.nullcontext()):
            result = cell.run_cell(args.workload, args.seed, args.seconds,
                                   True, device, spec, t_start=T_START)
    finally:
        cell.Run = saved
    run = runs[-1]
    e2e = {m["name"]: spec.reader(m["name"])(run)
           for m in spec.metrics(args.workload, False)}
    sys.stderr.flush()
    print(json.dumps(dict(result=result, end_to_end=e2e,
                          program={k: v for k, v in P.readings(run).items()
                                   if v is not None},
                          idle_by_program_span=P.idle_by_span(run),
                          span_totals=P.window_totals(run),
                          program_spans=bool(args.program_spans))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
