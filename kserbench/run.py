"""Run one cell of the port's benchmark and print its result line.

    python3 kserbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

from the root of a checkout holding ``close_kmers_tpu_torch`` and
``BENCHMARK.json``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last); the numbers compared
and their limits are also the last lines of standard error.  Without a
CUDA card, or with fewer than the cell asks for, it exits 1 and prints
no result.  ``--control 1`` also judges the reference in bfloat16 on the
same sample (the control of the check) and reports it under
``control``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.monotonic()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from kserbench.harness.cell import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), control=bool(args.control),
                      t_start=T_START)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
