# Copied from close_kmers_tpu/cli/propagate_names.py.
"""propagate_names CLI: renumber a new family release against an old one
(parity with propagate_names.cc:703-824)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="propagate_names",
        description="propagate family names between releases")
    ap.add_argument("fam_type", choices=["local", "global"])
    ap.add_argument("old_fams")
    ap.add_argument("old_data")
    ap.add_argument("new_fams")
    ap.add_argument("new_data")
    ap.add_argument("--genus", default="")
    ap.add_argument("--log-file", default=None)
    args = ap.parse_args(argv)

    from ..db.propagate_names import FamData, RenumberState

    old = FamData(args.old_fams, args.old_data, args.genus, args.fam_type)
    old.read_pegsyn()
    old.read_fams_file()
    new = FamData(args.new_fams, args.new_data, args.genus, args.fam_type)
    new.read_pegsyn()
    new.read_fams_file()

    rs = RenumberState(old, new)
    results = rs.run()
    out = open(args.log_file, "w") if args.log_file else sys.stdout
    for line in results:
        out.write(line)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
