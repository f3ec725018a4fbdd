"""Small CLI tools mirroring the reference's auxiliary binaries, torch
port of ``close_kmers_tpu/cli/tools.py``.

    python -m close_kmers_tpu_torch.cli.tools <tool> ... [--device cuda]

* kfile          — FASTA stdin -> CALL + OTU-COUNTS lines
                   (kfile.cc:19-52)
* fastq_to_protein — FASTQ -> 6-frame ORF fragments > 10 aa as FASTA
                   ``>id:frame:i`` (fastq_to_protein.cc:14-58)
* validate_fasta / validate_fastq — syntax validators printing
                   valid/n_seqs/total_size/mean/stddev or the first error
                   (validate_fasta.cc:12-82, validate_fastq.cc)
* unique_prots   — group proteins by their signature-kmer hit set
                   (unique_prots.cc:64-108)

The two tools that annotate, kfile and unique_prots, take ``--device``
(default ``cuda``, which raises without a card; ``cpu`` is the explicit
CPU mode).  unique_prots reads the batch's hit arrays from
``KmerEngine.annotate_with_hits``: the port's engine keeps no last batch
(``hits_compact``).
"""

from __future__ import annotations

import argparse
import math
import sys


def _device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) or cpu")

def kfile_main(argv=None):
    """kfile <kmer-data-dir> < input.fasta"""
    ap = argparse.ArgumentParser(prog="kfile")
    ap.add_argument("data_dir")
    ap.add_argument("--min-hits", type=int, default=5)
    ap.add_argument("--max-gap", type=int, default=200)
    _device_arg(ap)
    args = ap.parse_args(argv)

    from ..params import EngineParams
    from ..core import oracle as O
    from ..core.api import KmerEngine
    from ..db.signature_db import SignatureDB
    from ..io.fasta import parse_fasta_bytes

    from ..utils.device import resolve_device
    device = resolve_device(args.device)   # raises for cuda without a card
    db = SignatureDB.load_dir(args.data_dir)
    eng = KmerEngine(db, device)
    params = EngineParams(min_hits=args.min_hits, max_gap=args.max_gap)
    items = [(i, s) for i, d, s in parse_fasta_bytes(sys.stdin.buffer.read())]
    for r in eng.annotate(items, params, want_otu=True):
        for c in r.calls:
            sys.stdout.write(O.format_call(c, eng.function_of))
        sys.stdout.write(O.format_otu_stats(r.seq_id, r.seq_len, r.otu))
    return 0


def fastq_to_protein_main(argv=None):
    ap = argparse.ArgumentParser(prog="fastq_to_protein")
    ap.add_argument("fastq_file")
    ap.add_argument("-o", "--output-file", default=None)
    args = ap.parse_args(argv)

    from ..io.fasta import FastqParser
    from ..ops.translate import get_possible_proteins

    out = open(args.output_file, "w") if args.output_file else sys.stdout

    def on_seq(sid, seq):
        if not sid:
            return
        for frame, prots in get_possible_proteins(seq):
            for i, prot in enumerate(prots, start=1):
                if len(prot) > 10:
                    out.write(f">{sid}:{frame}:{i}\n{prot}\n")

    p = FastqParser(on_seq=on_seq)
    with open(args.fastq_file, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            p.parse_chunk(chunk)
    p.parse_complete()
    if out is not sys.stdout:
        out.close()
    return 0


def _validate(path: str, parser_cls) -> int:
    sizes = []
    total = 0
    state = {"valid": True, "err": "", "line": 0}

    def on_seq(sid, seq):
        if sid:
            sizes.append(len(seq))
            nonlocal_total[0] += len(seq)

    nonlocal_total = [0]

    def on_error(err, line, sid):
        state["valid"] = False
        state["err"] = err
        state["line"] = line
        return False

    p = parser_cls(on_seq=on_seq, on_error=on_error)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            p.parse_chunk(chunk)
    p.parse_complete()
    total = nonlocal_total[0]

    if state["valid"]:
        print("valid\t1")
        print(f"n_seqs\t{len(sizes)}")
        if sizes:
            n = float(len(sizes))
            mean = total / n
            stddev = 0.0
            if len(sizes) > 1:
                accum = sum((s - mean) ** 2 for s in sizes)
                stddev = math.sqrt(accum / (n - 1.0))
            print(f"total_size\t{total}")
            print(f"mean\t{mean:.2f}")
            print(f"stddev\t{stddev:.2f}")
        return 0
    print("valid\t0")
    print(f"n_seqs\t{len(sizes)}")
    print(f"error_message\t{state['err']}")
    print(f"error_line\t{state['line']}")
    return 0


def validate_fasta_main(argv=None):
    ap = argparse.ArgumentParser(prog="validate_fasta")
    ap.add_argument("fasta_file")
    args = ap.parse_args(argv)
    from ..io.fasta import FastaParser
    return _validate(args.fasta_file, FastaParser)


def validate_fastq_main(argv=None):
    ap = argparse.ArgumentParser(prog="validate_fastq")
    ap.add_argument("fastq_file")
    args = ap.parse_args(argv)
    from ..io.fasta import FastqParser
    return _validate(args.fastq_file, FastqParser)


def unique_prots_main(argv=None):
    """Group input proteins by their set of signature-kmer hits
    (unique_prots.cc:64-108): prints one group per line as
    ``n_members \\t id1 id2 ...`` for groups keyed by identical hit sets."""
    ap = argparse.ArgumentParser(prog="unique_prots")
    ap.add_argument("data_dir")
    ap.add_argument("fasta_file")
    _device_arg(ap)
    args = ap.parse_args(argv)

    from ..core.api import KmerEngine
    from ..db.signature_db import SignatureDB
    from ..io.fasta import parse_fasta_file
    from ..utils.device import resolve_device

    device = resolve_device(args.device)   # raises for cuda without a card
    db = SignatureDB.load_dir(args.data_dir)
    eng = KmerEngine(db, device)
    items = [(i, s) for i, d, s in parse_fasta_file(args.fasta_file)]
    _, h = eng.annotate_with_hits(items)
    groups: dict[tuple, list[str]] = {}
    for s, (sid, _seq) in enumerate(items):
        a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
        key = tuple(sorted(set(int(c) for c in h["code"][a:b])))
        groups.setdefault(key, []).append(sid)
    for key in sorted(groups, key=lambda k: (len(groups[k]), k), reverse=True):
        ids = groups[key]
        print(f"{len(ids)}\t" + " ".join(ids))
    return 0


_TOOLS = {
    "kfile": kfile_main,
    "fastq_to_protein": fastq_to_protein_main,
    "validate_fasta": validate_fasta_main,
    "validate_fastq": validate_fastq_main,
    "unique_prots": unique_prots_main,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in _TOOLS:
        print("usage: tools.py <%s> ..." % "|".join(_TOOLS), file=sys.stderr)
        return 2
    return _TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
