# Copied from close_kmers_tpu/cli/kclient.py.
"""kclient: command-line client for the kser server (the modern
equivalent of the reference's `kc` test client, kc.cc:218-265,
which streamed FASTA to the server and folded the response).

Streams a FASTA/FASTQ file to any endpoint with chunked writes and prints
the streamed response; optionally folds /query?details=1 HIT lines into
per-function counts like kc's peg-count folding.
"""

from __future__ import annotations

import argparse
import socket
import sys


def stream_request(host: str, port: int, path: str, body_path: str,
                   chunk: int = 1 << 16):
    import os
    size = os.path.getsize(body_path)
    s = socket.create_connection((host, port))
    head = f"POST {path} HTTP/1.1\nContent-length: {size}\n\n"
    s.sendall(head.encode())
    with open(body_path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            s.sendall(data)
    out = []
    while True:
        data = s.recv(1 << 16)
        if not data:
            break
        out.append(data)
    s.close()
    return b"".join(out).decode("latin-1")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kclient")
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument("input", help="FASTA/FASTQ file to stream")
    ap.add_argument("--endpoint", default="/query",
                    help="/query /lookup /add /matrix /fq_lookup or "
                         "/mapping/<key>/<action>")
    ap.add_argument("--param", action="append", default=[],
                    help="query parameter key=value (repeatable)")
    ap.add_argument("--fold-hits", action="store_true",
                    help="fold HIT lines into per-function counts "
                         "(kc.cc peg-count behavior)")
    args = ap.parse_args(argv)

    path = args.endpoint
    if args.param:
        path += "?" + "&".join(args.param)
    resp = stream_request(args.host, args.port, path, args.input)
    # strip the pidgin-HTTP header (up to the first blank line)
    body = resp.split("\n\n", 1)
    body = body[1] if len(body) == 2 else resp

    if args.fold_hits:
        counts: dict[str, int] = {}
        for line in body.split("\n"):
            if line.startswith("HIT\t"):
                cols = line.split("\t")
                if len(cols) >= 5:
                    counts[cols[4]] = counts.get(cols[4], 0) + 1
            elif not line.startswith(("CALL\t", "OTU-COUNTS\t",
                                      "PROTEIN-ID\t")):
                continue
        for fn in sorted(counts, key=lambda k: (-counts[k], k)):
            sys.stdout.write(f"{counts[fn]}\t{fn}\n")
    else:
        sys.stdout.write(body)
    return 0


if __name__ == "__main__":
    sys.exit(main())
