"""kser: the signature-kmer annotation server CLI, torch port of
``close_kmers_tpu/cli/kser.py`` (parity with the reference's kser.cc).

    python -m close_kmers_tpu_torch.cli.kser <port> <kmer-data-dir> --device cuda

* auto-discovers family assets inside the data dir like kser.cc:104-184
  (``families.dat``, ``families.genus_map``, ``families.nr``,
  ``VERSION``, ``families.version``) and preloads the family NR through
  the engine's compact probe;
* ``--device`` (default ``cuda``) names the device; without a card
  ``cuda`` raises, and ``--device cpu`` is the explicit CPU mode;
* ``--listen-port-file`` writes the bound port (kserver.cc:154-159);
* ``--shards N`` range-shards the DB over a 1 x N mesh (the first N
  cards; N entries on one device with ``--device cuda:0`` or ``--device
  cpu``), and ``--routed-probe`` routes each window to its owning shard
  (``parallel/sharding.py``).

The JAX-only options of the JAX CLI are refused: ``--jax-profile-dir``
and the XLA compile cache (``CLOSE_KMERS_JAX_CACHE``).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time


def discover_data_dir(data_dir: str) -> dict:
    """kser.cc:104-184 auto-discovery."""
    found = {}
    for name, key in (("families.dat", "families_file"),
                      ("families.genus_map", "genus_map"),
                      ("families.nr", "nr_path"),
                      ("VERSION", "kmer_version_file"),
                      ("families.version", "families_version_file")):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            found[key] = p
    return found


def warmup_context(ctx) -> None:
    """Run the /query path once (with and without details), and in family
    mode the family best-match path against the root mapping, before the
    listener opens, so the first client request does not pay the kernel
    build, the family table upload and the first launches.  A failure
    here raises: a server whose family path cannot run does not open."""
    import numpy as np
    t0 = time.time()
    rng = np.random.default_rng(0)
    prot = "".join("ACDEFGHIKLMNPQRSTVWY"[i] for i in
                   rng.integers(0, 20, size=300))
    items = [("w", prot)]
    ctx.engine.annotate(items, want_otu=True, want_code=False)
    ctx.engine.annotate(items, want_hits=True, want_otu=True)
    if ctx.family_mode:
        ctx.engine.best_family_matches(items, ctx.mapping_map[""])
    print(f"serving path warmed in {time.time()-t0:.1f}s", file=sys.stderr)


def load_server_context(data_dir: str, args=None, batch_size: int = 2048,
                        overrides: dict | None = None, n_shards: int = 0,
                        routed: bool = False, *, device):
    """Load the signature DB onto ``device``, build the server context
    and its family universe (with the NR preload) from ``data_dir``.
    ``n_shards`` > 0 range-shards the DB over a 1 x n_shards mesh: the
    first n_shards cards for a bare "cuda", or n_shards entries on the
    one device named ("cuda:0", "cpu"); ``routed`` selects the routed
    probe."""
    from ..core.api import KmerEngine
    from ..utils.device import resolve_device
    from ..db import family_db, signature_db
    from ..server.http import ServerContext

    t0 = time.time()
    db = signature_db.SignatureDB.load_dir(data_dir)
    print(f"loaded signature DB: {len(db):,} kmers in {time.time()-t0:.1f}s",
          file=sys.stderr)
    if n_shards:
        from ..parallel.sharding import make_mesh
        device = resolve_device(device)
        cards = device.type == "cuda" and device.index is None
        mesh = make_mesh(1, n_shards,
                         devices=None if cards else [device] * n_shards)
        print(f"serving with {n_shards} table shards"
              + (" (routed probe)" if routed else ""), file=sys.stderr)
        engine = KmerEngine(db, None, mesh=mesh, routed=routed)
    else:
        engine = KmerEngine(db, device)

    found = discover_data_dir(data_dir)
    if overrides:
        found.update({k: v for k, v in overrides.items() if v})
    kmer_version = families_version = ""
    if found.get("kmer_version"):          # explicit --kmer-version string
        kmer_version = found["kmer_version"]
    elif "kmer_version_file" in found:
        with open(found["kmer_version_file"]) as f:
            kmer_version = f.read().strip()
    if found.get("families_version"):
        families_version = found["families_version"]
    elif "families_version_file" in found:
        with open(found["families_version_file"]) as f:
            families_version = f.read().strip()

    family_mode = "families_file" in found
    reps = None
    if args is not None:
        reps_file = getattr(args, "reps_file", None)
        reps_dir = getattr(args, "reps_dir", None)
        # --family-reps accepts a file OR a directory (kser.cc:258-277)
        fr = getattr(args, "family_reps", None)
        if fr:
            if os.path.isdir(fr):
                reps_dir = fr
            else:
                reps_file = fr
        if reps_file or reps_dir:
            reps = family_db.FamilyReps()
            if reps_file:
                reps.load_reps_file(reps_file)
            if reps_dir:
                reps.load_reps_directory(reps_dir)

    ctx = ServerContext(engine, family_mode=family_mode, family_reps=reps,
                        kmer_version=kmer_version,
                        families_version=families_version,
                        batch_size=batch_size)

    if family_mode:
        root = ctx.mapping("")
        t0 = time.time()
        if "genus_map" in found:
            root.load_genus_map(found["genus_map"])
        root.load_families(found["families_file"])
        print(f"loaded families: {len(root.families):,} in "
              f"{time.time()-t0:.1f}s", file=sys.stderr)
        if "nr_path" in found:
            t0 = time.time()
            n = 0
            nr = found["nr_path"]
            if isinstance(nr, list):       # --families-nr (multitoken)
                files = nr
            elif os.path.isdir(nr):
                files = [os.path.join(nr, f) for f in sorted(os.listdir(nr))]
            else:
                files = [nr]
            adapter = _EngineNrAdapter(engine)
            for f in files:
                n += root.load_nr(f, adapter)
            print(f"NR preload: {n:,} proteins in {time.time()-t0:.1f}s",
                  file=sys.stderr)
    return ctx


class _EngineNrAdapter:
    """Gives KmerFamilyMapping.load_nr the hits_of_batch interface,
    backed by the compact probe."""

    def __init__(self, engine):
        self.engine = engine

    def hits_of_batch(self, seqs):
        from ..core import oracle as O
        fa = self.engine.fa
        h = fa.probe_compact(*fa.pad_batch(seqs))
        out = []
        for s in range(len(seqs)):
            a, b = int(h["row_off"][s]), int(h["row_off"][s + 1])
            out.append([O.Hit(oI=int(h["oi"][k]), pos=int(h["pos"][k]),
                              avg_off=int(h["avg_off"][k]),
                              fI=int(h["fi"][k]), wt=float(h["wt"][k]),
                              code=int(h["code"][k]))
                        for k in range(a, b)])
        return out

    def hit_codes_of_batch(self, seqs):
        """Array-native bulk path for load_nr: compact probe, code plane
        only -- no per-hit objects."""
        fa = self.engine.fa
        h = fa.probe_compact(*fa.pad_batch(seqs), want_oi=False,
                             want_avg=False)
        return h["row_off"], h["code"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="kser", description="signature-kmer server (torch + CUDA)")
    ap.add_argument("port", type=int, nargs="?", default=None)
    ap.add_argument("data_dir", nargs="?", default=None)
    ap.add_argument("-l", "--listen-port", type=int, default=None,
                    help="alias for the port positional (kser.cc:61)")
    ap.add_argument("-d", "--kmer-data-dir", default=None,
                    help="alias for the data-dir positional (kser.cc:62)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) or cpu")
    ap.add_argument("--listen-port-file", default=None)
    ap.add_argument("--no-listen", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the pre-listen run of the serving path")
    ap.add_argument("--reps-file", default=None)
    ap.add_argument("--reps-dir", default=None)
    ap.add_argument("--family-reps", default=None,
                    help="family representative pegs, file or directory "
                         "(kser.cc:258-277)")
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--restore", default=None,
                    help="restore mapping state from a /checkpoint file")
    ap.add_argument("--checkpoint-dir", default=".",
                    help="directory for /checkpoint output")
    ap.add_argument("--pid-file", default=None,
                    help="write the server pid to this file (kser.cc:215-245)")
    ap.add_argument("--daemonize", action="store_true",
                    help="run the service in the background (kser.cc:215-245)")
    # explicit overrides of the data-dir auto-discovery (kser.cc:52-75)
    ap.add_argument("--families-file", default=None)
    ap.add_argument("--families-genus-mapping", default=None)
    ap.add_argument("--families-nr", nargs="+", default=None)
    ap.add_argument("--families-version", default=None)
    ap.add_argument("--kmer-version", default=None)
    ap.add_argument("--kmer-family-distribution-file", default=None,
                    help="write the kmer->family distribution after load "
                         "(kser.cc:302-311)")
    # accepted for reference CLI compat; no-ops in this architecture
    for flag in ("--n-kmer-threads", "--n-load-threads",
                 "--n-family-file-threads", "--n-inserter-threads"):
        ap.add_argument(flag, type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--reserve-mapping", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--no-populate-mmap", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--debug-http", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--peg-kmer-data", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--shards", type=int, default=0,
                    help="range-shard the DB across this many devices "
                         "(table axis of a 1 x N mesh)")
    ap.add_argument("--routed-probe", action="store_true",
                    help="with --shards: route windows to their owning "
                         "shard with one all_to_all per direction instead "
                         "of the replicated psum-merge probe")
    # a JAX-only option of the JAX CLI: parsed so that it can be refused
    ap.add_argument("--jax-profile-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.jax_profile_dir:
        ap.error("--jax-profile-dir records a JAX profiler trace; the torch "
                 "server has no JAX")
    if args.shards < 0:
        ap.error("--shards takes a positive number of table shards")
    if args.routed_probe and not args.shards:
        ap.error("--routed-probe routes between table shards: give --shards")
    if os.environ.get("CLOSE_KMERS_JAX_CACHE"):
        ap.error("CLOSE_KMERS_JAX_CACHE sets the XLA compile cache, which "
                 "the torch server does not have; unset it")
    port = args.port if args.port is not None else args.listen_port
    data_dir = args.data_dir or args.kmer_data_dir
    if port is None or data_dir is None:
        ap.error("port and kmer data dir required "
                 "(positionals or -l/-d flags)")
    from ..utils.device import resolve_device
    device = resolve_device(args.device)   # raises for cuda without a card

    if args.daemonize:
        child = os.fork()
        if child:                  # parent records the child pid and exits
            if args.pid_file:
                with open(args.pid_file, "w") as f:
                    f.write(f"{child}\n")
            return 0
        os.setsid()                # kser.cc:233 (fds stay attached, as there)
    elif args.pid_file:
        with open(args.pid_file, "w") as f:
            f.write(f"{os.getpid()}\n")
    overrides = dict(families_file=args.families_file,
                     genus_map=args.families_genus_mapping,
                     nr_path=args.families_nr,
                     families_version=args.families_version,
                     kmer_version=args.kmer_version)
    ctx = load_server_context(data_dir, args, args.batch_size,
                              overrides=overrides, n_shards=args.shards,
                              routed=args.routed_probe, device=device)
    ctx.checkpoint_dir = args.checkpoint_dir
    if args.kmer_family_distribution_file:
        with open(args.kmer_family_distribution_file, "w") as f:
            ctx.mapping("").write_kmer_distribution(f)
        print(f"wrote kmer family distribution to "
              f"{args.kmer_family_distribution_file}", file=sys.stderr)
    if args.restore:
        ctx.restore(args.restore)
        print(f"restored mapping state from {args.restore}", file=sys.stderr)
    if args.no_listen:
        return 0
    if not args.no_warmup:
        warmup_context(ctx)

    from ..server.http import serve
    asyncio.run(serve(ctx, port=port, port_file=args.listen_port_file))
    return 0


if __name__ == "__main__":
    sys.exit(main())
