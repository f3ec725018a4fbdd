"""Port of scripts/make_scale_db.py: PATRIC-density signature DBs at scale.

Two ways to a DB of ~2.1e8 signature kmers (BENCH_SCALE.json's 208M
point):

* :func:`main`, the JAX script's command on the port's out-of-core
  builder (``db/builder.py::build_signature_kmers_external``): a
  synthetic annotated-protein corpus of N genomes sharing a function
  vocabulary (so every function passes the min-reps keep rule,
  build_signature_kmers.cc:432-488), built without holding every kmer in
  RAM, written as a loadable DB directory::

      <out>/scale_db.npz        keys/fi/oi/avg_off/wt (uncompressed savez)
      <out>/function.index
      <out>/BUILD_STATS.json    kmer counts, peak RSS, wall times

      python -m close_kmers_tpu_torch.scripts.make_scale_db --out DIR \\
          [--target-kmers 2.1e8] [--aa-bias]

  Its arrays and function.index equal the JAX script's for the same
  arguments.

* :func:`scale_db`, the seeded in-memory generator that chip_smoke.py's
  scale phase uses: exactly ``n_keys`` distinct kmer codes whose eight
  residues are drawn uniformly or at :data:`AA_FREQ` (the ``--aa-bias``
  skew), drawn, sorted and de-duplicated by torch on ``device`` (seconds
  for 2.1e8 keys on a card), with a random function of ``n_funcs``, an
  average offset and a weight per key.  The numbers depend on the seed
  and on the device's generator.

:func:`scale_mapping` lays the JAX scale serve's family universe
(scripts/scale_1e9_serve.py: 1-3 families a key, derived from its lo
code and function) over such a DB, for the family path at scale.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from ..db.family_db import FamilyData, KmerFamilyMapping
from ..db.signature_db import SignatureDB
from ..params import K, LO_CARD
from ..utils.device import resolve_device

ALPHA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

# Approximate natural amino-acid frequencies (UniProt/Swiss-Prot order
# matched to ALPHA): biased sampling skews the hi-bucket occupancy the
# way real PATRIC proteins do (deep buckets around common-aa prefixes,
# cf. the reference's bucket statistics kguts.h:259-261) instead of the
# uniform ~Poisson depths a flat-random corpus produces.
AA_FREQ = np.array([8.25, 1.38, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84,
                    9.66, 2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87,
                    1.08, 2.92])
AA_FREQ = AA_FREQ / AA_FREQ.sum()

PROT_LEN = 258     # the JAX script's default protein length
N_FUNCS = 2000     # its default function vocabulary


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def gen_corpus(corpus_dir: str, n_genomes: int, prots_per_genome: int,
               prot_len: int, n_funcs: int,
               aa_bias: bool = False) -> list[str]:
    """The JAX script's corpus: genome g's proteins from numpy seed 1000 +
    g, protein p annotated "Synthetic function {p % n_funcs}"."""
    os.makedirs(corpus_dir, exist_ok=True)
    files = []
    for g in range(n_genomes):
        path = os.path.join(corpus_dir, f"genome{g}.fa")
        files.append(path)
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(1000 + g)
        probs = AA_FREQ if aa_bias else None
        chars = ALPHA[rng.choice(20, size=prots_per_genome * prot_len,
                                 p=probs)]
        chars = chars.reshape(prots_per_genome, prot_len)
        with open(path, "w") as f:
            for p in range(prots_per_genome):
                f.write(f">fig|{g + 1}.1.peg.{p + 1} "
                        f"Synthetic function {p % n_funcs}\n")
                f.write(chars[p].tobytes().decode("latin-1"))
                f.write("\n")
        print(f"wrote {path}", flush=True)
    return files


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--target-kmers", type=float, default=2.1e8)
    ap.add_argument("--n-genomes", type=int, default=10)
    ap.add_argument("--prot-len", type=int, default=PROT_LEN)
    ap.add_argument("--n-funcs", type=int, default=N_FUNCS)
    ap.add_argument("--buffer-records", type=int, default=16_000_000)
    ap.add_argument("--aa-bias", action="store_true",
                    help="sample residues at natural aa frequencies "
                         "(PATRIC-like skewed bucket depths)")
    args = ap.parse_args(argv)

    from ..db.builder import build_signature_kmers_external
    from ..db.signature_db import write_index_file

    windows_per_prot = args.prot_len - 7
    prots_per_genome = int(args.target_kmers
                           / (args.n_genomes * windows_per_prot)) + 1
    os.makedirs(args.out, exist_ok=True)

    t0 = time.time()
    files = gen_corpus(os.path.join(args.out, "corpus"), args.n_genomes,
                       prots_per_genome, args.prot_len, args.n_funcs,
                       aa_bias=args.aa_bias)
    t_corpus = time.time() - t0
    print(f"corpus: {args.n_genomes} genomes x {prots_per_genome} proteins "
          f"x {args.prot_len} aa in {t_corpus:.0f}s", flush=True)

    t0 = time.time()
    r = build_signature_kmers_external(
        files, work_dir=os.path.join(args.out, "work"),
        buffer_records=args.buffer_records,
        progress=lambda m: print(m, flush=True))
    t_build = time.time() - t0
    print(f"external build: {r.stats['distinct_signatures']:,} signatures "
          f"from {r.stats['total_kmers_extracted']:,} extracted in "
          f"{t_build:.0f}s, peak RSS {peak_rss_gb():.1f} GB", flush=True)

    # assemble the probe-table arrays (vectorized; skips final.kmers text)
    t0 = time.time()
    keys, fi, oi, avg_off, wt = r.to_arrays()
    if not (np.diff(keys) > 0).all():
        raise RuntimeError("global key order violated")
    np.savez(os.path.join(args.out, "scale_db.npz"), keys=keys, fi=fi,
             oi=oi, avg_off=avg_off, wt=wt)
    write_index_file(os.path.join(args.out, "function.index"),
                     r.fm.functions_by_index())
    t_out = time.time() - t0

    stats = dict(
        n_kmers=int(len(keys)),
        distinct_signatures=int(r.stats["distinct_signatures"]),
        total_extracted=int(r.stats["total_kmers_extracted"]),
        n_hi_buckets=int(keys.max() // LO_CARD - keys.min() // LO_CARD + 1),
        corpus_s=round(t_corpus, 1),
        build_s=round(t_build, 1),
        output_s=round(t_out, 1),
        peak_rss_gb=round(peak_rss_gb(), 2),
    )
    with open(os.path.join(args.out, "BUILD_STATS.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats), flush=True)
    return 0


def _draw_codes(n: int, aa_bias: bool, gen: torch.Generator,
                dev) -> torch.Tensor:
    """``n`` int64 kmer codes, K residues each, drawn uniformly or at
    :data:`AA_FREQ`."""
    if not aa_bias:
        return torch.randint(0, 20 ** K, (n,), generator=gen, device=dev,
                             dtype=torch.int64)
    cdf = torch.tensor(np.cumsum(AA_FREQ)[:-1], dtype=torch.float32,
                       device=dev)
    code = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(K):
        u = torch.rand(n, generator=gen, device=dev)
        code.mul_(20).add_(torch.searchsorted(cdf, u, right=True))
        del u
    return code


def scale_codes(n_keys: int, aa_bias: bool, seed: int,
                device) -> torch.Tensor:
    """Exactly ``n_keys`` distinct kmer codes, sorted, on ``device``: draws
    of :func:`_draw_codes` until that many are distinct, then a random
    ``n_keys`` of them (so that no range of codes is favoured)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = torch.zeros(0, dtype=torch.int64, device=dev)
    while len(keys) < n_keys:
        more = int((n_keys - len(keys)) * 1.05) + 1024
        keys = torch.unique(torch.cat([keys, _draw_codes(more, aa_bias, gen,
                                                         dev)]))
    if len(keys) > n_keys:
        keep = torch.randperm(len(keys), generator=gen, device=dev)[:n_keys]
        keys = keys[torch.sort(keep).values]
    return keys


def scale_db(n_keys: int, aa_bias: bool = False, n_funcs: int = N_FUNCS,
             seed: int = 0, device="cuda") -> SignatureDB:
    """A signature DB of exactly ``n_keys`` kmers at the scale script's
    densities (uniform residues, or :data:`AA_FREQ` with ``aa_bias``),
    generated by torch on ``device`` from ``seed``: each key gets a
    uniform function of ``n_funcs`` (named "Synthetic function i"), oi
    -1 (as the builder writes), an average offset in [0, PROT_LEN - K)
    and a weight in [0.1, 3)."""
    dev = resolve_device(device)
    keys = scale_codes(n_keys, aa_bias, seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    fi = torch.randint(0, n_funcs, (n_keys,), generator=gen, device=dev,
                       dtype=torch.int32)
    avg_off = torch.randint(0, PROT_LEN - K, (n_keys,), generator=gen,
                            device=dev, dtype=torch.int32)
    wt = torch.rand(n_keys, generator=gen, device=dev).mul_(2.9).add_(0.1)
    return SignatureDB(
        keys.cpu().numpy(), fi.cpu().numpy(),
        np.full(n_keys, -1, dtype=np.int32), avg_off.cpu().numpy(),
        wt.cpu().numpy(),
        functions=[f"Synthetic function {i}" for i in range(n_funcs)])


# keys a block of scale_mapping's CSR build: bounds its numpy temporaries
MAPPING_BLOCK = 1 << 24


def scale_mapping(db: SignatureDB) -> KmerFamilyMapping:
    """The family universe of scripts/scale_1e9_serve.py over ``db``: key
    k of lo code ``lo`` and function ``fi`` maps to the 1 + lo % 3
    families fi * 3 + j (j below its degree), and family f is
    ``FamilyData("PGF_%08d" % f, "PLF_{f % 5}_%08d" % f, f % 5, the DB's
    function f // 3, f, 10, 10)``, 3 x len(db.functions) families in all.
    Its kmer->family CSR is built straight from ``db.keys`` (sorted and
    distinct, so they are the CSR's keys) in blocks of MAPPING_BLOCK
    keys, and handed to the mapping as its bulk CSR, as ``load_nr``
    leaves it."""
    n = len(db)
    offs = np.zeros(n + 1, dtype=np.int64)
    for a in range(0, n, MAPPING_BLOCK):
        b = min(n, a + MAPPING_BLOCK)
        np.cumsum(1 + db.lo[a:b] % 3, out=offs[a + 1:b + 1])
        offs[a + 1:b + 1] += offs[a]
    vals = np.empty(int(offs[-1]), dtype=np.int32)
    j3 = np.arange(3, dtype=np.int32)
    for a in range(0, n, MAPPING_BLOCK):
        b = min(n, a + MAPPING_BLOCK)
        # each key's three candidates fi * 3 + j, the first 1 + lo % 3
        # kept, compressed in key order: the CSR values of keys [a, b)
        cand = db.fi[a:b, None] * 3 + j3
        keep = j3 < (1 + db.lo[a:b] % 3)[:, None]
        vals[offs[a]:offs[b]] = cand[keep]
    mapping = KmerFamilyMapping()
    fns = db.functions
    mapping.families = [
        FamilyData(f"PGF_{f:08d}", f"PLF_{f % 5}_{f:08d}", f % 5,
                   fns[f // 3] if f // 3 < len(fns) else f"fn{f // 3}", f,
                   10, 10)
        for f in range(3 * len(fns))]
    mapping._bulk_fam = (db.keys, offs, vals)
    return mapping


if __name__ == "__main__":
    sys.exit(main())
