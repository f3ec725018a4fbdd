# Frozen copy of close_kmers_tpu_torch/scripts/make_scale_db.py at commit 8a7e9d7b116deea5496cfc89e97fd59b7681397e (AA_FREQ, _draw_codes, scale_codes, scale_db), returning plain arrays.
"""The signature DB of a cell, made on the device from the run's seed.

A copy of the port's seeded scale generator, kept here so that a change
to the port cannot move the benchmark's inputs: exactly ``n_keys``
distinct kmer codes whose eight residues are drawn uniformly or at
:data:`AA_FREQ`, drawn, sorted and de-duplicated by torch on ``device``,
with a random function of ``n_funcs``, oi -1, an average offset in
[0, PROT_LEN - K) and a weight in [0.1, 3) per key.  The arrays equal
the port's ``scale_db`` for the same arguments on the same device; the
numbers depend on the seed and on the device's generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

K = 8
ALPHA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

# Approximate natural amino-acid frequencies (UniProt/Swiss-Prot order
# matched to ALPHA)
AA_FREQ = np.array([8.25, 1.38, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84,
                    9.66, 2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87,
                    1.08, 2.92])
AA_FREQ = AA_FREQ / AA_FREQ.sum()

PROT_LEN = 258     # the scale script's protein length (avg_off's range)
N_FUNCS = 2000     # its function vocabulary


@dataclasses.dataclass
class DBArrays:
    """A signature DB as the benchmark holds it: sorted distinct keys and
    one row of payload per key, host arrays, and the function names."""
    keys: np.ndarray      # int64 [n], sorted, distinct
    fi: np.ndarray        # int32 [n]
    oi: np.ndarray        # int32 [n]
    avg_off: np.ndarray   # int32 [n]
    wt: np.ndarray        # float32 [n]
    functions: list

    def __len__(self) -> int:
        return len(self.keys)

    def freeze(self) -> "DBArrays":
        """Make every array read-only, so that nothing handed a view of
        them can change what the reference reads."""
        for a in (self.keys, self.fi, self.oi, self.avg_off, self.wt):
            a.flags.writeable = False
        return self


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
                dev: torch.device) -> torch.Tensor:
    """Exactly ``n_keys`` distinct kmer codes, sorted, on ``dev``: draws
    of :func:`_draw_codes` until that many are distinct, then a random
    ``n_keys`` of them (so that no range of codes is favoured)."""
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


def scale_db(n_keys: int, aa_bias: bool, n_funcs: int, seed: int,
             dev: torch.device) -> DBArrays:
    """The DB of ``n_keys`` kmers at the scale script's densities, made by
    torch on ``dev`` from ``seed`` and copied to the host."""
    keys = scale_codes(n_keys, aa_bias, seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    fi = torch.randint(0, n_funcs, (n_keys,), generator=gen, device=dev,
                       dtype=torch.int32)
    avg_off = torch.randint(0, PROT_LEN - K, (n_keys,), generator=gen,
                            device=dev, dtype=torch.int32)
    wt = torch.rand(n_keys, generator=gen, device=dev).mul_(2.9).add_(0.1)
    return DBArrays(
        keys.cpu().numpy(), fi.cpu().numpy(),
        np.full(n_keys, -1, dtype=np.int32), avg_off.cpu().numpy(),
        wt.cpu().numpy(),
        [f"Synthetic function {i}" for i in range(n_funcs)])
