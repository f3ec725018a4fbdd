# Frozen copy of close_kmers_tpu_torch/scripts/make_scale_db.py at commit 8a7e9d7b116deea5496cfc89e97fd59b7681397e (scale_mapping, MAPPING_BLOCK), returning plain arrays.
"""The family universe of a family configuration, laid over its DB.

The JAX scale serve's universe (scripts/scale_1e9_serve.py): key k of lo
code ``lo`` and function ``fi`` maps to the 1 + lo % 3 families
fi * 3 + j (j below its degree), and family f is (PGF "PGF_%08d" % f,
PLF "PLF_{f % 5}_%08d" % f, genus f % 5, the DB's function f // 3),
3 x len(functions) families in all.  The kmer->family CSR is built
straight from the DB's keys (sorted and distinct, so they are the CSR's
keys) in blocks of MAPPING_BLOCK keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LO_CARD = 8000     # 20^3: a key's lo code is key % LO_CARD

# keys a block of the CSR build: bounds its numpy temporaries
MAPPING_BLOCK = 1 << 24


@dataclasses.dataclass
class Universe:
    """A kmer->family CSR over a DB's keys and the families' fields."""
    keys: np.ndarray      # int64 [n]: the DB's keys
    offs: np.ndarray      # int64 [n + 1]
    vals: np.ndarray      # int32 [offs[-1]]: family ids, in list order
    pgf: list             # str [F]
    plf: list             # str [F]
    genus_id: list        # int [F]
    function: list        # str [F]

    def families_of(self, i: int) -> list:
        """The family ids of DB row ``i``, in list order."""
        return [int(v) for v in self.vals[self.offs[i]:self.offs[i + 1]]]

    def freeze(self) -> "Universe":
        for a in (self.offs, self.vals):
            a.flags.writeable = False
        return self


def scale_mapping(keys: np.ndarray, fi: np.ndarray,
                  functions: list) -> Universe:
    """The universe of the scale serve over the DB (``keys``, ``fi``,
    ``functions``)."""
    n = len(keys)
    offs = np.zeros(n + 1, dtype=np.int64)
    for a in range(0, n, MAPPING_BLOCK):
        b = min(n, a + MAPPING_BLOCK)
        np.cumsum(1 + keys[a:b] % LO_CARD % 3, out=offs[a + 1:b + 1])
        offs[a + 1:b + 1] += offs[a]
    vals = np.empty(int(offs[-1]), dtype=np.int32)
    j3 = np.arange(3, dtype=np.int32)
    for a in range(0, n, MAPPING_BLOCK):
        b = min(n, a + MAPPING_BLOCK)
        # each key's three candidates fi * 3 + j, the first 1 + lo % 3
        # kept, compressed in key order: the CSR values of keys [a, b)
        cand = fi[a:b, None] * 3 + j3
        keep = j3 < (1 + keys[a:b] % LO_CARD % 3)[:, None]
        vals[offs[a]:offs[b]] = cand[keep]
    F = 3 * len(functions)
    return Universe(
        keys, offs, vals,
        [f"PGF_{f:08d}" for f in range(F)],
        [f"PLF_{f % 5}_{f:08d}" for f in range(F)],
        [f % 5 for f in range(F)],
        [functions[f // 3] if f // 3 < len(functions) else f"fn{f // 3}"
         for f in range(F)])
