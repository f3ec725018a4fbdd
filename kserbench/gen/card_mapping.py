"""The family universe of :mod:`gen.scale_mapping`, made with torch on the
run's device.

The same :class:`~gen.scale_mapping.Universe` as the frozen numpy
``scale_mapping``, array for array and string for string: key k of
function ``fi`` maps to the ``1 + k % LO_CARD % 3`` families fi * 3 + j
(j below that degree), in key order.  The keys and functions go up in
blocks of ``block`` keys; each block's degrees, their running sum (the
CSR offsets, int64) and its compressed family ids are made on the device.
The offsets come back block by block, the family ids once all are made,
into host numpy arrays (the port's ``KmerFamilyMapping._bulk_fam`` and
the reference read numpy).  Nothing stays on the device.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .scale_mapping import LO_CARD, Universe, scale_mapping

# keys a block: bounds the device's temporaries (~40 B a key)
CARD_BLOCK = 1 << 26


def _up(a: np.ndarray, dev) -> torch.Tensor:
    """``a`` on ``dev``, read only: the DB's arrays are frozen, and
    ``from_numpy`` warns of that though nothing here writes to them."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a).to(dev)


def card_mapping(keys: np.ndarray, fi: np.ndarray, functions: list,
                 dev, block: int = CARD_BLOCK) -> Universe:
    """``scale_mapping(keys, fi, functions)``, with its CSR made on
    ``dev``."""
    n = len(keys)
    offs = np.empty(n + 1, dtype=np.int64)
    offs[0] = 0
    j3 = torch.arange(3, dtype=torch.int32, device=dev)
    parts = []
    for a in range(0, n, block):
        b = min(n, a + block)
        k = _up(keys[a:b], dev)
        deg = k % LO_CARD % 3 + 1
        del k
        end = torch.cumsum(deg, 0).add_(int(offs[a]))
        torch.from_numpy(offs[a + 1:b + 1]).copy_(end)
        del end
        # each key's three candidates fi * 3 + j, the first deg kept,
        # compressed in key order
        cand = _up(fi[a:b], dev)[:, None] * 3 + j3
        parts.append(cand[j3 < deg[:, None]])
        del cand, deg
    vals = np.empty(int(offs[-1]), dtype=np.int32)
    for a, part in zip(range(0, n, block), parts):
        torch.from_numpy(vals[offs[a]:offs[a] + len(part)]).copy_(part)
    # the families' fields: the frozen builder's, over no keys
    return dataclasses.replace(scale_mapping(keys[:0], fi[:0], functions),
                               keys=keys, offs=offs, vals=vals)
