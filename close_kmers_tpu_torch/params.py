# Copied from close_kmers_tpu/params.py.
"""Global kmer engine parameters.

Semantics-parity constants with the reference signature-kmer engine
(see kmer_params.h:5-23 and kguts.cc:236-242 for the
engine defaults).  The TPU build fixes K=8 (the only K the reference's
modern path uses).
"""

from __future__ import annotations

import dataclasses

# Kmer size (kmer_params.h:5).
KMER_SIZE = 8
K = KMER_SIZE

# Base-20 positional encoding constants (kmer_params.h:12,18).
# CORE = 20^(K-1); MAX_ENCODED = 20^K.  An encoded kmer is
# sum(aa_offset[i] * 20^(K-1-i)); any value > MAX_ENCODED is the
# "invalid / empty" sentinel.
CORE = 20 ** (KMER_SIZE - 1)
MAX_ENCODED = 20 ** KMER_SIZE

# Hit buffer size cap (kmer_params.h:20).  The reference's gather loop
# stops growing the run buffer at MAX_HITS_PER_SEQ - 2 (kguts.cc:850-851).
MAX_HITS_PER_SEQ = 40000
HIT_BUFFER_CAP = MAX_HITS_PER_SEQ - 2

# OTU scratch size (kmer_params.h:22); only the top-5 OTU counts are
# reported by format_otu_stats (kguts.cc:966).
OI_BUFSZ = 5

# Split point for the two-level TPU index: a 8-mer code is stored as
# (hi, lo) = (code // 20^LO_DIGITS, code % 20^LO_DIGITS); both fit int32
# so the TPU probe path never needs 64-bit ints.  HI_DIGITS=5 gives 3.2M
# buckets (avg bucket ~6 entries at 20M kmers), shrinking the in-bucket
# binary search to ~5 gather steps — gather OPS dominate probe time on
# TPU, so fewer/wider ops win.
HI_DIGITS = 5
LO_DIGITS = KMER_SIZE - HI_DIGITS
HI_CARD = 20 ** HI_DIGITS  # 3,200,000
LO_CARD = 20 ** LO_DIGITS  # 8,000

# On-disk hash image version (kmer_image.h:6).
KMER_IMAGE_VERSION = 1


@dataclasses.dataclass
class EngineParams:
    """Per-request tunable engine parameters.

    Defaults mirror KmerGuts::set_default_parameters (kguts.cc:236-242);
    the string-keyed override path mirrors KmerGuts::set_parameters
    (kguts.cc:244-268) as driven by URL query parameters.
    """

    order_constraint: int = 0
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200

    @classmethod
    def from_query(cls, params: dict) -> "EngineParams":
        """Build params from a string->string map, ignoring non-integer
        values with a warning, like kguts.cc:244-268."""
        ep = cls()
        for key in ("order_constraint", "min_hits", "min_weighted_hits", "max_gap"):
            if key in params:
                try:
                    setattr(ep, key, int(params[key]))
                except (TypeError, ValueError):
                    pass
        return ep
