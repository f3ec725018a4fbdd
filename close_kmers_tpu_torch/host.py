"""The JAX-free host modules of ``close_kmers_tpu`` that the port shares.

None of these imports ``jax`` (``close_kmers_tpu/__init__.py`` does so
only when ``CLOSE_KMERS_JAX_PLATFORM`` is set, which the port's users
leave unset).  The port imports them from this one place, which keeps
its dependency on the reference package in plain view.
"""

from close_kmers_tpu import params
from close_kmers_tpu.core import oracle
from close_kmers_tpu.db import family_db, signature_db
from close_kmers_tpu.io import fasta
from close_kmers_tpu.native import api as native
from close_kmers_tpu.ops import encoder
from close_kmers_tpu.utils import metrics

EngineParams = params.EngineParams
SignatureDB = signature_db.SignatureDB

__all__ = ["EngineParams", "SignatureDB", "encoder", "family_db", "fasta",
           "metrics", "native", "oracle", "params", "signature_db"]
