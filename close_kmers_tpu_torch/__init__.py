"""close_kmers_tpu_torch: the PyTorch + CUDA port of close_kmers_tpu.

The JAX package ``close_kmers_tpu`` stays the reference; this package
runs the same protein ``/query`` path, family path (``/lookup``,
``find_best_match``, ``/fq_lookup``, ``/add``), ``/matrix`` pair counts
(``core/matrix.py``) and whole-genome annotation (``core/genome.py``
``GenomeAnnotator``) on an NVIDIA card, on every probe tier of the JAX
package, and the probe-gather experiments (``scripts/gather_exp.py``):
window encode, compaction, the row-local family sort, the genome
translate, tiling and carry fixpoint, the matrix CSR gathers and pair
sort, and the fused_wide / lo_wide / binary-search probes in plain
torch; the payload-wide, sub-block and famwide probes, the run/gap/
two-hit scoring state machine, the family row gather, the family
grouping and the four probe-gather floors as hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.

The package stands alone: nothing here imports ``jax`` or anything of
``close_kmers_tpu``.  It keeps its own copies of the JAX package's host
modules (``params``, ``core/dna.py``, ``core/family.py``,
``core/oracle.py``, the signature and family DBs under ``db/``,
``io/fasta.py``, the native C++ scorer under ``native/``,
``ops/encoder.py``, ``ops/translate.py``, ``utils/metrics.py``), each at
its original's path and naming it in its first line.  The native library
builds with g++ into ``.build/``.
"""
