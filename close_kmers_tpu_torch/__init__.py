"""close_kmers_tpu_torch: the PyTorch + CUDA port of close_kmers_tpu.

The JAX package ``close_kmers_tpu`` stays the reference; this package
runs the same protein ``/query`` path on an NVIDIA card: window encode
and hit compaction in plain torch, the payload-wide probe's
match-and-select and the run/gap/two-hit scoring state machine as
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use.

Nothing here imports ``jax``.  The port shares the JAX-free host modules
of ``close_kmers_tpu`` (params, encoder, FASTA parsing, the signature and
family DBs, the oracle and the native C++ scorer); ``host.py`` lists
them.
"""
