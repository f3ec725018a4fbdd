"""Measurement entry points of the port, run as
``python -m close_kmers_tpu_torch.scripts.<name>``."""
