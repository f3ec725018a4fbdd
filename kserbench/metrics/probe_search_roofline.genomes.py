"""Kernels (ops/probe_search.py -> csrc/probe_search.cu): the probe's
least time at the HBM peak over its kernel time in the trace, with the
bytes of kserbench/roofline/probe_search.py."""

from kserbench.harness import layers as L
from kserbench.roofline import peaks, probe_search as R


def read(run):
    rec = run.recorder
    if rec is None or not rec.probe_launches:
        return None
    n = R.bytes_moved(sum(w for w, _ in rec.probe_launches),
                      rec.found_windows())
    return L.roofline_pct(run, R.KERNELS, n, peaks.HBM_BYTES_PER_S)
