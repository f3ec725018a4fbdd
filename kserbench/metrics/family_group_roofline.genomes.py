"""Kernels (ops/family_group.py -> csrc/family_group.cu): the rollup's
least time at the HBM peak over its kernel time in the trace, with the
bytes of kserbench/roofline/family_group.py."""

from kserbench.harness import layers as L
from kserbench.roofline import family_group as R, peaks


def read(run):
    rec = run.recorder
    if rec is None or not rec.group_launches:
        return None
    n = sum(R.bytes_moved(*g) for g in rec.groups())
    return L.roofline_pct(run, R.KERNELS, n, peaks.HBM_BYTES_PER_S)
