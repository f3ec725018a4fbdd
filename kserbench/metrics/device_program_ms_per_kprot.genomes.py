"""Batch engine (core/engine.py FastAnnotator.probe_compact;
core/device_family.py DeviceFamilyScorer.score_family_packed and the wait
for its readback): the device program's wall time, which ends in its
download, per 1,000 proteins."""

from kserbench.harness import layers as L
from kserbench.harness.spans import DEVICE_PROGRAM


def read(run):
    if run.recorder is None:
        return None
    return L.ms_per_kprot(L.span_seconds(run, DEVICE_PROGRAM),
                          L.proteins(L.window_jobs(run)))
