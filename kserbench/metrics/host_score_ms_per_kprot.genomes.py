"""Host scoring (native/api.py score_batch and best_call_batch,
core/family.py find_best_family_matches_batch): wall time per 1,000
proteins."""

from kserbench.harness import layers as L
from kserbench.harness.spans import HOST_SCORE


def read(run):
    if run.recorder is None:
        return None
    return L.ms_per_kprot(L.span_seconds(run, HOST_SCORE),
                          L.proteins(L.window_jobs(run)))
