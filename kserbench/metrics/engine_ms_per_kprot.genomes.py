"""Engine facade (core/api.py annotate_with_hits, best_family_matches):
the engine calls' wall time on the compute thread, per 1,000 proteins."""

from kserbench.harness import layers as L


def read(run):
    jobs = L.window_jobs(run)
    return L.ms_per_kprot(L.engine_seconds(jobs), L.proteins(jobs))
