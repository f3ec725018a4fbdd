"""Engine facade (core/api.py annotate_with_hits): the engine calls' wall
time on the compute thread, per request."""

from kserbench.harness import layers as L


def read(run):
    reqs = L.window_requests(run)
    if not reqs:
        return None
    return 1e3 * sum(L.engine_seconds(r["jobs"]) for r in reqs) / len(reqs)
