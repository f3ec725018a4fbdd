"""Server layer (server/http.py): the handlers' mean time outside their
engine calls, per request."""

from kserbench.harness import layers as L


def read(run):
    reqs = L.window_requests(run)
    if not reqs:
        return None
    return 1e3 * sum(L.self_seconds(r) for r in reqs) / len(reqs)
