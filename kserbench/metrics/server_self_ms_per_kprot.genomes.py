"""Server layer (server/http.py): the handlers' time outside their engine
calls (submission to the compute thread through the call's end), per
1,000 proteins."""

from kserbench.harness import layers as L


def read(run):
    reqs = L.window_requests(run)
    return L.ms_per_kprot(sum(L.self_seconds(r) for r in reqs),
                          sum(L.proteins(r["jobs"]) for r in reqs))
