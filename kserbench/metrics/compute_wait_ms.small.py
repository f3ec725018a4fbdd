"""Server layer (ServerContext's one compute thread): the mean time from a
job's submission to the executor until its engine call starts."""

from kserbench.harness import layers as L


def read(run):
    jobs = L.window_jobs(run)
    if not jobs:
        return None
    return 1e3 * sum(j["start"] - j["submit"] for j in jobs) / len(jobs)
