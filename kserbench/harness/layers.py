"""The arithmetic the metric readers share: the window's requests, jobs
and spans, and the device's busy time.  A reading that finds nothing to
read is None, and the harness leaves that metric out."""

from __future__ import annotations

import numpy as np

from . import trace as T


def window_jobs(run) -> list:
    """Jobs of the compute thread submitted in the window that ran."""
    if run.recorder is None:
        return []
    return [j for j in run.recorder.jobs
            if j["start"] is not None and j["end"] is not None]


def window_requests(run) -> list:
    """Handlers started in the window that ended, with their jobs."""
    if run.recorder is None:
        return []
    return [r for r in run.recorder.requests.values()
            if r["end"] is not None
            and all(j["end"] is not None for j in r["jobs"])]


def proteins(jobs: list) -> int:
    return sum(j["n"] for j in jobs)


def ms_per_kprot(seconds: float, n: int):
    return seconds * 1e6 / n if n else None


def span_seconds(run, layer: str) -> float:
    return sum(b - a for name, a, b in run.recorder.spans if name == layer)


def self_seconds(req: dict) -> float:
    """A handler's time outside its engine jobs (submission to end)."""
    return (req["end"] - req["start"]) - sum(j["end"] - j["submit"]
                                             for j in req["jobs"])


def engine_seconds(jobs: list) -> float:
    return sum(j["end"] - j["start"] for j in jobs)


def device_intervals(run, match=None) -> list:
    """(start, end) of the window's device events whose name holds
    ``match`` (all of them when None)."""
    if run.trace is None:
        return []
    return [(a, b) for name, a, b in run.trace.events
            if match is None or match in name]


def busy(run) -> list:
    """The union of every kernel and copy interval in the window."""
    return T.union(device_intervals(run), run.t0, run.t_end)


def kernel_seconds(run, names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``,
    within the window."""
    iv = [iv for n in names for iv in device_intervals(run, n)]
    return sum(min(b, run.t_end) - max(a, run.t0) for a, b in iv
               if min(b, run.t_end) > max(a, run.t0))


def idle_pct(run):
    if not run.cuda or run.trace is None:
        return None
    b = sum(e - s for s, e in busy(run))
    return 100.0 * (1.0 - b / (run.t_end - run.t0))


def roofline_pct(run, names, n_bytes: int, peak_bytes_per_s: float):
    """100 x the least time ``n_bytes`` take at the peak over the
    kernels' time in the trace; None where they did not run."""
    if not run.cuda:
        return None
    t = kernel_seconds(run, names)
    if t <= 0 or n_bytes <= 0:
        return None
    return 100.0 * (n_bytes / peak_bytes_per_s) / t


def percentile(values, q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None
