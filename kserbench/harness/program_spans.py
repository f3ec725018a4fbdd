"""The program's own spans and counters in a traced run.

The port records spans and counts inside its server and compute thread
(``close_kmers_tpu_torch/utils/metrics.py``: ``request``, ``parse``,
``engine_wait``, ``format`` and ``write`` on the event loop; a ``job``
root and ``pad``, ``device_program``, ``host_score`` and
``result_objects`` on the compute thread; ``windows_valid``,
``windows_padded``, ``device_passes`` and ``device_reruns`` counted into
each job), each on ``time.monotonic_ns()``, the clock of the harness's
``time.monotonic()`` and of the device trace, with the thread's CPU time
where the span does not await.

Nothing here is loaded by ``run.py``: the benchmark's runs leave the
program's tracing off.  :func:`program_tracing` makes the traced runs
started inside it use :class:`ProgramRecorder`, which switches the
program's tracing on at the window's opening and off at its close
(``trace_report.py`` and the tests use it).  A program without spans
leaves ``program`` unset, and each reading None.

The window: requests and jobs that started in it (a job when it was
submitted) and ended before its close.  Those still running at the close
are left out: the harness's own work after the close (the profiler's
stop) holds the interpreter lock for seconds and stretches them.
"""

from __future__ import annotations

import contextlib

from . import spans as S, trace as T

# the compute thread's spans that run host code only
HOST_ONLY = ("pad", "host_score", "result_objects")
NAMES = HOST_ONLY + ("device_program", "parse", "engine_wait", "format",
                     "write")
IN_JOB = "job, in no program span"
NO_JOB = "no job (server, network, client)"


class ProgramRecorder(S.Recorder):
    """A :class:`spans.Recorder` that also switches the server's own
    tracing with ``on`` (the window's opening and close) and keeps its
    ``Metrics`` as ``program``."""

    program = None

    @property
    def on(self) -> bool:
        return self._on

    @on.setter
    def on(self, value: bool) -> None:
        self._on = value
        if self.program is not None:
            self.program.tracing = value

    def install(self, ctx) -> None:
        super().install(ctx)
        m = getattr(ctx, "metrics", None)
        if hasattr(m, "span_totals"):
            self.program = m


@contextlib.contextmanager
def program_tracing():
    """The harness's traced runs started inside use
    :class:`ProgramRecorder`."""
    saved = S.Recorder
    S.Recorder = ProgramRecorder
    try:
        yield
    finally:
        S.Recorder = saved


def program(run):
    """The traced server's ``Metrics``, or None."""
    return getattr(run.recorder, "program", None)


def window_roots(run, name: str) -> list:
    """The window's ``request`` roots (by start) or ``job`` roots (by
    submission) that ended before its close."""
    m = program(run)
    if m is None:
        return []
    t0, t_end = run.t0 * 1e9, run.t_end * 1e9
    return [sp for sp in m.spans if sp.name == name and sp.parent is None
            and t0 <= sp.start - sp.attrs.get("queued_ns", 0)
            and sp.end <= t_end]


def children(run, roots: list, names) -> list:
    """The spans named in ``names`` under one of ``roots``."""
    sids = {r.sid for r in roots}
    return [sp for sp in getattr(program(run), "spans", ())
            if sp.name in names and sp.root is not None
            and sp.root.sid in sids]


def request_jobs(run) -> tuple:
    """(the window's requests, the jobs of those requests)."""
    reqs = window_roots(run, "request")
    rids = {r.rid for r in reqs}
    m = program(run)
    jobs = [sp for sp in (m.spans if m is not None else ())
            if sp.name == "job" and sp.parent is None and sp.rid in rids]
    return reqs, jobs


def proteins(jobs: list) -> int:
    return sum(j.attrs["proteins"] for j in jobs)


def wall_s(spans: list) -> float:
    return sum(sp.end - sp.start for sp in spans) / 1e9


def ms_per_kprot(spans: list, n: int):
    """ms of ``spans`` per 1,000 proteins (None: no such span ran)."""
    return wall_s(spans) * 1e6 / n if spans and n else None


def server_ms_per_kprot(run, name: str):
    """ms of the window's requests' ``name`` spans per 1,000 of their
    proteins."""
    reqs, jobs = request_jobs(run)
    return ms_per_kprot(children(run, reqs, (name,)), proteins(jobs))


def compute_ms_per_kprot(run, name: str):
    """ms of the window's jobs' ``name`` spans per 1,000 proteins."""
    jobs = window_roots(run, "job")
    return ms_per_kprot(children(run, jobs, (name,)), proteins(jobs))


def offcpu_pct(run):
    """100 x (1 - thread CPU / wall) over the window's jobs' host-only
    spans: the share they spent off the CPU, waiting for the interpreter
    lock or the OS."""
    sp = children(run, window_roots(run, "job"), HOST_ONLY)
    wall = sum(s.end - s.start for s in sp)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.cpu for s in sp) / wall)


def job_count(jobs: list, name: str) -> int:
    return sum(j.attrs.get(name, 0) for j in jobs)


def rerun_pct(run):
    """100 x device_reruns / device_passes over the window's jobs."""
    jobs = window_roots(run, "job")
    passes = job_count(jobs, "device_passes")
    return 100.0 * job_count(jobs, "device_reruns") / passes if passes \
        else None


def readings(run) -> dict:
    """The program's per-layer readings of a traced run, under the names
    a ``benchmark`` PR would give them as metrics (None: nothing to
    read)."""
    return {
        "parse_ms_per_kprot": server_ms_per_kprot(run, "parse"),
        "format_ms_per_kprot": server_ms_per_kprot(run, "format"),
        "result_objects_ms_per_kprot":
            compute_ms_per_kprot(run, "result_objects"),
        "compute_offcpu_pct": offcpu_pct(run),
        "device_rerun_pct": rerun_pct(run)}


def window_totals(run) -> dict:
    """name -> [count, wall s, thread CPU s (None: spans that await)] of
    the window's requests and jobs and of the spans under them."""
    roots = window_roots(run, "request") + window_roots(run, "job")
    out: dict = {}
    for sp in roots + children(run, roots, NAMES):
        t = out.setdefault(sp.name, [0, 0.0, None if sp.cpu is None
                                     else 0.0])
        t[0] += 1
        t[1] += (sp.end - sp.start) / 1e9
        if t[2] is not None:
            t[2] += sp.cpu / 1e9
    return out


def idle_by_span(run) -> dict:
    """Seconds of the device's idle gaps in the window by what the compute
    thread was in at each gap's middle: the innermost program span of a
    job, ``IN_JOB`` where a job ran but none of its spans, ``NO_JOB``
    where no job ran.  Needs a device trace; {} without one."""
    from .cell import innermost
    from .layers import busy
    m = program(run)
    if m is None or run.trace is None:
        return {}
    compute = [(sp.name if sp.parent is not None else IN_JOB,
                sp.start / 1e9, sp.end / 1e9) for sp in m.spans
               if (sp.root if sp.root is not None else sp).name == "job"]
    gaps = T.gaps(busy(run), run.t0, run.t_end)
    held = innermost(compute, [(a + b) / 2 for a, b in gaps])
    out: dict = {}
    for (a, b), name in zip(gaps, held):
        key = name or NO_JOB
        out[key] = out.get(key, 0.0) + (b - a)
    return out
