# Copied from close_kmers_tpu/utils/metrics.py.
"""Serving metrics: first-class throughput counters, and the port's spans.

The reference's observability is ad-hoc (cerr progress prints, a global
boost cpu_timer — global.h:14, kserver.cc:177).  Here
proteins/s and probes/s are tracked as first-class counters (the BASELINE
metric) and served from the /metrics endpoint.

Spans (the port's own; off until ``tracing`` is set): each records its
name, request id, parent span, start and end on ``time.monotonic_ns()``
(CLOCK_MONOTONIC, the clock of ``time.monotonic()``) and, unless made
with ``cpu=False``, the thread CPU time (``time.thread_time_ns()``) its
thread spent inside it.  A span that awaits takes ``cpu=False``: its
thread's CPU clock would hold other tasks' work.  A span's parent is the
span open in the same context when it starts (asyncio gives each
connection's task a context of its own; a compute-thread job opens a root
span and names its request id explicitly).  While tracing is off,
:meth:`Metrics.span` returns the shared ``NO_SPAN`` and
:meth:`Metrics.count` returns at once: a site costs one attribute test,
allocates nothing and reads no clock::

    with m.span("pad"):
        ...
    m.count("device_passes")

Completed spans are kept in a list of at most ``MAX_SPANS`` (then counted
in ``spans_dropped``), beside count, wall and CPU time per name.  Counts
go to ``counters`` and to the root span open in the context (a ``job``
or ``request``), so that a window of spans carries its counts.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time

NO_SPAN = contextlib.nullcontext()
RATE_WINDOW_S = 60.0

_current = contextvars.ContextVar("close_kmers_span", default=None)


class Span:
    """One timed interval; a context manager made by :meth:`Metrics.span`.
    ``cpu`` is the thread CPU time between its start and end, None for a
    span made with ``cpu=False``."""

    __slots__ = ("name", "rid", "sid", "parent", "root", "attrs", "start",
                 "end", "cpu", "_metrics", "_cpu0", "_token")

    def __init__(self, metrics, name: str, rid, sid: int, parent, attrs,
                 cpu: bool):
        self._metrics = metrics
        self.name = name
        self.sid = sid
        self.parent = None if parent is None else parent.sid
        # the root span open in the context (None: this span is one)
        self.root = None if parent is None else (parent.root or parent)
        self.rid = parent.rid if rid is None and parent is not None else rid
        self.attrs = attrs
        self.start = self.end = self.cpu = None
        self._cpu0 = 0 if cpu else None

    def __enter__(self):
        self._token = _current.set(self)
        self.start = time.monotonic_ns()
        if self._cpu0 is not None:
            self._cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        if self._cpu0 is not None:
            self.cpu = time.thread_time_ns() - self._cpu0
        self.end = time.monotonic_ns()
        _current.reset(self._token)
        self._metrics._record(self)


class Metrics:
    MAX_SPANS = 1 << 20

    def __init__(self) -> None:
        self.start_time = time.time()
        self.counters: dict[str, int] = {}
        self.tracing = False
        self.spans: list[Span] = []
        # name -> [count, wall ns, CPU ns (None: spans without CPU time)]
        self.span_totals: dict[str, list] = {}
        self._lock = threading.Lock()
        self._sids = itertools.count(1)
        self._rids = itertools.count(1)
        self._recent = collections.deque()       # (monotonic s, proteins)

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if name == "proteins":
            now = time.monotonic()
            self._recent.append((now, n))
            while self._recent[0][0] < now - RATE_WINDOW_S:
                self._recent.popleft()

    def new_request_id(self) -> int:
        return next(self._rids)

    def span(self, name: str, rid=None, attrs: dict | None = None,
             cpu: bool = True):
        """A span under the one open in this context (a root where none
        is), or ``NO_SPAN`` while tracing is off.  ``rid`` defaults to
        the parent's request id; ``cpu=False`` for a span that awaits."""
        if not self.tracing:
            return NO_SPAN
        return Span(self, name, rid, next(self._sids), _current.get(),
                    {} if attrs is None else attrs, cpu)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to a counter and to the open root span's attributes,
        while tracing is on."""
        if not self.tracing:
            return
        sp = _current.get()
        root = None if sp is None else (sp.root or sp)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if root is not None:
                root.attrs[name] = root.attrs.get(name, 0) + n

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self.spans) < self.MAX_SPANS:
                self.spans.append(sp)
            else:
                self.counters["spans_dropped"] = \
                    self.counters.get("spans_dropped", 0) + 1
            t = self.span_totals.setdefault(
                sp.name, [0, 0, None if sp.cpu is None else 0])
            t[0] += 1
            t[1] += sp.end - sp.start
            if t[2] is not None:
                t[2] += sp.cpu

    def render(self) -> str:
        uptime = time.time() - self.start_time
        lines = [f"uptime_s\t{uptime:.1f}"]
        with self._lock:
            counters = dict(self.counters)
            totals = {k: list(v) for k, v in self.span_totals.items()}
        for k in sorted(counters):
            lines.append(f"{k}\t{counters[k]}")
        for k in sorted(totals):
            n, wall, cpu = totals[k]
            lines += [f"span_{k}_count\t{n}",
                      f"span_{k}_wall_s\t{wall / 1e9:.6f}"]
            if cpu is not None:
                lines.append(f"span_{k}_cpu_s\t{cpu / 1e9:.6f}")
        now = time.monotonic()
        recent = sum(n for t, n in self._recent if t >= now - RATE_WINDOW_S)
        window = min(RATE_WINDOW_S, uptime)
        if window > 0:
            lines.append(f"proteins_per_s\t{recent / window:.1f}")
        return "\n".join(lines) + "\n"
