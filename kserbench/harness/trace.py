"""The device trace of the measured window: torch.profiler over the
window, its kernels and copies read back as intervals on the host's
monotonic clock, their union, and the idle gaps between them.

The profiler is started at the window's opening and stopped at its
close; a ``kb:window`` range entered right after the start ties the
profiler's clock to ``time.monotonic()``.  The raw kineto events are
read (no event tree is built), which keeps reading a long window short.
"""

from __future__ import annotations

import time

MARK = "kb:window"


class DeviceTrace:
    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._torch = torch
        self._prof = profile(activities=acts)
        self._mark = None
        self._t_mark = None
        self.events: list = []    # (name, start, end) on the monotonic clock

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.start()
        self._mark = record_function(MARK)
        self._t_mark = time.monotonic()
        self._mark.__enter__()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        DT = self._torch.autograd.DeviceType
        raw = self._prof.profiler.kineto_results.events()
        offset = None
        dev = []
        for e in raw:
            name = e.name()
            if e.device_type() == DT.CPU:
                if name == MARK:
                    offset = e.start_ns() / 1e9 - self._t_mark
                continue
            if name.startswith("kb:") or e.is_user_annotation():
                continue
            dev.append((name, e.start_ns() / 1e9,
                        (e.start_ns() + e.duration_ns()) / 1e9))
        if offset is None:
            raise RuntimeError("the trace lost its window mark")
        self.events = [(n, a - offset, b - offset) for n, a, b in dev]


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``intervals`` ((start, end) pairs) clipped to [lo,
    hi], as sorted disjoint pairs."""
    out: list = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle (start, end) gaps of [lo, hi] outside ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments, at most 120
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    name = name[5:] if name.startswith("void ") else name
    return name[:120]
