# Copied from close_kmers_tpu/utils/metrics.py.
"""Serving metrics: first-class throughput counters.

The reference's observability is ad-hoc (cerr progress prints, a global
boost cpu_timer — global.h:14, kserver.cc:177).  Here
proteins/s and probes/s are tracked as first-class counters (the BASELINE
metric) and served from the /metrics endpoint.
"""

from __future__ import annotations

import time


class Metrics:
    def __init__(self) -> None:
        self.start_time = time.time()
        self.counters: dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def render(self) -> str:
        uptime = time.time() - self.start_time
        lines = [f"uptime_s\t{uptime:.1f}"]
        for k in sorted(self.counters):
            lines.append(f"{k}\t{self.counters[k]}")
        prot = self.counters.get("proteins", 0)
        if uptime > 0:
            lines.append(f"proteins_per_s\t{prot / uptime:.1f}")
        return "\n".join(lines) + "\n"
