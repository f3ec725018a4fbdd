"""One run of one cell: set-up, the measured window, the check and the
result line.

Set-up, in order: the DB made on the device from the seed (the frozen
``gen.scale_db``), the family universe for a family configuration
(:func:`universe_of`), the port's server built over them and started
on a thread, the request bodies made from the seed, and one warm-up
request a client.  The window then lasts ``--seconds``; ``setup_s`` is
everything before it.  After it the program's state is freed and the
served answers are judged (``harness.check``).
"""

from __future__ import annotations

import gc
import heapq
import json
import multiprocessing
import os
import subprocess
import sys
import time

from . import check, client, spans, trace as T
from .server import Server
from .spec import Spec

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "close_kmers_tpu")
DRAIN_S = 60.0
WARM_TIMEOUT_S = 600.0


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_info(cuda: bool) -> dict:
    if not cuda:
        return {}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    return {"nvidia_smi": out}


def _pin_threads(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:     # a thread that has just ended
            pass


def pin(client_pid: int) -> list | None:
    """Give the load generator one core of its own and every thread of
    this process (the server's, and those it starts later) the others,
    so that the two never share a core and the scheduler does not move
    one onto the other's.  Returns the cores this process had, for
    :func:`_pin_threads` to give back, or None where it had one."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None
    os.sched_setaffinity(client_pid, {cpus[-1]})
    _pin_threads(cpus[:-1])
    return cpus


def universe_of(config: dict, db, dev):
    """The family universe of a family configuration (None otherwise),
    made on ``dev`` by ``gen.card_mapping``: equal array for array to the
    frozen numpy ``gen.scale_mapping``, which stays the tests' reference."""
    if not config["family_mode"]:
        return None
    from ..gen.card_mapping import card_mapping
    return card_mapping(db.keys, db.fi, db.functions, dev).freeze()


def _recv(conn, timeout: float, what: str):
    if not conn.poll(timeout):
        raise RuntimeError(f"the client sent no {what} in {timeout:.0f} s")
    msg = conn.recv()
    if msg[0] == "error":
        raise RuntimeError(f"the client failed: {msg[1]}")
    return msg


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Spec | None = None,
             control: bool = False, t_start: float | None = None) -> dict:
    """Run ``workload``; returns the result (the last line's object) and
    prints the checks on standard error.  ``device`` "cpu" skips the
    look for a card (tests: the port's plain kernels)."""
    t_start = time.monotonic() if t_start is None else t_start
    import torch
    from ..gen.scale_db import scale_db
    from ..gen.traffic import make_pool
    from ..reference.answers import RefDB

    spec = spec or Spec()
    cell = spec.cell(workload)
    config = spec.config(cell)
    traffic = spec.traffic(cell)
    endpoint = spec.endpoint(config["endpoint"])
    metrics = spec.metrics(workload, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"{workload} needs {cell['chips']} CUDA card(s); "
                         f"torch sees {torch.cuda.device_count()}")
    dev = torch.device(device)

    mp = multiprocessing.get_context("spawn")
    conn, child = mp.Pipe()
    proc = mp.Process(target=client.client_main, args=(child,),
                      name="kserbench-client", daemon=True)
    proc.start()
    child.close()
    server = None
    cpus = None
    try:
        cpus = pin(proc.pid)
        db = scale_db(config["n_keys"], config["aa_bias"],
                      config["n_functions"], seed, dev).freeze()
        universe = universe_of(config, db, dev)
        if cuda:
            torch.cuda.empty_cache()
        server = Server(db, universe, config["family_mode"], dev)
        port = server.start()
        rec = spans.Recorder() if trace else None
        if rec is not None:
            rec.install(server.ctx)
        pool = make_pool(traffic, db, seed)
        conn.send(dict(host="127.0.0.1", port=port, path=endpoint.PATH,
                       record_end=endpoint.RECORD_END,
                       bodies=[r.body for r in pool.requests],
                       warm_bodies=[r.body for r in pool.warmup],
                       clients=traffic["clients"], seconds=seconds,
                       drain_s=DRAIN_S))
        _recv(conn, WARM_TIMEOUT_S, "warm-up")
        setup_peak = 0
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        tr = T.DeviceTrace(cuda) if trace else None
        setup_s = time.monotonic() - t_start
        if rec is not None:
            rec.on = True
        if tr is not None:
            tr.start()
        conn.send("go")
        _, t0, t_end = _recv(conn, seconds + 60, "window close")
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if rec is not None:
            rec.on = False
        if tr is not None:
            tr.stop()
        _, records = _recv(conn, DRAIN_S + 60, "records")
        proc.join(30)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules loaded that a run may not load: "
                             f"{found}")
        server.stop()
        server = None
        if rec is not None:
            rec.uninstall()
        gc.collect()
        run = Run(cell=cell, config=config, traffic=traffic, t0=t0,
                  t_end=t_end, seconds=t_end - t0, records=records,
                  recorder=rec, trace=tr, setup_s=setup_s,
                  window_peak_bytes=window_peak, cuda=cuda)
        values = {}
        for m in metrics:
            v = readers[m["name"]](run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:
            torch.cuda.empty_cache()
        numbers, ctl = check.judge(
            records, pool, t_end, endpoint, RefDB(db, universe),
            traffic["check_sample"], seed, control)
    finally:
        if server is not None:
            server.stop()
        if proc.is_alive():
            proc.kill()
        proc.join(30)
        conn.close()
        if cpus is not None:
            _pin_threads(cpus)

    sent = [r for r in records if r.t_send < t_end]
    failed = sum(1 for r in sent if not r.ok or r.t_done is None)
    result = {"correct": all(check.passes(k, v) for k, v in numbers.items()),
              "attempted": len(sent), "failed": failed, "metrics": values,
              "device": device_block(cuda, torch,
                                     max(setup_peak, window_peak), run)}
    if trace:
        result["breakdown"] = breakdown(run)
    result["card"] = card_info(cuda)
    if ctl is not None:
        result["control"] = ctl
        print(f"control bf16 {json.dumps(ctl)}", file=sys.stderr)
    # the numbers compared, each beside its limit: the last lines on
    # standard error and the last key of the result
    result["checks"] = {}
    for k, v in numbers.items():
        kind, limit = check.LIMITS[k]
        result["checks"][k] = {"value": v, "limit": limit, "holds": kind}
        print(f"check {k} {v} {'<=' if kind == 'max' else '>='} {limit}",
              file=sys.stderr)
    return result


def device_block(cuda: bool, torch, peak: int, run) -> dict:
    if cuda:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.trace is not None:
        from .layers import busy
        out["busy_s"] = sum(b - a for a, b in busy(run))
        out["window_s"] = run.t_end - run.t0
    return out


def innermost(spans: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the span (name,
    start, end) holding it that started last, or None: one sweep over
    the spans by start, the open ones in a heap by start."""
    spans = sorted(spans, key=lambda sp: sp[1])
    out, heap, k = [], [], 0
    for t in points:
        while k < len(spans) and spans[k][1] <= t:
            name, a, b = spans[k]
            heapq.heappush(heap, (-a, b, name))
            k += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def breakdown(run) -> dict:
    """The ten device operations of most time in the window, and the ten
    longest idle gaps of the device by what the compute thread was in
    (the innermost layer span holding the gap's middle)."""
    from .layers import busy
    ops: dict = {}
    for name, a, b in run.trace.events:
        a, b = max(a, run.t0), min(b, run.t_end)
        if b > a:
            key = T.short_name(name)
            ops[key] = ops.get(key, 0.0) + (b - a)
    rec = run.recorder
    jobs = [("engine call, outside the spans", j["start"], j["end"])
            for j in rec.jobs if j["start"] is not None
            and j["end"] is not None]
    gaps = T.gaps(busy(run), run.t0, run.t_end)
    mids = [(a + b) / 2 for a, b in gaps]
    in_span = innermost(rec.spans, mids)
    in_job = innermost(jobs, mids)
    idle: dict = {}
    for (a, b), sp, job in zip(gaps, in_span, in_job):
        key = sp or job or "no engine call (server, network, client)"
        idle[key] = idle.get(key, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
