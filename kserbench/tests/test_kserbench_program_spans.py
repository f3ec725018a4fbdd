"""The program's own spans and counters as the benchmark would read them
(``harness/program_spans.py``): each reading's arithmetic on fabricated
spans, the idle gaps by program span, a tiny traced cell whose program
spans lie inside the harness's wrappers of the same calls, the program's
window counters against the harness's, and the benchmark's own traced
runs, which leave the program's tracing off."""

import bisect
import json
import socket
import types

import pytest
import torch

from conftest import DATA, TINY_SPEC, run_tiny

MS = 1_000_000          # ns


def _span(name, sid, start_s, wall_s, cpu_s=0.0, root=None, rid=None,
          **attrs):
    start = int(start_s * 1e9)
    return types.SimpleNamespace(
        name=name, sid=sid, parent=None if root is None else root.sid,
        root=root, rid=rid if root is None else root.rid, attrs=attrs,
        start=start, end=start + int(wall_s * 1e9),
        cpu=None if cpu_s is None else int(cpu_s * 1e9))


def _run(spans, t0=10.0, t_end=20.0, events=None):
    from kserbench.harness.cell import Run
    rec = types.SimpleNamespace(program=types.SimpleNamespace(spans=spans))
    trace = None if events is None else types.SimpleNamespace(events=events)
    return Run(recorder=rec, t0=t0, t_end=t_end, trace=trace, cuda=True)


@pytest.fixture
def fabricated():
    """A window [10 s, 20 s): request 1 (two parse spans, a format span)
    and its job of 1,000 proteins; request 2, started at 19.5 s, and its
    job of 500, both still running at the close; request 0 and its job
    before the window.  Only request 1 and its job count."""
    r0 = _span("request", 1, 9.0, 2.0, None, rid=0)
    j0 = _span("job", 2, 9.6, 1.0, rid=0, proteins=800, queued_ns=100 * MS,
               device_passes=9, device_reruns=9)
    r1 = _span("request", 3, 11.0, 2.0, None, rid=1)
    j1 = _span("job", 4, 11.2, 0.8, rid=1, proteins=1000,
               queued_ns=100 * MS, device_passes=3, device_reruns=1)
    r2 = _span("request", 5, 19.5, 1.5, None, rid=2)
    j2 = _span("job", 6, 19.7, 0.5, rid=2, proteins=500, queued_ns=100 * MS,
               device_passes=2, device_reruns=0)
    return [r0, j0, r1, j1, r2, j2,
            _span("parse", 7, 9.1, 1.0, 1.0, root=r0),
            _span("pad", 8, 9.7, 0.5, 0.5, root=j0),
            _span("result_objects", 9, 9.8, 0.5, 0.0, root=j0),
            _span("parse", 10, 11.0, 0.010, 0.010, root=r1),
            _span("parse", 11, 11.05, 0.020, 0.020, root=r1),
            _span("engine_wait", 12, 11.1, 0.9, None, root=r1),
            _span("format", 13, 12.0, 0.005, 0.005, root=r1),
            _span("pad", 14, 11.2, 0.1, 0.04, root=j1),
            _span("device_program", 15, 11.3, 0.3, 0.01, root=j1),
            _span("host_score", 16, 11.6, 0.05, 0.05, root=j1),
            _span("result_objects", 17, 11.7, 0.2, 0.1, root=j1),
            _span("pad", 18, 19.7, 0.1, 0.1, root=j2)]


@pytest.mark.parametrize("name,want", [
    ("parse_ms_per_kprot", 0.030 * 1e6 / 1000),
    ("format_ms_per_kprot", 0.005 * 1e6 / 1000),
    ("result_objects_ms_per_kprot", 0.2 * 1e6 / 1000),
    ("compute_offcpu_pct", 100 * (1 - 0.19 / 0.35)),
    ("device_rerun_pct", 100 * 1 / 3)])
def test_reading_arithmetic(fabricated, name, want):
    from kserbench.harness import program_spans as P
    assert P.readings(_run(fabricated))[name] == pytest.approx(want,
                                                               rel=1e-6)
    # an untraced run, and a program without spans, read nothing
    from kserbench.harness.cell import Run
    assert P.readings(Run(recorder=None, t0=10.0, t_end=20.0))[name] is None
    assert P.readings(Run(recorder=types.SimpleNamespace(), t0=10.0,
                          t_end=20.0))[name] is None


def test_idle_gaps_by_program_span():
    from kserbench.harness import program_spans as P
    req = _span("request", 1, 0.0, 10.0, rid=1)
    a = _span("job", 2, 0.2, 3.8, rid=1, proteins=4)
    b = _span("job", 3, 7.0, 0.5, rid=1, proteins=4)
    spans = [req, a, b, _span("parse", 4, 0.0, 10.0, root=req),
             _span("pad", 5, 0.3, 0.5, root=a),
             _span("device_program", 6, 1.0, 1.2, root=a)]
    events = [("k1", 1.0, 2.0), ("k2", 5.0, 6.0)]
    run = _run(spans, 0.0, 10.0, events)
    # gaps (0, 1) in pad, (2, 5) in job a outside its spans, (6, 10) in
    # no job (job b ends at 7.5, before the gap's middle)
    assert P.idle_by_span(run) == pytest.approx(
        {"pad": 1.0, P.IN_JOB: 3.0, P.NO_JOB: 4.0})
    assert P.idle_by_span(_run(spans)) == {}        # no device trace


def test_window_totals(fabricated):
    from kserbench.harness import program_spans as P
    got = P.window_totals(_run(fabricated))
    assert got["parse"] == pytest.approx([2, 0.030, 0.030])
    assert got["pad"] == pytest.approx([1, 0.1, 0.04])
    assert got["job"][0] == got["request"][0] == 1
    # the spans that await carry no CPU time
    assert got["request"][2] is None and got["engine_wait"][2] is None


def _nest(xs, ys) -> None:
    """``xs`` and ``ys`` are the same sequential calls of one thread, one
    each, in start order: each pair nests, one inside the other."""
    assert xs and len(xs) == len(ys)
    for (a, b), (c, d) in zip(sorted(xs), sorted(ys)):
        assert a <= c <= d <= b or c <= a <= b <= d, ((a, b), (c, d))


def _pairs(outer, inner) -> None:
    """``outer`` and ``inner`` ((start, end) on one clock, in seconds) are
    the same calls, one each: the inner of an outer interval is the first
    to start after it (no other call starts between the two), and ends
    inside it."""
    starts = sorted(inner)
    assert outer and len(outer) == len(inner)
    for a, b in sorted(outer):
        k = bisect.bisect_left(starts, (a, a))
        assert k < len(starts), (a, b)
        c, d = starts.pop(k)
        assert a <= c <= d <= b, ((a, b), (c, d))


def _captured_runs(monkeypatch) -> list:
    from kserbench.harness import cell
    runs = []

    class Captured(cell.Run):
        def __init__(self, **kw):
            super().__init__(**kw)
            runs.append(self)

    monkeypatch.setattr(cell, "Run", Captured)
    return runs


@pytest.mark.parametrize("workload", ["tiny-query", "tiny-family"])
def test_program_spans_lie_inside_the_harness_wrappers(monkeypatch,
                                                       workload):
    """A tiny traced cell under ``program_tracing``: the program's tracing
    is on for the window alone, and each call the harness timed from
    outside in the window has the program's span of the same call inside
    it, on the shared monotonic clock (host scoring and the family
    readback's wait the other way round: the program's span is at the
    engine facade's call site, around the function the harness wraps);
    the readings report."""
    from kserbench.harness import program_spans as P
    runs = _captured_runs(monkeypatch)
    with P.program_tracing():
        r = run_tiny(workload, seed=11, trace=True)
    assert r["correct"] is True
    run = runs[-1]
    rec, m = run.recorder, run.recorder.program
    assert not m.tracing
    assert m.spans and min(sp.start for sp in m.spans) >= run.t0 * 1e9
    got = {k for k, v in P.readings(run).items() if v is not None}
    assert got == set(P.readings(run)) - (
        {"result_objects_ms_per_kprot"} if workload == "tiny-family"
        else set())

    sec = lambda sp: (sp.start / 1e9, sp.end / 1e9)      # noqa: E731
    # the calls that ended inside the window: the harness timed all of
    # their layers (it times a layer's call that starts while it is on)
    jobs = [(j["start"], j["end"]) for j in rec.jobs
            if j["end"] < run.t_end]
    reqs = [(q["start"], q["end"]) for q in rec.requests.values()
            if q["end"] is not None and q["end"] < run.t_end]
    inside = lambda iv, ivs: any(  # noqa: E731
        a <= iv[0] <= iv[1] <= b for a, b in ivs)
    roots = {name: [sp for sp in m.spans if sp.name == name
                    and sp.parent is None and inside(sec(sp), ivs)]
             for name, ivs in (("job", jobs), ("request", reqs))}
    _pairs(jobs, [sec(sp) for sp in roots["job"]])
    _pairs(reqs, [sec(sp) for sp in roots["request"]])
    sids = {sp.sid for sp in roots["job"]}
    program = lambda name: [sec(sp) for sp in m.spans  # noqa: E731
                            if sp.name == name and sp.root is not None
                            and sp.root.sid in sids]
    harness = lambda layer: [(a, b) for n, a, b in rec.spans  # noqa: E731
                             if n == layer and inside((a, b), jobs)]
    _pairs(harness("pad_batch"), program("pad"))
    _nest(harness("device_program"), program("device_program"))
    _pairs(program("host_score"), harness("host_score"))


def test_the_benchmarks_traced_run_leaves_program_tracing_off(monkeypatch):
    """``run.py``'s traced run: the harness's wrappers time the window,
    and the program makes no span of its own."""
    from close_kmers_tpu_torch.utils import metrics as M
    made = []
    span = M.Span

    def recorded(*a, **kw):
        made.append(a[1])
        return span(*a, **kw)

    monkeypatch.setattr(M, "Span", recorded)
    runs = _captured_runs(monkeypatch)
    r = run_tiny("tiny-query", seed=12, trace=True)
    assert r["correct"] is True and runs[-1].recorder.spans
    assert made == [] and not hasattr(runs[-1].recorder, "program")


def _post(port: int, path: bytes, body: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        s.sendall(b"POST %s HTTP/1.1\nContent-length: %d\n\n%s"
                  % (path, len(body), body))
        out = b""
        while True:
            data = s.recv(1 << 16)
            if not data:
                return out
            out += data


@pytest.mark.parametrize("config", ["tiny_query", "tiny_family"])
def test_window_counters_equal_the_harness_counts(config):
    """The program's windows_valid and windows_padded equal the harness's
    valid_windows and probed_windows over the same requests, exactly."""
    from kserbench.gen.scale_db import scale_db
    from kserbench.gen.scale_mapping import scale_mapping
    from kserbench.gen.traffic import make_pool
    from kserbench.harness import program_spans as P
    from kserbench.harness.server import Server
    from kserbench.harness.spec import Spec
    spec = Spec(TINY_SPEC, DATA)
    cell = spec.cell(config.replace("_", "-"))
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    endpoint = spec.endpoint(cfg["endpoint"])
    cpu = torch.device("cpu")
    db = scale_db(cfg["n_keys"], cfg["aa_bias"], cfg["n_functions"], 3,
                  cpu).freeze()
    uni = (scale_mapping(db.keys, db.fi, db.functions).freeze()
           if cfg["family_mode"] else None)
    server = Server(db, uni, cfg["family_mode"], cpu)
    rec = P.ProgramRecorder()
    try:
        port = server.start()
        rec.install(server.ctx)
        m = server.ctx.metrics
        assert rec.program is m and not m.tracing
        rec.on = True
        assert m.tracing
        for req in make_pool(traffic, db, 3).requests[:4]:
            assert _post(port, endpoint.PATH, req.body).startswith(
                b"HTTP/1.1 200 OK")
        rec.on = False
        assert not m.tracing
    finally:
        server.stop()
        rec.uninstall()
    assert rec.valid_windows > 0 and rec.probed_windows > 0
    assert m.counters["windows_valid"] == rec.valid_windows
    assert m.counters["windows_padded"] == rec.probed_windows
    if cfg["family_mode"]:        # the device family program served them
        assert rec.group_launches


@pytest.mark.parametrize("on", [1, 0])
def test_trace_report_on_a_tiny_cell(capsys, on):
    """trace_report.py's line: the result, the traced run's end-to-end
    metrics, the program's readings and the idle time by program span
    (the whole window, on the CPU, which has no device events), none of
    the program's with its spans off."""
    import kserbench.trace_report as TR
    from kserbench.harness import spans as S
    from kserbench.harness.spec import Spec
    recorder = S.Recorder
    assert TR.main(["--workload", "tiny-query", "--seed", "4",
                    "--seconds", "1.5", "--program-spans", str(on)],
                   spec=Spec(TINY_SPEC, DATA), device="cpu") == 0
    assert S.Recorder is recorder
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["result"]["correct"] is True
    assert out["end_to_end"]["proteins_per_s"] > 0
    idle = out["idle_by_program_span"]
    assert (sum(idle.values()) > 0) == bool(on)
    assert ("parse_ms_per_kprot" in out["program"]) == bool(on)
    assert ("pad" in out["span_totals"]) == bool(on)
