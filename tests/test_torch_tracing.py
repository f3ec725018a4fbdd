"""The port's spans and counters (``close_kmers_tpu_torch/utils/metrics.py``
and its call sites in the server, the engine facade and the batch
engine), against a port server on the golden data: how the spans nest,
their clocks, tracing off, the device-pass counters under a forced cap
overflow, the span bound and ``GET /metrics``."""

import asyncio
import os
import socket
import threading
import time

import pytest

from close_kmers_tpu_torch.cli import kser
from close_kmers_tpu_torch.core import engine as E
from close_kmers_tpu_torch.server import http
from close_kmers_tpu_torch.utils import metrics as M

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DATA = os.path.join(GOLDEN, "data")
PATHS = ("/query", "/lookup?find_best_match=1", "/lookup")
EVENT_LOOP = {"parse", "engine_wait", "format", "write"}
COMPUTE = {"pad", "device_program", "host_score", "result_objects"}
# the spans that await: no thread CPU time
AWAITING = {"request", "engine_wait", "write"}


def _request(port: int, raw: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(raw)
        out = b""
        while True:
            data = s.recv(1 << 16)
            if not data:
                return out
            out += data


def _post(port: int, path: str, body: bytes) -> bytes:
    return _request(port, b"POST %s HTTP/1.1\nContent-length: %d\n\n%s"
                    % (path.encode(), len(body), body))


def _context(tracing: bool):
    """The golden data's family-mode server context, two proteins a
    batch, on the device family program (plain kernels)."""
    ctx = kser.load_server_context(DATA, batch_size=2, device="cpu")
    ctx.engine.device_family_min = 0
    ctx.metrics.tracing = tracing
    return ctx


def _golden_posts() -> list:
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    return [(p, body) for p in PATHS]


def _answers(ctx, tmp, posts=None) -> dict:
    """Serve ``ctx`` on a thread, post each (path, body) of ``posts`` (the
    golden queries to each of PATHS), read /metrics, stop."""
    port_file = os.path.join(tmp, "port")
    t = threading.Thread(target=lambda: asyncio.run(http.serve(
        ctx, "127.0.0.1", 0, port_file)), daemon=True)
    t.start()
    for _ in range(1200):
        if os.path.exists(port_file) and open(port_file).read().endswith(
                "\n"):
            break
        time.sleep(0.05)
    port = int(open(port_file).read())
    out = {p: _post(port, p, body)
           for p, body in posts or _golden_posts()}
    out["metrics"] = _request(port, b"GET /metrics HTTP/1.1\n\n").decode()
    _request(port, b"GET /quit HTTP/1.1\n\n")
    t.join(60)
    assert not t.is_alive()
    ctx._compute.shutdown(wait=True)
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    ctx = _context(True)
    return ctx, _answers(ctx, str(tmp_path_factory.mktemp("tracing")))


def test_spans_nest_under_their_roots_and_share_its_request_id(traced):
    ctx, _ = traced
    spans = ctx.metrics.spans
    by_sid = {sp.sid: sp for sp in spans}
    roots = [sp for sp in spans if sp.parent is None]
    assert {sp.name for sp in roots} == {"request", "job"}
    requests = {sp.rid: sp for sp in roots if sp.name == "request"}
    assert len(requests) == len(PATHS) and None not in requests
    for sp in spans:
        if sp.parent is None:
            continue
        chain = [sp]
        while chain[-1].parent is not None:
            chain.append(by_sid[chain[-1].parent])
        root = chain[-1]
        assert sp.root is root and sp.rid == root.rid
        assert root.start <= sp.start <= sp.end <= root.end
        want = "job" if sp.name in COMPUTE else "request"
        assert root.name == want and sp.name in COMPUTE | EVENT_LOOP
    jobs = [sp for sp in roots if sp.name == "job"]
    # three proteins, two a batch: two jobs a request
    assert len(jobs) == 2 * len(PATHS)
    for j in jobs:
        assert j.rid in requests
        assert j.attrs["queued_ns"] >= 0 and j.attrs["proteins"] in (1, 2)
    assert {sp.name for sp in spans} == {"request", "job"} | EVENT_LOOP \
        | COMPUTE
    # /lookup?find_best_match=1 ran the family program: a pass a chunk
    fam = [j for j in jobs if j.rid == sorted(requests)[1]]
    assert all(j.attrs["device_passes"] >= 1 for j in fam)


def test_cpu_time_within_wall_time(traced):
    """CPU time <= wall time in every span that does not await; a span
    that awaits reads no CPU clock."""
    ctx, _ = traced
    assert ctx.metrics.spans
    for sp in ctx.metrics.spans:
        if sp.name in AWAITING:
            assert sp.cpu is None, sp.name
        else:
            assert 0 <= sp.cpu <= sp.end - sp.start, sp.name


def test_window_counters_match_the_padded_grid(traced):
    """windows_valid: each padded row's len - 8 windows; windows_padded:
    [B, L - 8] a device pass."""
    ctx, _ = traced
    m = M.Metrics()
    m.tracing = True
    fa = ctx.engine.fa
    fa.metrics = m
    try:
        seqs = ["M" * 5, "MKV" * 40, ""]
        offsets, lengths = fa.pad_batch(seqs)
        fa.probe_compact(offsets, lengths)
    finally:
        fa.metrics = ctx.metrics
    assert m.counters["windows_valid"] == 112
    assert m.counters["windows_padded"] == m.counters["device_passes"] \
        * 3 * (offsets.shape[1] - 8)


def test_tracing_off_records_nothing_and_reads_no_clock(traced, monkeypatch,
                                                         tmp_path):
    """With tracing off the same answers come back, no span is made and
    no span clock is read, and /metrics shows no span."""
    _, want = traced

    class NoClock:
        time, monotonic = M.time.time, M.time.monotonic

        def __getattr__(self, name):
            raise AssertionError(f"time.{name} read with tracing off")

    def no_span(*a, **kw):
        raise AssertionError("a span made with tracing off")

    monkeypatch.setattr(M, "time", NoClock())
    monkeypatch.setattr(M, "Span", no_span)
    ctx = _context(False)
    got = _answers(ctx, str(tmp_path))
    for p in PATHS:
        assert got[p] == want[p], p
    assert ctx.metrics.spans == [] and ctx.metrics.span_totals == {}
    assert set(ctx.metrics.counters) == {
        "requests", "requests/query", "requests/lookup", "requests/metrics",
        "requests/quit", "proteins"}
    assert "span_" not in got["metrics"]


def test_forced_cap_overflow_counts_one_rerun_each_extra_pass(
        traced, monkeypatch):
    ctx, _ = traced
    passes = []
    orig = E._probe_compact

    def counted(*a, **kw):
        passes.append(a[3])          # the pass's hit cap
        return orig(*a, **kw)

    monkeypatch.setattr(E, "_probe_compact", counted)
    m = M.Metrics()
    m.tracing = True
    fa = ctx.engine.fa
    fa.metrics = m
    with open(os.path.join(GOLDEN, "queries.fa")) as f:
        seqs = [ln.strip() for ln in f if ln.strip() and ln[0] != ">"]
    try:
        with m.span("job", attrs={"proteins": len(seqs)}) as job:
            for cap in (1, 64):
                fa.probe_compact(*fa.pad_batch(seqs), hits_per_seq_cap=cap)
    finally:
        fa.metrics = ctx.metrics
    assert len(passes) >= 3 and passes[1] > passes[0]   # cap 1 ran over
    assert m.counters["device_passes"] == len(passes)
    assert m.counters["device_reruns"] == len(passes) - 2
    assert job.attrs["device_passes"] == len(passes)
    assert job.attrs["device_reruns"] == len(passes) - 2


def test_spans_past_the_bound_are_counted_dropped():
    m = M.Metrics()
    m.MAX_SPANS = 3
    m.tracing = True
    for i in range(5):
        with m.span("parse"):
            pass
    assert len(m.spans) == 3 and m.counters["spans_dropped"] == 2
    assert m.span_totals["parse"][0] == 5


def test_metrics_renders_span_sums_and_counters(traced):
    ctx, got = traced
    lines = dict(ln.split("\t") for ln in got["metrics"].split("\n\n", 1)[1]
                 .splitlines())
    for name in {"request", "job"} | EVENT_LOOP | COMPUTE:
        assert int(lines[f"span_{name}_count"]) > 0, name
        if name in AWAITING:
            assert f"span_{name}_cpu_s" not in lines, name
        else:
            assert float(lines[f"span_{name}_cpu_s"]) <= float(
                lines[f"span_{name}_wall_s"])
    for name in ("windows_valid", "windows_padded", "device_passes",
                 "device_reruns"):
        assert int(lines[name]) >= 0, name
    assert int(lines["proteins"]) == 3 * len(PATHS)
    # each body's last record has no '>' after it: read by the state machine
    assert int(lines["parse_records"]) == 3 * len(PATHS)
    assert int(lines["parse_records_fast"]) == 2 * len(PATHS)
    assert float(lines["proteins_per_s"]) > 0


def test_proteins_per_s_is_over_the_trailing_minute(monkeypatch):
    clock = {"t": 1000.0}

    class Clock:
        def time(self):
            return clock["t"]

        def monotonic(self):
            return clock["t"]

    monkeypatch.setattr(M, "time", Clock())
    m = M.Metrics()
    m.inc("proteins", 600)
    clock["t"] += 30.0
    assert m.render().splitlines()[-1] == "proteins_per_s\t20.0"
    clock["t"] += 40.0               # the first 600 fell out of the minute
    m.inc("proteins", 90)
    assert m.render().splitlines()[-1] == "proteins_per_s\t1.5"
    assert len(m._recent) == 1 and m.counters["proteins"] == 690


def test_peg_mode_lookup_scores_outside_its_format_span(tmp_path):
    """/lookup without families: the batch's per-protein peg scores are a
    ``host_score`` span of the request that ends before its ``format``
    span starts; tracing changes no byte of the answers."""
    import numpy as np

    from close_kmers_tpu_torch.db.signature_db import SignatureDB, \
        write_index_file
    from close_kmers_tpu_torch.ops.encoder import PROT_ALPHA
    rng = np.random.default_rng(77)
    prot = "".join(rng.choice(list(PROT_ALPHA), size=80))
    entries = {prot[i:i + 8]: (prot[i:i + 8], 10, 0, 1.0, -1)
               for i in range(len(prot) - 7)}
    d = tmp_path / "pegdata"
    d.mkdir()
    SignatureDB.from_entries(entries.values(), functions=["some fn"]) \
        .save_npz(str(d / "signature_db.npz"))
    write_index_file(str(d / "function.index"), ["some fn"])
    write_index_file(str(d / "otu.index"), [])
    posts = [("/add?silent=1", f">pegA\n{prot}\n>pegB\n{prot[:40]}\n"
              .encode()),
             ("/lookup", f">q1\n{prot[5:60]}\n>q2\n{prot[:30]}\n"
              .encode())]
    got, ctxs = {}, {}
    for tracing in (True, False):
        ctx = ctxs[tracing] = kser.load_server_context(
            str(d), batch_size=64, device="cpu")
        assert not ctx.family_mode
        ctx.metrics.tracing = tracing
        serve_dir = tmp_path / f"serve_{tracing}"
        serve_dir.mkdir()
        got[tracing] = _answers(ctx, str(serve_dir), posts)
    assert b"pegA" in got[True]["/lookup"]
    assert got[True]["/lookup"] == got[False]["/lookup"]
    assert ctxs[False].metrics.spans == []
    spans = ctxs[True].metrics.spans
    lookup = [sp for sp in spans if sp.name == "request"][-1]
    under = {sp.name: sp for sp in spans
             if sp.root is lookup and sp.name in ("host_score", "format")}
    assert under["host_score"].end <= under["format"].start
