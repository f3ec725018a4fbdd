"""Port parity for the serving path: KmerEngine.annotate_with_hits
against the JAX KmerEngine, the /query, /lookup, /add and /fq_lookup
/matrix golden conversations byte-identical through the port's server,
the device family path byte-identical to the host path (and to the JAX
server) on every /lookup mode and /fq_lookup, /matrix byte-identical to
the JAX server on its device path and on the host walk, the port's CLI
refusals and family warmup, and proof that the port imports without
jax."""

import asyncio
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from close_kmers_tpu.core.api import KmerEngine as JaxEngine
from close_kmers_tpu.params import EngineParams
from close_kmers_tpu_torch.cli import kser
from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.utils.device import resolve_device

from test_engine import random_db, random_seqs
from test_golden import CONVS, GOLDEN, play
from test_server import data_dir, post  # noqa: F401  (data_dir: fixture)
from test_torch_host import as_port_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(GOLDEN, "data")


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(31)
    db = random_db(rng)
    items = [(f"s{i}", s) for i, s in enumerate(random_seqs(rng, db, n=21))]
    return items, JaxEngine(db), KmerEngine(as_port_db(db), "cpu")


def call_key(c):
    return (c.start, c.end, c.count, c.fI, np.float32(c.weighted).view(np.int32))


@pytest.mark.parametrize("params", [EngineParams(),
                                    EngineParams(min_hits=2, max_gap=30,
                                                 order_constraint=1)])
def test_annotate_with_hits_matches_jax(engines, params):
    items, jeng, teng = engines
    kw = dict(want_hits=True, want_otu=True, want_best=True)
    rw, hw = jeng.annotate_with_hits(items, params, **kw)
    rg, hg = teng.annotate_with_hits(items, params, **kw)
    assert sum(len(r.calls) for r in rg) > 5
    for a, b in zip(rw, rg):
        assert (a.seq_id, a.seq_len) == (b.seq_id, b.seq_len)
        assert [call_key(c) for c in a.calls] == [call_key(c) for c in b.calls]
        assert [vars(h) if hasattr(h, "__dict__") else h for h in a.hits] \
            == [vars(h) if hasattr(h, "__dict__") else h for h in b.hits]
        assert a.otu.finalize() == b.otu.finalize()
        assert vars(a.best) == vars(b.best)
    for k in hw:
        assert np.array_equal(hw[k], hg[k]), k


@pytest.fixture(scope="module")
def port_server():
    from close_kmers_tpu_torch.server.http import handle_connection

    ctx = kser.load_server_context(DATA, batch_size=64, device="cpu")
    loop = asyncio.new_event_loop()
    holder = {}
    ready = threading.Event()

    async def run():
        srv = await asyncio.start_server(
            lambda r, w: handle_connection(r, w, ctx), "127.0.0.1", 0)
        holder["port"] = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await ctx.stop_event.wait()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert ready.wait(60)
    yield holder["port"]
    loop.call_soon_threadsafe(ctx.stop_event.set)
    t.join(30)
    assert not t.is_alive()


@pytest.mark.parametrize("name", ["version", "query", "query_details",
                                  "query_best", "lookup", "lookup_best",
                                  "wadd", "xmatrix", "yfq", "zfq_gz"])
def test_golden_conversation_through_port(port_server, name):
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
        want = f.read()
    assert play(port_server, CONVS[name](body)) == want


@pytest.mark.parametrize("path", [b"/mapping/k/fq_lookup", b"/nope"])
def test_unported_post_answers_as_unknown_path(port_server, path):
    """A POST to a path the server does not route answers 404."""
    req = b"POST " + path + b" HTTP/1.1\nContent-length: 3\n\n>a\n"
    assert play(port_server, req) == (
        b"HTTP/1.1 404 Not found\nContent-type: text/plain\n"
        b"Content-length: 15\n\npath not found\n")


def _matrix_body(dup: bool) -> bytes:
    """Chimeras of the golden queries (test_golden's xmatrix set plus
    two more); ``dup`` repeats an id, which fails the device gate."""
    import re
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        seqs = dict(re.findall(rb">(\S+)[^\n]*\n([A-Z\n]+)", f.read()))
    s1, s2, s3 = (seqs[k].replace(b"\n", b"") for k in (b"q1", b"q2",
                                                         b"q3"))
    prots = [(b"A", s1), (b"B", s1[:60] + s2[60:]), (b"C", s2),
             (b"D", s3[:50] + s1[40:]), (b"A" if dup else b"E", s3)]
    return b"".join(b">" + i + b"\n" + s + b"\n" for i, s in prots)


def _post(path: bytes, body: bytes) -> bytes:
    return (b"POST " + path + b" HTTP/1.1\nContent-length: %d\n\n"
            % len(body) + body)


@pytest.fixture(scope="module")
def matrix_servers():
    """The port's server and the JAX package's on the golden data (two
    proteins a batch), both with the matrix proteins registered in the
    root mapping by /add, and a record of the port's matrix_distance
    results (False: a gate failed and the host walk answered)."""
    from close_kmers_tpu.cli.kser import load_server_context as jax_load
    from close_kmers_tpu_torch.server import http

    seen = []
    real = http.matrix_distance

    def spy(*a):
        out = real(*a)
        seen.append(out is not None)
        return out

    http.matrix_distance = spy
    ctx = kser.load_server_context(DATA, batch_size=2, device="cpu")
    servers = [_serve(c) for c in (ctx, jax_load(DATA, batch_size=2))]
    ports = [p for p, _ in servers]
    for port in ports:
        play(port, _post(b"/add?silent=1", _matrix_body(dup=False)))
    yield ports, ctx, seen
    for _, stop in servers:
        stop()
    http.matrix_distance = real


@pytest.mark.parametrize("query", [b"", b"?min_hits=4&max_gap=20&"
                                   b"order_constraint=1&min_weighted_hits=3"],
                         ids=["default_params", "other_params"])
@pytest.mark.parametrize("route", ["device", "host_walk"])
@pytest.mark.parametrize("path", ["/matrix", "/mapping/{}/matrix"])
def test_matrix_matches_jax_server(matrix_servers, path, route, query):
    """/matrix through the port's server gives the JAX server's bytes, on
    the root mapping and a keyed one, on the device pair program and on
    the host walk (forced by a duplicate id), with default and other
    engine parameters.  Parameters change no probe hit, so the device
    path, which does not take them, and the host walk, which does, agree
    (the port answers ADVICE.md's low item on ignored parameters with
    this test, not with a reroute)."""
    ports, _ctx, seen = matrix_servers
    key = f"m_{route}_{len(query)}"
    conv = [_post(path.format(key).encode() + query,
                  _matrix_body(dup=route == "host_walk"))]
    if path != "/matrix":
        conv.insert(0, _post(f"/mapping/{key}/add?silent=1".encode(),
                             _matrix_body(dup=False)))
    n = len(seen)
    got = [play(port, conv) for port in ports]
    assert got[0] == got[1]
    assert got[0].count(b"\t") >= 12         # four pairs or more
    assert seen[n:] == [route == "device"]


def test_matrix_gate_applies_while_draining(matrix_servers, monkeypatch):
    """Once a request has more proteins than the device program can key,
    the port stops holding its body and walks each batch as it arrives:
    the device program is never asked, and the bytes are the JAX
    server's (which holds the whole body first: ADVICE.md, low)."""
    from close_kmers_tpu_torch.server import http
    ports, ctx, seen = matrix_servers
    monkeypatch.setattr(http, "MATRIX_DEVICE_MAX_P", 2)
    sizes = []
    real = ctx.annotate

    async def spy(items, params, **kw):
        sizes.append(len(items))
        return await real(items, params, **kw)

    monkeypatch.setattr(ctx, "annotate", spy)
    n = len(seen)
    req = _post(b"/matrix", _matrix_body(dup=False))
    got = [play(port, req) for port in ports]
    assert got[0] == got[1] and got[0].count(b"\t") >= 12
    assert seen[n:] == [] and sizes == [2, 2, 1]


def _serve(ctx):
    """Serve ``ctx`` on a thread; returns (port, stop)."""
    from close_kmers_tpu_torch.server.http import handle_connection as th
    from close_kmers_tpu.server.http import handle_connection as jh
    handle = th if isinstance(ctx.engine, KmerEngine) else jh
    loop = asyncio.new_event_loop()
    holder = {}
    ready = threading.Event()

    async def run():
        srv = await asyncio.start_server(
            lambda r, w: handle(r, w, ctx), "127.0.0.1", 0)
        holder["port"] = srv.sockets[0].getsockname()[1]
        ready.set()
        async with srv:
            await ctx.stop_event.wait()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True)
    t.start()
    assert ready.wait(60)

    def stop():
        loop.call_soon_threadsafe(ctx.stop_event.set)
        t.join(30)
        assert not t.is_alive()
    return holder["port"], stop


@pytest.fixture(scope="module")
def family_servers(data_dir):  # noqa: F811
    """Three servers on tests/test_server.py's family data: the port on
    its host family path, the port forced onto the device family program
    (device_family_min=0), and the JAX package's."""
    from close_kmers_tpu.cli.kser import load_server_context as jax_load

    d, prots, fam_spec, funcs = data_dir
    host = kser.load_server_context(str(d), batch_size=64, device="cpu")
    dev = kser.load_server_context(str(d), batch_size=64, device="cpu")
    dev.engine.device_family_min = 0
    ref = jax_load(str(d), batch_size=64)
    assert host.family_mode and dev.family_mode
    servers = [_serve(c) for c in (host, dev, ref)]
    yield [p for p, _ in servers], dev, prots, fam_spec
    for _, stop in servers:
        stop()


def test_device_family_server_byte_identical(family_servers):
    """Every /lookup mode and /fq_lookup give the same bytes from the
    port's host path, its device family program and the JAX server."""
    ports, dev, prots, fam_spec = family_servers
    body = "".join(f">{p}\n{s}\n" for p, s in prots.items()).encode()
    body += b">junk\nXXXXAAAA\n"
    table = {"A": "GCG", "C": "TGC", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTG",
             "M": "ATG", "N": "AAC", "P": "CCG", "Q": "CAG", "R": "CGT",
             "S": "AGC", "T": "ACC", "V": "GTT", "W": "TGG", "Y": "TAT"}
    dna = "".join(table[c] for c in prots[fam_spec[0][0]][:40])
    fq = f"@read1\n{dna}\n+\n{'I' * len(dna)}\n".encode()
    for path, payload in (
            ("/lookup?find_best_match=1&target_genus=Escherichia", body),
            ("/lookup?find_best_match=1&allow_ambiguous_functions=1", body),
            ("/lookup", body), ("/lookup?find_reps=1", body),
            ("/fq_lookup", fq)):
        got = [post(p, path, payload) for p in ports]
        assert "PGF_00000000" in got[0], path
        assert got[0] == got[1] == got[2], path
    root = dev.mapping_map[""]
    assert dev.engine._family_scorers[root][1] is not None
    assert not hasattr(root, "_device_scorer")


def test_kser_family_warmup_raises(monkeypatch):
    """A family-mode server whose family path fails does not open: the
    warmup raises instead of skipping."""
    ctx = kser.load_server_context(DATA, batch_size=64, device="cpu")
    assert ctx.family_mode

    def boom(*a, **kw):
        raise RuntimeError("family path broken")

    monkeypatch.setattr(ctx.engine, "best_family_matches", boom)
    with pytest.raises(RuntimeError, match="family path broken"):
        kser.warmup_context(ctx)


def test_port_imports_without_jax():
    """The package, its server and its CLI import with jax and the JAX
    package unavailable (and the golden data loads and serves a query on
    the CPU)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['close_kmers_tpu'] = None\n"
        "import close_kmers_tpu_torch, close_kmers_tpu_torch.native.api\n"
        "import close_kmers_tpu_torch.server.http\n"
        "import close_kmers_tpu_torch.core.device_score\n"
        "from close_kmers_tpu_torch.cli import kser\n"
        f"ctx = kser.load_server_context({DATA!r}, device='cpu')\n"
        "r = ctx.engine.annotate([('q', 'MKV' * 40)], want_otu=True)\n"
        "assert len(r) == 1\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CLOSE_KMERS_JAX_PLATFORM"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr


def test_kser_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is legal here")
    with pytest.raises(RuntimeError, match="cuda"):
        kser.main(["0", DATA, "--no-listen"])     # --device cuda is the default


@pytest.mark.parametrize("flags", [["--jax-profile-dir", "x"], ["--shards", "-1"],
                                   ["--routed-probe"]])
def test_kser_refuses_jax_only_flags(flags):
    """The JAX profiler flag is refused, and so are a negative shard count
    and a routed probe without table shards (the sharded flags themselves
    serve: test_torch_sharded_server.py)."""
    with pytest.raises(SystemExit) as e:
        kser.main(["0", DATA, "--device", "cpu", "--no-listen", *flags])
    assert e.value.code == 2


def test_kser_refuses_jax_compile_cache(monkeypatch):
    monkeypatch.setenv("CLOSE_KMERS_JAX_CACHE", "/nonexistent")
    with pytest.raises(SystemExit):
        kser.main(["0", DATA, "--device", "cpu", "--no-listen"])


def test_kser_cpu_no_listen_loads():
    assert kser.main(["0", DATA, "--device", "cpu", "--no-listen"]) == 0


@pytest.mark.parametrize("device", [None, "meta"])
def test_resolve_device_rejects(device):
    with pytest.raises(ValueError):
        resolve_device(device)
