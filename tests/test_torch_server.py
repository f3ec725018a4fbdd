"""Port parity for the serving path: KmerEngine.annotate_with_hits
against the JAX KmerEngine, the four /query golden conversations
byte-identical through the port's server, the port's CLI refusals, and
proof that the port imports without jax."""

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(GOLDEN, "data")


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(31)
    db = random_db(rng)
    items = [(f"s{i}", s) for i, s in enumerate(random_seqs(rng, db, n=21))]
    return items, JaxEngine(db), KmerEngine(db, "cpu")


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
                                  "query_best"])
def test_golden_conversation_through_port(port_server, name):
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
        want = f.read()
    assert play(port_server, CONVS[name](body)) == want


@pytest.mark.parametrize("path", [b"/lookup", b"/add", b"/matrix",
                                  b"/fq_lookup", b"/mapping/k/add"])
def test_unported_post_answers_as_unknown_path(port_server, path):
    req = b"POST " + path + b" HTTP/1.1\nContent-length: 3\n\n>a\n"
    assert play(port_server, req) == (
        b"HTTP/1.1 404 Not found\nContent-type: text/plain\n"
        b"Content-length: 15\n\npath not found\n")


def test_port_imports_without_jax():
    """The package, its server and its CLI import with jax unavailable
    (and the golden data loads and serves a query on the CPU)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import close_kmers_tpu_torch, close_kmers_tpu_torch.host\n"
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


@pytest.mark.parametrize("flags", [["--jax-profile-dir", "x"], ["--shards", "2"],
                                   ["--routed-probe"]])
def test_kser_refuses_jax_only_flags(flags):
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
