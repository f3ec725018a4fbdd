"""Sharded serving through the port: a kser context whose engine probes a
range-sharded DB over eight CPU entries serves every golden conversation
byte-identical, and the routed context serves /lookup and /query best
calls; kser takes --shards and --routed-probe."""

import asyncio
import os
import threading

import pytest

from close_kmers_tpu_torch.cli import kser
from close_kmers_tpu_torch.parallel.sharding import ShardedEngine

from test_golden import CONVS, GOLDEN, play

DATA = os.path.join(GOLDEN, "data")


def _serve(ctx):
    from close_kmers_tpu_torch.server.http import handle_connection
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
    return holder["port"], loop, t


def _stop(ctx, loop, t):
    loop.call_soon_threadsafe(ctx.stop_event.set)
    t.join(30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def sharded_server():
    ctx = kser.load_server_context(DATA, batch_size=64, n_shards=8,
                                   device="cpu")
    port, loop, t = _serve(ctx)
    yield port
    _stop(ctx, loop, t)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_sharded_golden_conversation(sharded_server, name):
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
        want = f.read()
    assert play(sharded_server, CONVS[name](body)) == want, name


@pytest.fixture(scope="module")
def routed_server():
    ctx = kser.load_server_context(DATA, batch_size=64, n_shards=8,
                                   routed=True, device="cpu")
    port, loop, t = _serve(ctx)
    yield port
    _stop(ctx, loop, t)


@pytest.mark.parametrize("name", ["lookup", "query_best"])
def test_routed_golden_conversation(routed_server, name):
    with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
        body = f.read()
    with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
        want = f.read()
    assert play(routed_server, CONVS[name](body)) == want, name


def test_kser_takes_shards_and_routed_probe(monkeypatch):
    """``--shards 2 --routed-probe --device cpu`` loads a routed engine
    over a 1 x 2 mesh of CPU entries."""
    seen = {}
    real = kser.load_server_context

    def spy(*a, **kw):
        seen["ctx"] = real(*a, **kw)
        return seen["ctx"]

    monkeypatch.setattr(kser, "load_server_context", spy)
    assert kser.main(["0", DATA, "--device", "cpu", "--no-listen",
                      "--shards", "2", "--routed-probe"]) == 0
    fa = seen["ctx"].engine.fa
    assert isinstance(fa, ShardedEngine) and fa.routed
    assert fa.mesh.shape == {"data": 1, "table": 2}
    assert {str(fa.mesh.device(e)) for e in fa.mesh.entries} == {"cpu"}
