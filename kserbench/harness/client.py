"""The load generator: a process of its own (so that its Python does not
compete with the server's for one interpreter lock) that plays a closed
loop of clients against the server over loopback HTTP.

It imports neither torch nor the program.  Protocol over ``conn`` (a
multiprocessing connection): it receives the job (a dict, see
:func:`client_main`), sends each client's warm-up request at once and
reports ``("warm",)``; on ``"go"`` it opens the window of ``seconds``,
reports ``("closed", t0, t_end)`` when it ends, lets the requests in
flight finish (up to ``drain_s`` more) and sends ``("done", records)``.
Times are ``time.monotonic()``, which every process of the machine
shares.
"""

from __future__ import annotations

import asyncio
import time


class Record:
    """One request as the client saw it."""
    __slots__ = ("client", "index", "t_send", "t_done", "ok", "chunk_t",
                 "chunk_n", "response")

    def __init__(self, client: int, index: int, t_send: float):
        self.client = client
        self.index = index
        self.t_send = t_send
        self.t_done = None
        self.ok = False
        self.chunk_t: list = []    # arrival time of each read
        self.chunk_n: list = []    # records it completed
        self.response = b""


def count_records(data: bytes, marker: bytes) -> int:
    """Complete record-ending lines in ``data``, which starts at a line
    start and ends after a newline: every line where ``marker`` is
    empty, else the lines that start with it."""
    if not marker:
        return data.count(b"\n")
    return data.startswith(marker) + data.count(b"\n" + marker)


async def request(host: str, port: int, head: bytes, body: bytes,
                  marker: bytes, rec: Record) -> Record:
    """Send one request and read its answer to the end, timing each read
    and counting the records it completes."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(head + body)
        sending = asyncio.ensure_future(writer.drain())
        buf = bytearray()
        done_to = -1      # the answer's body starts past the blank line
        while True:
            data = await reader.read(1 << 16)
            if not data:
                break
            buf += data
            if done_to < 0:
                end = buf.find(b"\n\n")
                if end < 0:
                    continue
                done_to = end + 2
            last = buf.rfind(b"\n")
            n = 0
            if last >= done_to:
                n = count_records(bytes(buf[done_to:last + 1]), marker)
                done_to = last + 1
            rec.chunk_t.append(time.monotonic())
            rec.chunk_n.append(n)
        await sending
        rec.t_done = time.monotonic()
        rec.response = bytes(buf)
        rec.ok = buf.startswith(b"HTTP/1.1 200 OK\n")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    return rec


def _head(path: bytes, body: bytes) -> bytes:
    return (b"POST " + path + b" HTTP/1.1\nContent-length: "
            + str(len(body)).encode() + b"\n\n")


async def _warm(job: dict) -> None:
    path, marker = job["path"], job["record_end"]
    recs = await asyncio.gather(*(
        request(job["host"], job["port"], _head(path, b), b, marker,
                Record(k, -1, time.monotonic()))
        for k, b in enumerate(job["warm_bodies"])))
    bad = [r.response[:200] for r in recs if not r.ok]
    if bad:
        raise RuntimeError(f"warm-up requests failed: {bad}")


async def _window(job: dict, conn) -> list:
    bodies = job["bodies"]
    heads = [_head(job["path"], b) for b in bodies]
    marker = job["record_end"]
    t0 = time.monotonic()
    t_end = t0 + job["seconds"]
    nxt = [0]
    records: list = []

    async def client(k: int):
        while time.monotonic() < t_end:
            i = nxt[0] % len(bodies)
            nxt[0] += 1
            rec = Record(k, i, time.monotonic())
            records.append(rec)
            try:
                await request(job["host"], job["port"], heads[i], bodies[i],
                              marker, rec)
            except (ConnectionError, OSError):
                rec.t_done = time.monotonic()

    tasks = [asyncio.ensure_future(client(k)) for k in range(job["clients"])]
    await asyncio.sleep(max(0.0, t_end - time.monotonic()))
    conn.send(("closed", t0, t_end))
    _done, pending = await asyncio.wait(tasks, timeout=job["drain_s"])
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    for t in _done:
        t.result()
    return records


def client_main(conn) -> None:
    """The client process's body.  ``job``: host, port, path, record_end,
    bodies (in the order the clients take them), warm_bodies (one a
    client), clients, seconds, drain_s."""
    job = conn.recv()
    try:
        asyncio.run(_warm(job))
    except Exception as e:  # reported to the parent, which fails the run
        conn.send(("error", repr(e)))
        return
    conn.send(("warm",))
    if conn.recv() != "go":
        return
    records = asyncio.run(_window(job, conn))
    conn.send(("done", records))
