"""The kser network server, torch port of ``close_kmers_tpu/server/http.py``:
pidgin-HTTP over asyncio with protocol parity to the reference's
KmerRequestServer/KmerRequest2 (kserver.cc, krequest2.cc).

* request line regex ``^([A-Z]+) ([^?#]*)(\\?([^#]*))?(#(.*))? HTTP/(\\d+\\.\\d+)``
  (krequest2.cc:25); query params split on ``;`` or ``&``;
* headers lowercased; ``Expect: 100-continue`` honored;
* responses use bare ``\\n`` line endings, ``Content-type: text/plain``,
  and Content-length only on the simple GET responses;
* GET routes: /quit /version /genus_lookup/<g> /dump_mapping /metrics
  /checkpoint /dump_sizes;
* POST /query.  The other POST actions (/add, /matrix, /lookup,
  /fq_lookup, also under ``/mapping/<key>/``) are not ported yet and
  answer as any unknown path does: 404 ``path not found``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import pickle
import re
import sys
import traceback

from ..host import EngineParams, encoder, family_db, fasta, metrics, \
    oracle as O
from ..core.api import KmerEngine

REQUEST_RE = re.compile(r"^([A-Z]+) ([^?#]*)(\?([^#]*))?(#(.*))? HTTP/(\d+\.\d+)")
GENUS_PATH_RE = re.compile(r"^/genus_lookup/([^/]+)$")

CHUNK = 1 << 20


class ServerContext:
    """Server state: engine + mapping universes (kserver.cc:31-37)."""

    def __init__(self, engine: KmerEngine, family_mode: bool = False,
                 family_reps: family_db.FamilyReps | None = None,
                 kmer_version: str = "", families_version: str = "",
                 batch_size: int = 2048):
        self.engine = engine
        self.family_mode = family_mode
        self.family_reps = family_reps
        self.kmer_version = kmer_version
        self.families_version = families_version
        self.mapping_map: dict[str, family_db.KmerFamilyMapping] = {
            "": family_db.KmerFamilyMapping()}
        self.batch_size = batch_size
        self.stop_event = asyncio.Event()
        self.metrics = metrics.Metrics()
        self.checkpoint_dir = "."
        # One compute thread: device work stays serialized while the
        # event loop keeps parsing/writing other connections.
        self._compute = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ck-compute")

    async def annotate(self, items, params, **kw):
        """Run engine.annotate_with_hits on the compute thread; returns
        (results, compact hit arrays)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._compute,
            lambda: self.engine.annotate_with_hits(items, params, **kw))

    def checkpoint(self) -> str:
        """Persist the mapping universes to a checkpoint file (the
        stand-in for the reference's BLCR checkpoint,
        krequest2.cc:361-408)."""
        path = os.path.join(self.checkpoint_dir, f"checkpoint.{os.getpid()}")
        with open(path, "wb") as f:
            pickle.dump(self.mapping_map, f)
        return path

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            self.mapping_map = pickle.load(f)

    def mapping(self, key: str) -> family_db.KmerFamilyMapping:
        if key not in self.mapping_map:
            self.mapping_map[key] = family_db.KmerFamilyMapping()
        return self.mapping_map[key]


async def _write(writer, data: str | bytes):
    if isinstance(data, str):
        data = data.encode("latin-1")
    writer.write(data)
    await writer.drain()


def _status(http_version: str, code: int, status: str) -> str:
    return (f"HTTP/{http_version} {code} {status}\n"
            f"Content-type: text/plain\n")


async def _respond(writer, http_version, code, status, body: str):
    """krequest2.cc:498-520."""
    msg = _status(http_version, code, status)
    msg += f"Content-length: {len(body.encode('latin-1'))}\n\n{body}"
    await _write(writer, msg)


class Request:
    def __init__(self):
        self.type = ""
        self.path = ""
        self.params: dict[str, str] = {}
        self.headers: dict[str, str] = {}
        self.http_version = "1.1"

    def engine_params(self) -> EngineParams:
        return EngineParams.from_query(self.params)

    def int_param(self, name: str, default: int = 0) -> int:
        try:
            return int(self.params.get(name, ""))
        except ValueError:
            return default


async def read_request(reader) -> Request | None:
    line = await reader.readline()
    if not line:
        return None
    line = line.decode("latin-1").rstrip("\r\n")
    m = REQUEST_RE.match(line)
    if not m:
        print(f"Invalid request '{line}'", file=sys.stderr)
        return None
    req = Request()
    req.type = m.group(1)
    req.path = m.group(2)
    req.http_version = m.group(7)
    raw = m.group(4) or ""
    if raw:
        for part in re.split(r"[;&]", raw):
            pos = part.find("=")
            if pos >= 0:
                req.params[part[:pos]] = part[pos + 1:]
    # headers (krequest2.cc:160-252)
    while True:
        hline = await reader.readline()
        if not hline:
            break
        h = hline.decode("latin-1").rstrip("\r\n")
        if not h:
            break
        pos = h.find(":")
        if pos >= 0:
            req.headers[h[:pos].strip().lower()] = h[pos + 1:].strip()
    return req


class BodyStream:
    """Reads exactly content_length bytes in chunks."""

    def __init__(self, reader, content_length: int):
        self.reader = reader
        self.remaining = content_length

    async def chunks(self):
        while self.remaining > 0:
            data = await self.reader.read(min(CHUNK, self.remaining))
            if not data:
                break
            self.remaining -= len(data)
            yield data


async def handle_query(ctx, req, body, writer):
    """/query (query_request.cc:68-152)."""
    params = req.engine_params()
    details = req.int_param("details")
    find_best = req.int_param("find_best_call")
    eng = ctx.engine
    await _write(writer, _status(req.http_version, 200, "OK") + "\n")

    async for items in _fasta_batches(ctx, body):
        out = []
        ctx.metrics.inc("proteins", len(items))
        results, _h = await ctx.annotate(items, params, want_hits=details,
                                         want_otu=True, want_best=find_best,
                                         want_code=bool(details))
        for r in results:
            if find_best:
                if r.best.function:
                    out.append(f"{r.seq_id}\t{r.best.function}\t"
                               f"{O.fmt_float(r.best.score)}\t"
                               f"{O.fmt_float(r.best.weighted_score)}\n")
            else:
                out.append(f"PROTEIN-ID\t{r.seq_id}\t{r.seq_len}\n")
                for c in r.calls:
                    out.append(O.format_call(c, eng.function_of))
                if details:
                    for h in r.hits:
                        out.append(O.format_hit(h, eng.function_of))
                out.append(O.format_otu_stats(r.seq_id, r.seq_len, r.otu))
        await _write(writer, "".join(out))


async def _fasta_batches(ctx, body):
    """Incrementally parse the FASTA body, yielding batches of (id, seq)
    (lookup_request.cc:101-138)."""
    items: list[tuple[str, str]] = []
    parser = fasta.FastaParser(on_seq=lambda i, s: items.append((i, s)))
    async for data in body.chunks():
        parser.parse_chunk(data)
        while len(items) >= ctx.batch_size:
            yield items[:ctx.batch_size]
            del items[:ctx.batch_size]
    parser.parse_complete()
    items = [(i, s) for i, s in items if i or s]
    while items:
        yield items[:ctx.batch_size]
        del items[:ctx.batch_size]


async def handle_connection(reader, writer, ctx: ServerContext):
    try:
        req = await read_request(reader)
        if req is None:
            return
        if req.headers.get("expect") == "100-continue":
            await _write(writer, f"HTTP/{req.http_version} 100 Continue\n\n")

        ctx.metrics.inc("requests")
        ctx.metrics.inc(f"requests{req.path.split('?')[0]}", 1)
        if req.type == "GET":
            await handle_get(ctx, req, writer)
        elif req.type == "POST":
            cl = req.headers.get("content-length")
            if cl is None:
                await _respond(writer, req.http_version, 500,
                               "Missing content length",
                               "Missing content length header\n")
                return
            if req.path == "/query":
                await handle_query(ctx, req, BodyStream(reader, int(cl)),
                                   writer)
            else:
                await _respond(writer, req.http_version, 404, "Not found",
                               "path not found\n")
    except (ConnectionResetError, BrokenPipeError):
        pass
    except Exception as e:  # 500 wall (krequest2.cc try/catch analogue)
        traceback.print_exc()
        try:
            await _respond(writer, "1.1", 500, "Error", f"error: {e}\n")
        except Exception:
            pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass


async def handle_get(ctx, req, writer):
    hv = req.http_version
    if req.path == "/quit":
        await _respond(writer, hv, 200, "OK", "OK, quitting\n")
        ctx.stop_event.set()
        return
    if req.path == "/version":
        out = []
        if ctx.kmer_version:
            out.append(f"kmer\t{ctx.kmer_version}\n")
        if ctx.families_version:
            out.append(f"families\t{ctx.families_version}\n")
        out.append(f"family-mode\t{'1' if ctx.family_mode else '0'}\n")
        await _respond(writer, hv, 200, "OK", "".join(out))
        return
    m = GENUS_PATH_RE.match(req.path)
    if m:
        root = ctx.mapping_map.get("")
        hit = root.genus_map.get(m.group(1)) if root else None
        if hit is None:
            await _respond(writer, hv, 404, "Not Found", "genus not found\n")
        else:
            await _respond(writer, hv, 200, "OK", hit + "\n")
        return
    if req.path == "/dump_mapping":
        # debugging dump to stdout (krequest2.cc:322-348)
        root = ctx.mapping_map.get("")
        for kmer, pegs in root._kmer_to_pegs.items():
            print(encoder.decode_kmer(kmer) + "\t" +
                  " ".join(root.decode_peg(p) for p in pegs))
        await _respond(writer, hv, 200, "OK", "Mapping dumped\n")
        return
    if req.path == "/metrics":
        await _respond(writer, hv, 200, "OK", ctx.metrics.render())
        return
    if req.path == "/checkpoint":
        try:
            path = ctx.checkpoint()
            await _respond(writer, hv, 200, "OK", "OK\n")
            print(f"checkpoint written to {path}", file=sys.stderr)
        except Exception as e:
            await _respond(writer, hv, 500, "Error", f"checkpoint failed: {e}\n")
        return
    if req.path == "/dump_sizes":
        out = ["memory dump\n"]
        for key, mapping in ctx.mapping_map.items():
            out.append(f"Mapping '{key}':\n")
            out.append(mapping.dump_sizes())
        await _respond(writer, hv, 200, "OK", "".join(out))
        return
    await _respond(writer, hv, 404, "Not found", "path not found\n")


async def serve(ctx: ServerContext, host: str = "0.0.0.0", port: int = 0,
                port_file: str | None = None):
    """Bind + serve until /quit (kserver.cc:132-214)."""
    server = await asyncio.start_server(
        lambda r, w: handle_connection(r, w, ctx), host, port)
    bound_port = server.sockets[0].getsockname()[1]
    if port_file:
        with open(port_file, "w") as f:
            f.write(f"{bound_port}\n")
    print(f"listening on port {bound_port}", file=sys.stderr)
    async with server:
        await ctx.stop_event.wait()
    return bound_port
