"""The system under test: the port's server, built from the benchmark's
DB arrays and family universe and run as users reach it.

This is the one module of the harness that imports the program
(``close_kmers_tpu_torch``): its SignatureDB, KmerFamilyMapping,
KmerEngine and ``server.http``.  The server runs ``http.serve()`` on an
ephemeral loopback port on a thread of this process and stops by
``GET /quit``."""

from __future__ import annotations

import asyncio
import os
import shutil
import socket
import tempfile
import threading
import time


class Server:
    """The port's server over ``db`` (and ``universe`` in family mode) on
    ``device``; :meth:`start` opens it, :meth:`stop` ends it and frees
    the program's state."""

    def __init__(self, db, universe, family_mode: bool, device):
        from close_kmers_tpu_torch.core.api import KmerEngine
        from close_kmers_tpu_torch.db.family_db import (FamilyData,
                                                        KmerFamilyMapping)
        from close_kmers_tpu_torch.db.signature_db import SignatureDB
        from close_kmers_tpu_torch.server import http
        self.http = http
        sdb = SignatureDB(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                          functions=list(db.functions))
        self.ctx = http.ServerContext(KmerEngine(sdb, device),
                                      family_mode=family_mode)
        if universe is not None:
            mapping = KmerFamilyMapping()
            mapping.families = [
                FamilyData(p, l, g, f, i, 10, 10) for i, (p, l, g, f) in
                enumerate(zip(universe.pgf, universe.plf,
                              universe.genus_id, universe.function))]
            # the bulk CSR, as the port's load_nr leaves it
            mapping._bulk_fam = (universe.keys, universe.offs, universe.vals)
            self.ctx.mapping_map[""] = mapping
        self.port = None
        self._thread = None
        self._dir = None

    def start(self, timeout: float = 60.0) -> int:
        self._dir = tempfile.mkdtemp(prefix="kserbench-")
        port_file = os.path.join(self._dir, "port")
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self.http.serve(
                self.ctx, "127.0.0.1", 0, port_file)),
            name="kser-server", daemon=True)
        self._thread.start()
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end and self._thread.is_alive():
            try:
                with open(port_file) as f:
                    text = f.read()
                if text.endswith("\n"):
                    self.port = int(text)
                    return self.port
            except FileNotFoundError:
                pass
            time.sleep(0.01)
        raise RuntimeError("the server did not start")

    def stop(self, timeout: float = 60.0) -> None:
        """``GET /quit``, then wait for the server thread and the compute
        thread, and drop the program's state."""
        try:
            if self.port is not None and self._thread.is_alive():
                with socket.create_connection(("127.0.0.1", self.port),
                                              timeout=timeout) as s:
                    s.sendall(b"GET /quit HTTP/1.1\n\n")
                    while s.recv(1 << 16):
                        pass
            if self._thread is not None:
                self._thread.join(timeout)
                if self._thread.is_alive():
                    raise RuntimeError("the server thread did not end")
        finally:
            self.ctx._compute.shutdown(wait=True)
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
            self.ctx = None
