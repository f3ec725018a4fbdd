"""Spans and counters of the traced run, recorded from the benchmark's own
code: each call into a layer of the program is wrapped from outside
(``setattr`` on its owner, as chip_smoke.py's ``stage_profile`` does)
and timed by ``time.monotonic()``.  Nothing here edits the program.

What is recorded, only while :attr:`Recorder.on` (the measured window):

* ``requests``: each /query or /lookup handler (``server/http.py``):
  start, end, and the engine jobs it submitted;
* ``jobs``: each job of ``ServerContext``'s one compute thread: when it
  was submitted, when it started and ended, and the proteins of the
  engine call it ran (``core/api.py``);
* ``spans``: (layer, start, end) on the compute thread for host scoring
  (``native/api.py`` score_batch and best_call_batch, ``core/family.py``
  find_best_family_matches_batch), the device program
  (``FastAnnotator.probe_compact``; ``DeviceFamilyScorer.
  score_family_packed`` and the readback's wait) and padding
  (``FastAnnotator.pad_batch``);
* counters: windows scanned (pad_batch's lengths) and probed
  (encode_windows' shapes), and each probe_search and family_group
  launch's shape and a device-side count of what it found or grouped.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import threading
import time

K = 8
HOST_SCORE = "host_score"
DEVICE_PROGRAM = "device_program"
PAD = "pad_batch"

_request = contextvars.ContextVar("kserbench_request", default=None)


class Recorder:
    def __init__(self):
        self.on = False
        self.requests: dict = {}
        self.jobs: list = []
        self.spans: list = []
        self.valid_windows = 0
        self.probed_windows = 0
        self.probe_launches: list = []   # (windows, found count tensor)
        self.group_launches: list = []   # (B, W, D, cap, n_groups tensor)
        self._ids = itertools.count()
        self._local = threading.local()
        self._saved: list = []

    # -- wrappers ---------------------------------------------------------

    def _patch(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        wrapped = functools.wraps(orig)(make(orig))
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapped)

    def _handler(self, orig):
        async def handler(ctx, req, *a, **kw):
            if not self.on:
                return await orig(ctx, req, *a, **kw)
            rid = next(self._ids)
            info = self.requests[rid] = dict(start=time.monotonic(),
                                             end=None, jobs=[])
            token = _request.set(info)
            try:
                return await orig(ctx, req, *a, **kw)
            finally:
                info["end"] = time.monotonic()
                _request.reset(token)
        return handler

    def _submit(self, orig):
        def submit(fn, *a, **kw):
            info = _request.get()
            if not self.on or info is None:
                return orig(fn, *a, **kw)
            job = dict(submit=time.monotonic(), start=None, end=None, n=0)
            self.jobs.append(job)
            info["jobs"].append(job)

            def run(*a2, **kw2):
                job["start"] = time.monotonic()
                self._local.job = job
                try:
                    return fn(*a2, **kw2)
                finally:
                    self._local.job = None
                    job["end"] = time.monotonic()
            return orig(run, *a, **kw)
        return submit

    def _engine(self, orig):
        def call(eng, items, *a, **kw):
            job = getattr(self._local, "job", None)
            if job is not None:
                job["n"] += len(items)
            return orig(eng, items, *a, **kw)
        return call

    def _span(self, layer: str):
        def make(orig):
            def call(*a, **kw):
                if not self.on:
                    return orig(*a, **kw)
                t0 = time.monotonic()
                try:
                    return orig(*a, **kw)
                finally:
                    self.spans.append((layer, t0, time.monotonic()))
            return call
        return make

    def _pad(self, orig):
        span = self._span(PAD)(orig)

        def call(fa, seqs, *a, **kw):
            offsets, lengths = span(fa, seqs, *a, **kw)
            if self.on:
                self.valid_windows += int((lengths - K).clip(min=0).sum())
            return offsets, lengths
        return call

    def _encode(self, orig):
        def call(offsets, lengths):
            out = orig(offsets, lengths)
            if self.on:
                self.probed_windows += out[0].numel()
            return out
        return call

    def _probe(self, orig):
        def call(hi, *a, **kw):
            out = orig(hi, *a, **kw)
            if self.on:
                self.probe_launches.append((hi.numel(), out[0].sum()))
            return out
        return call

    def _group(self, orig):
        def call(fams, cap):
            out = orig(fams, cap)
            if self.on:
                B, W, D = fams.shape
                self.group_launches.append((B, W, D, cap, out[0]))
            return out
        return call

    def install(self, ctx) -> None:
        """Wrap the program's layers for ``ctx``'s server."""
        from close_kmers_tpu_torch.core import (api, device_family,
                                                device_score, engine, family)
        from close_kmers_tpu_torch.native import api as native
        from close_kmers_tpu_torch.server import http
        for name in ("handle_query", "handle_lookup"):
            self._patch(http, name, self._handler)
        self._patch(ctx._compute, "submit", self._submit)
        for name in ("annotate_with_hits", "best_family_matches"):
            self._patch(api.KmerEngine, name, self._engine)
        for owner, name in ((native, "score_batch"),
                            (native, "best_call_batch"),
                            (family, "find_best_family_matches_batch")):
            self._patch(owner, name, self._span(HOST_SCORE))
        for owner, name in ((engine.FastAnnotator, "probe_compact"),
                            (device_family.DeviceFamilyScorer,
                             "score_family_packed"),
                            (api._Readback, "result")):
            self._patch(owner, name, self._span(DEVICE_PROGRAM))
        self._patch(engine.FastAnnotator, "pad_batch", self._pad)
        for mod in (engine, device_family, device_score):
            self._patch(mod, "encode_windows", self._encode)
        self._patch(engine, "probe_search", self._probe)
        self._patch(device_family, "family_group", self._group)

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    # -- readings ---------------------------------------------------------

    def found_windows(self) -> int:
        return int(sum(int(n) for _, n in self.probe_launches))

    def groups(self) -> list:
        """(B, W, D, groups) of each family_group launch: the groups it
        wrote, at most cap a row."""
        return [(B, W, D, int(n.clamp(max=cap).sum()))
                for B, W, D, cap, n in self.group_launches]
