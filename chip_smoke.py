#!/usr/bin/env python3
"""Smoke run of the torch port's protein /query path on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``close_kmers_tpu_torch/csrc`` and drives the
port's main path on the card, phase by phase; any failure exits non-zero
and prints no result.  It needs one card, and exits 1 without one.

1. Device and build: the card's name and power limit (nvidia-smi), then
   ``nvcc`` builds the kernels for sm_90a (build seconds printed).
2. Kernels against their plain torch versions at main-path shapes (one
   4096 x 300-aa batch against the real-size DB of phase 4), exact
   equality, times from CUDA events.
3. The golden server on the card: the port's kser context on
   tests/golden/data with device="cuda", and the version / query /
   query_details / query_best conversations over a socket, byte for byte
   against tests/golden/*.resp.
4. Real size: bench.py's query corpus rebuilt from its seed (70,000
   source proteins x 300 aa, 4,096 functions: ~20.5M signature kmers;
   65,536 query proteins).  All queries go through
   DeviceScorer.score_batch_packed (slim pack) + native.best_call_batch in
   batches of 4096, and 4096 through KmerEngine.annotate_with_hits (the
   server's engine call); a 4096-query sample is held against
   native.HashPipeline call counts and against native.score_batch fed by
   a numpy searchsorted over the DB keys.
5. Both kernels' launch counters, reset just before phases 3-4, must be
   above 0.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

# bench.py's query corpus (bench.py:25-92)
N_SRC = 70_000
PROT_LEN = 300
N_QUERY = 65_536
BATCH = 4096
N_FUNCS = 4096
SAMPLE = 4096


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def build_corpus(host):
    """bench.py build_corpus, rebuilt from its seeds (no cache)."""
    rng = np.random.default_rng(0)
    off = rng.integers(0, 20, size=(N_SRC, PROT_LEN), dtype=np.int64
                       ).astype(np.uint8)
    W = PROT_LEN - 8 + 1
    o32 = off.astype(np.int32)
    hi = np.zeros((N_SRC, W), dtype=np.int32)
    lo = np.zeros((N_SRC, W), dtype=np.int32)
    for j in range(4):
        hi = hi * 20 + o32[:, j:j + W]
        lo = lo * 20 + o32[:, 4 + j:4 + j + W]
    keys = (hi.astype(np.int64) * 160000 + lo).ravel()
    del hi, lo, o32
    fi = np.repeat(np.arange(N_SRC, dtype=np.int64) % N_FUNCS, W)
    keys, idx = np.unique(keys, return_index=True)
    fi = fi[idx].astype(np.int32)
    rng = np.random.default_rng(len(keys))
    db = host.SignatureDB(
        keys, fi,
        rng.integers(-1, 64, size=len(keys)).astype(np.int32),
        rng.integers(0, PROT_LEN, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
        functions=[f"function {i}" for i in range(N_FUNCS)])
    qi = rng.integers(0, N_SRC, size=N_QUERY)
    width = -(-(PROT_LEN + 8) // 8) * 8
    offsets = np.full((N_QUERY, width), 20, dtype=np.uint8)
    offsets[:, :PROT_LEN] = off[qi]
    lengths = np.full(N_QUERY, PROT_LEN, dtype=np.int32)
    return db, offsets, lengths


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(want, got) -> float:
    """Largest |kernel - plain| over all output planes (as float64), after
    checking that every plane is equal bit for bit."""
    import torch
    err = 0.0
    for w, g in zip(want, got):
        w, g = w.cpu(), g.cpu()
        if w.dtype == torch.float32:
            check(torch.equal(w.view(torch.int32), g.view(torch.int32)),
                  "f32 plane differs bit-wise")
        else:
            check(torch.equal(w, g), f"{w.dtype} plane differs")
        err = max(err, float((w.double() - g.double()).abs().max())
                  if w.numel() else 0.0)
    return err


def phase_kernels(T, ddb, off_d, len_d, params):
    """Phase 2: each kernel against its plain version at the shapes the
    main path gives it."""
    import torch
    from close_kmers_tpu_torch.ops.probe_select import (probe_select,
                                                        probe_select_plain)
    from close_kmers_tpu_torch.ops.scan_score import (scan_score,
                                                      scan_score_plain)
    hi, lo, valid = T.encode_windows(off_d, len_d)
    flat = (hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    args = (*flat, ddb.payload_wide, ddb.wide_w, ddb.n)
    got = probe_select(*args)
    torch.cuda.synchronize()
    want = probe_select_plain(*args)
    torch.cuda.synchronize()
    err_p = max_abs_err(want, got)
    check(int(got[0].sum()) > 0, "probe found no hits")
    ms_p = cuda_ms(lambda: probe_select(*args), 20)
    plain_ms_p = cuda_ms(lambda: probe_select_plain(*args), 5)
    log(f"probe_select: N={flat[0].numel()} windows, row_w="
        f"{ddb.payload_wide.shape[1]}, wd={ddb.wide_w}: kernel {ms_p:.4f} ms,"
        f" plain {plain_ms_p:.4f} ms, max_abs_err {err_p}")

    sh = hi.shape
    found, fi, _oi, av, wt, _idx = (x.reshape(sh) for x in got)
    sargs = (found, fi, av, wt, params.min_hits, params.min_weighted_hits,
             params.max_gap, params.order_constraint)
    got_s = scan_score(*sargs)
    torch.cuda.synchronize()
    want_s = scan_score_plain(*sargs)
    torch.cuda.synchronize()
    check(int(want_s[0].sum()) > 0, "scan emitted no calls")
    err_s = max_abs_err([want_s[0], *want_s[1], *want_s[2].values()],
                        [got_s[0], *got_s[1], *got_s[2].values()])
    ms_s = cuda_ms(lambda: scan_score(*sargs), 20)
    plain_ms_s = cuda_ms(lambda: scan_score_plain(*sargs), 3)
    log(f"scan_score: B={sh[0]} W={sh[1]}: kernel {ms_s:.4f} ms, plain "
        f"{plain_ms_s:.4f} ms, max_abs_err {err_s}")
    return {
        "probe_select": dict(
            name="probe_select", route="cuda",
            source="close_kmers_tpu_torch/csrc/probe_select.cu",
            replaces="close_kmers_tpu/ops/pallas_select.py:54",
            max_abs_err=err_p, ms=ms_p, plain_ms=plain_ms_p),
        "scan_score": dict(
            name="scan_score", route="cuda",
            source="close_kmers_tpu_torch/csrc/scan_score.cu",
            replaces="close_kmers_tpu/ops/pallas_scan.py:150",
            max_abs_err=err_s, ms=ms_s, plain_ms=plain_ms_s),
    }


GOLDEN_CONVS = {
    "version": lambda body: b"GET /version HTTP/1.1\n\n",
    "query": lambda body:
        b"POST /query HTTP/1.1\nContent-length: %d\n\n" % len(body) + body,
    "query_details": lambda body:
        b"POST /query?details=1&min_hits=3 HTTP/1.1\nContent-length: %d\n\n"
        % len(body) + body,
    "query_best": lambda body:
        b"POST /query?find_best_call=1 HTTP/1.1\nContent-length: %d\n\n"
        % len(body) + body,
}


def _http(port: int, req: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(req)
        out = b""
        while True:
            c = s.recv(65536)
            if not c:
                return out
            out += c


def phase_golden(device) -> None:
    """Phase 3: the golden conversations through the port's server with
    its engine on the card."""
    from close_kmers_tpu_torch.cli.kser import load_server_context
    from close_kmers_tpu_torch.server.http import handle_connection

    ctx = load_server_context(os.path.join(GOLDEN, "data"), batch_size=64,
                              device=device)
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

    t = threading.Thread(target=lambda: loop.run_until_complete(run()))
    t.start()
    try:
        check(ready.wait(120), "golden server did not start")
        with open(os.path.join(GOLDEN, "queries.fa"), "rb") as f:
            body = f.read()
        for name, make in GOLDEN_CONVS.items():
            with open(os.path.join(GOLDEN, f"{name}.resp"), "rb") as f:
                want = f.read()
            got = _http(holder["port"], make(body))
            check(got == want, f"golden conversation {name} differs:\n"
                  f"{got[:400]!r}")
            log(f"golden {name}: {len(got)} bytes identical")
    finally:
        loop.call_soon_threadsafe(ctx.stop_event.set)
        t.join(60)
        ctx._compute.shutdown()
        loop.close()
    check(not t.is_alive(), "golden server thread did not stop")


def reference_calls(host, T, db, offsets, lengths, params):
    """Independent CPU reference for a sample: hits by a numpy
    searchsorted over the DB keys, scored by native.score_batch."""
    K = host.params.K
    B, L = offsets.shape
    W = L - K
    pos = np.arange(W)[None, :]
    windows_ok = pos < lengths[:, None] - K          # kguts.cc:792 bound
    bad = offsets >= 20
    for j in range(K):
        windows_ok &= ~bad[:, j:j + W]
    bi, p, codes = T._hit_codes(windows_ok, offsets)
    idx = np.minimum(np.searchsorted(db.keys, codes), len(db) - 1)
    hit = db.keys[idx] == codes
    bi, p, idx = bi[hit], p[hit], idx[hit]
    row_off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.bincount(bi, minlength=B), out=row_off[1:])
    return host.native.score_batch(p, db.fi[idx], db.oi[idx],
                                   db.avg_off[idx], db.wt[idx], row_off,
                                   params, max_calls_per_seq=64)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from close_kmers_tpu_torch import host
        from close_kmers_tpu_torch.core import engine as T
        from close_kmers_tpu_torch.core.api import KmerEngine
        from close_kmers_tpu_torch.core.device_score import DeviceScorer
        from close_kmers_tpu_torch.ops import _build
        from close_kmers_tpu_torch.ops.probe_select import probe_select
        from close_kmers_tpu_torch.ops.scan_score import scan_score
        from close_kmers_tpu_torch.utils.device import (
            gpu_name_and_power_limit, resolve_device)
    except ImportError as e:
        print(f"the port is not importable next to this script: {e}",
              file=sys.stderr)
        return 1
    check(sys.modules.get("jax") is None, "jax was imported")
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = gpu_name_and_power_limit()
    t_start = time.time()

    # -- phase 1: device and build
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s))")
    t0 = time.time()
    _build.build(force=True, verbose=True)
    log(f"phase 1: nvcc built {_build.LIB} in {time.time() - t0:.1f} s")

    # -- set-up: the real-size DB and queries (host)
    t0 = time.time()
    db, offsets, lengths = build_corpus(host)
    log(f"set-up: corpus + DB of {len(db):,} kmers (max bucket "
        f"{db.max_bucket}) built on the host in {time.time() - t0:.1f} s")
    params = host.EngineParams()
    t0 = time.time()
    ds = DeviceScorer(db, device)
    eng = KmerEngine(db, device)
    torch.cuda.synchronize()
    log(f"set-up: two payload-wide tables {tuple(ds.ddb.payload_wide.shape)} "
        f"built and uploaded in {time.time() - t0:.1f} s")

    # -- phase 2: kernels against their plain versions
    off_d = torch.from_numpy(offsets[:BATCH]).to(device)
    len_d = torch.from_numpy(lengths[:BATCH]).to(device)
    kernels = phase_kernels(T, ds.ddb, off_d, len_d, params)
    log("phase 2: both kernels equal their plain versions")

    # -- the main path, counted (and its peak device memory)
    probe_select.launches = 0
    scan_score.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- phase 3: golden server on the card
    phase_golden(device)
    log("phase 3: golden conversations byte-identical on the card")

    # -- phase 4: real size
    slim = ds.slim_mode()
    unpack = {2: DeviceScorer.unpack_dense2,
              3: DeviceScorer.unpack_dense3}[slim]
    chunks = [(np.ascontiguousarray(offsets[a:a + BATCH]),
               np.ascontiguousarray(lengths[a:a + BATCH]))
              for a in range(0, N_QUERY, BATCH)]

    def score_all(cap_per_seq):
        counts = []
        n_calls_total = 0
        for c_off, c_len in chunks:
            cap = cap_per_seq
            while True:
                out, cap_n = ds.score_batch_packed(c_off, c_len, params,
                                                   calls_per_seq_cap=cap,
                                                   slim=slim)
                dense = unpack(out.cpu().numpy(), len(c_off), cap_n)
                if dense is not None:
                    break
                cap *= 4
            n_calls, cc, cf, cw = dense
            host.native.best_call_batch(n_calls, None, None, cc, cf, cw)
            counts.append((n_calls, cc, cf, cw))
            n_calls_total += int(n_calls.sum())
        return counts, n_calls_total

    score_all(2)                                     # warm-up pass
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        counts, n_calls_total = score_all(2)
        torch.cuda.synchronize()
        passes.append(time.time() - t0)
    dt_ds = sorted(passes)[1]
    rate_ds = N_QUERY / dt_ds
    log(f"phase 4: DeviceScorer slim={slim}: {N_QUERY} proteins, "
        f"{n_calls_total} calls per pass; passes {passes} s; median "
        f"{dt_ds:.4f} s = {rate_ds:.0f} proteins/s")

    alpha = np.frombuffer(host.encoder.PROT_ALPHA.encode(), np.uint8)
    items = [(f"q{i}", alpha[offsets[i, :lengths[i]]].tobytes().decode())
             for i in range(SAMPLE)]
    eng.annotate_with_hits(items[:64], params, want_otu=True,
                           want_code=False)             # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    results, _h = eng.annotate_with_hits(items, params, want_otu=True,
                                         want_code=False)
    dt_eng = time.time() - t0
    rate_eng = SAMPLE / dt_eng
    log(f"phase 4: KmerEngine.annotate_with_hits: {SAMPLE} proteins in "
        f"{dt_eng:.3f} s = {rate_eng:.0f} proteins/s")
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4: peak device memory {peak} B ({peak / 2**30:.2f} GiB)")

    # correctness on the sample: independent CPU references
    s_off, s_len = offsets[:SAMPLE], lengths[:SAMPLE]
    t0 = time.time()
    hp_counts = host.native.HashPipeline(db).run(s_off, s_len,
                                                 params.min_hits,
                                                 params.max_gap)
    n_ref, cs, ce, cc, cf, cw, _ = reference_calls(host, T, db, s_off, s_len,
                                                   params)
    log(f"phase 4: CPU references for {SAMPLE} proteins in "
        f"{time.time() - t0:.1f} s")
    ds_n, ds_cc, ds_cf, ds_cw = counts[0]
    check(np.array_equal(hp_counts, n_ref),
          "HashPipeline and the searchsorted reference disagree")
    check(np.array_equal(ds_n, hp_counts),
          "DeviceScorer call counts differ from HashPipeline")
    check(int(ds_n.sum()) > 0, "no calls in the sample")
    eng_n = np.array([len(r.calls) for r in results])
    check(np.array_equal(eng_n, hp_counts),
          "KmerEngine call counts differ from HashPipeline")
    for s, r in enumerate(results):
        want = [(int(cs[s, i]), int(ce[s, i]), int(cc[s, i]), int(cf[s, i]),
                 int(np.float32(cw[s, i]).view(np.int32)))
                for i in range(int(n_ref[s]))]
        got = [(c.start, c.end, c.count, c.fI,
                int(np.float32(c.weighted).view(np.int32)))
               for c in r.calls]
        check(got == want, f"KmerEngine calls differ for query {s}")
        got_ds = [(int(ds_cc[s, i]), int(ds_cf[s, i]),
                   int(np.float32(ds_cw[s, i]).view(np.int32)))
                  for i in range(int(ds_n[s]))]
        check(got_ds == [w[2:] for w in want],
              f"DeviceScorer calls differ for query {s}")
    log(f"phase 4: {SAMPLE}-protein sample matches the native CPU references "
        f"({int(n_ref.sum())} calls)")

    # -- phase 5: the main path went through both kernels
    launches = {"probe_select": probe_select.launches,
                "scan_score": scan_score.launches}
    log(f"phase 5: launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    log(f"all phases passed in {time.time() - t_start:.1f} s; "
        f"DeviceScorer {rate_ds:.0f} proteins/s, KmerEngine {rate_eng:.0f} "
        f"proteins/s, peak {peak} B on {card}")

    records = [dict(kernels[k], launches=launches[k]) for k in kernels]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
