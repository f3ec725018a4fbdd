"""Port parity for the probe-gather experiments: the plain versions of the
four kernels of ``close_kmers_tpu_torch/ops/gather_exp.py`` against the
Pallas kernels of ``scripts/gather_exp.py`` in interpret mode, and the
experiment bodies of ``close_kmers_tpu_torch/scripts/gather_exp.py``
against the JAX script's, on inputs made with numpy from a seed.  Zero
tolerance: the sums stay below 2^24, where the Pallas f32 sums are exact
(above it only the port's exact-then-rounded sum is defined, tested
against numpy)."""

import functools
import importlib
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from close_kmers_tpu_torch.ops import gather_exp as gx
from close_kmers_tpu_torch.scripts import gather_exp as TG

G = importlib.import_module("scripts.gather_exp")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,w", [(1024, 128), (512, 24)])
def test_dma_gather_matches_pallas(monkeypatch, n, w):
    """pallas_dma_gather has no interpret flag and reads the module's
    N_IDX: both are patched, as its own tiling needs n % 512 == 0."""
    monkeypatch.setattr(G.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(G, "N_IDX", n)
    rng = np.random.default_rng(n + w)
    table = rng.integers(-(1 << 30), 1 << 30, size=(3001, w)).astype(np.int32)
    idx = rng.integers(0, 3001, size=n).astype(np.int32)
    want = np.asarray(G.pallas_dma_gather(jnp.asarray(table),
                                          jnp.asarray(idx), w, n))
    got = gx.dma_gather(t(table), t(idx))
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(want, table[idx])


def test_dma_gather_any_n_and_its_checks():
    rng = np.random.default_rng(3)
    table = rng.integers(0, 100, size=(50, 5)).astype(np.int32)
    for n in (0, 1, 777):
        idx = rng.integers(0, 50, size=n).astype(np.int32)
        assert np.array_equal(gx.dma_gather(t(table), t(idx)).numpy(),
                              table[idx])
    with pytest.raises(IndexError):
        gx.dma_gather(t(table), torch.tensor([0, 50], dtype=torch.int32))
    with pytest.raises(IndexError):
        gx.dma_gather(t(table), torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(ValueError):
        gx.dma_gather(t(table), torch.zeros(3, dtype=torch.int32), depth=3)
    with pytest.raises(TypeError):
        gx.dma_gather(t(table), torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("rows,n_chunks", [(64, 3), (128, 2)])
def test_vgather_matches_pallas(rows, n_chunks):
    """pallas_vgather gathers ``chunk == tile_rows`` ids per grid step;
    its (8, 128)-broadcast output tile carries one sum per chunk."""
    rng = np.random.default_rng(rows)
    tile = rng.integers(0, 100, size=(rows, 128)).astype(np.int32)
    idx = rng.integers(0, rows, size=rows * n_chunks).astype(np.int32)
    vg = G.pallas_vgather(idx.size, rows, 128, rows)
    want = np.asarray(vg(jnp.asarray(idx.reshape(-1, 8, rows // 8)),
                         jnp.asarray(tile)))
    assert want.shape == (n_chunks, 8, 128)
    assert (want == want[:, :1, :1]).all()
    got = gx.vgather(t(tile), t(idx), rows)
    assert got.dtype == torch.float32
    assert np.array_equal(want[:, 0, 0].view(np.int32),
                          got.numpy().view(np.int32))


def test_vgather_sum_is_exact_then_rounded():
    """Above 2^24 the sum is the exact integer sum rounded once to f32
    (the Pallas f32 sum depended on its order there)."""
    rng = np.random.default_rng(9)
    tile = rng.integers(1 << 20, 1 << 28, size=(448, 128)).astype(np.int32)
    idx = rng.integers(0, 448, size=4 * 2048).astype(np.int32)
    got = gx.vgather(t(tile), t(idx), 2048).numpy()
    exact = tile.astype(np.int64)[idx].reshape(4, -1).sum(axis=1)
    assert (exact > 1 << 40).all()
    assert np.array_equal(got, exact.astype(np.float32))
    with pytest.raises(ValueError):
        gx.vgather(t(tile), t(idx[:100]), 2048)
    with pytest.raises(IndexError):
        gx.vgather(t(tile[:10]), t(idx), 2048)


@pytest.mark.parametrize("n_rows,blk", [(70, 16), (64, 64)])
def test_hbmstream_matches_pallas(n_rows, blk):
    """One sum per whole block of rows; rows past the last whole block
    are not read (70 rows in blocks of 16: four sums)."""
    rng = np.random.default_rng(n_rows + blk)
    tbl = rng.integers(-1000, 1000, size=(n_rows, 128)).astype(np.int32)
    want = np.asarray(G.pallas_hbmstream(n_rows, 128, blk)(jnp.asarray(tbl)))
    got = gx.hbmstream(t(tbl), blk)
    assert got.shape == (n_rows // blk,)
    assert np.array_equal(want[:, 0, 0].view(np.int32),
                          got.numpy().view(np.int32))


@pytest.mark.parametrize("n_dmas,rpd", [(512, 2), (256, 8)])
def test_dmaflush_matches_pallas(n_dmas, rpd):
    """Every program flushes the same staged buffer (the TPU's index map
    (0, 0)) to the rows its dst slice names."""
    rng = np.random.default_rng(n_dmas + rpd)
    dst = rng.permutation(n_dmas).astype(np.int32).reshape(-1, 256)
    buf = rng.integers(0, 1 << 30, size=(256 * rpd, 128)).astype(np.int32)
    want = np.asarray(G.pallas_dmaflush(n_dmas, rpd, 128)(
        jnp.asarray(dst), jnp.asarray(buf)))
    got = gx.dmaflush(t(dst), t(buf), rpd)
    assert np.array_equal(want, got.numpy())


def test_dmaflush_needs_a_permutation():
    buf = torch.zeros((4 * 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):       # a repeated row
        gx.dmaflush(torch.tensor([[0, 1, 1, 3]], dtype=torch.int32), buf, 2)
    with pytest.raises(IndexError):       # a row past the output
        gx.dmaflush(torch.tensor([[0, 1, 2, 4]], dtype=torch.int32), buf, 2)
    with pytest.raises(ValueError):       # buf is not 4 slots of 3 rows
        gx.dmaflush(torch.tensor([[0, 1, 2, 3]], dtype=torch.int32), buf, 3)


@pytest.mark.parametrize("width", [8, 111])
def test_gather_bodies_match_jax(width):
    """The experiments' plain body (``table[idx]`` and its check value)
    against the JAX script's xla_gather; the dma_gather body's check
    value on the plain gather is the same number."""
    rng = np.random.default_rng(width)
    table = rng.integers(0, 1 << 30, size=(5000, width)).astype(np.int32)
    idx = rng.integers(0, 5000, size=20000).astype(np.int32)
    want = np.asarray(G.xla_gather(jnp.float32(0), jnp.asarray(table),
                                   jnp.asarray(idx)))
    got = TG.xla_gather(t(table), t(idx))
    assert got.dtype == torch.float32 and float(got) == float(want)
    assert float(TG.sum4(gx.dma_gather(t(table), t(idx)))) == float(want)


def test_deep_db_probes_equal_on_both_tiers():
    """deepcmp's DB at a small size, on the sub_blocks tier the JAX gates
    pick for it (forced by their flags, as deepcmp does), probes as the
    binary search does (the check deepcmp makes on the card)."""
    from close_kmers_tpu_torch.core.engine import (JAX_TIER_FLAGS, DeviceDB,
                                                   jax_tier, probe_windows)
    db = TG.deep_db(n_keys=30_000, hi_span=150, seed=4)
    rng = np.random.default_rng(4)
    hi = t(rng.integers(0, 150, size=(1, 20000)).astype(np.int32))
    lo = t(rng.integers(0, 8000, size=(1, 20000)).astype(np.int32))
    hi[0, :5000] = t(db.hi[:5000])            # hits
    lo[0, :5000] = t(db.lo[:5000])
    valid = torch.rand(1, 20000, generator=torch.Generator().manual_seed(4)
                       ) < 0.95
    assert jax_tier(db) == "sub_blocks"
    d_sub = DeviceDB.from_db(db, "cpu", **JAX_TIER_FLAGS["sub_blocks"])
    d_bin = DeviceDB.from_db(db, "cpu", sub=False)
    assert (d_sub.tier, d_bin.tier) == ("sub_blocks", "binary_search")
    a = probe_windows(d_sub, hi, lo, valid)
    b = probe_windows(d_bin, hi, lo, valid)
    assert int(a[0].sum()) > 4000
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
    assert float(TG.probe_sum(d_sub, hi, lo, valid)) == \
        float(TG.probe_sum(d_bin, hi, lo, valid))


def test_the_entry_point_needs_a_card():
    """The measurements time the card: on a CPU device they refuse, and
    so does an experiment that does not exist."""
    with pytest.raises(ValueError, match="CUDA"):
        TG.run(["xla8"], "cpu")
    with pytest.raises(ValueError, match="no_such_exp"):
        TG.run(["no_such_exp"], "cpu")
    if not torch.cuda.is_available():
        assert TG.main(["xla8"]) == 1


def test_gather_exp_runs_without_jax():
    """The entry point and its kernels' module import with jax
    unavailable; without a card ``main`` refuses with exit code 1."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from close_kmers_tpu_torch.scripts import gather_exp as TG\n"
        "from close_kmers_tpu_torch.ops import gather_exp as gx\n"
        "t = torch.arange(12, dtype=torch.int32).reshape(4, 3)\n"
        "assert gx.dma_gather(t, torch.tensor([3, 0], dtype=torch.int32))"
        ".tolist() == [[9, 10, 11], [0, 1, 2]]\n"
        "db = TG.deep_db(n_keys=5000, hi_span=20, seed=1)\n"
        "from close_kmers_tpu_torch.core import engine as T\n"
        "assert T.jax_tier(db) == 'sub_blocks'\n"
        "assert T.DeviceDB.from_db(db, 'cpu').tier == T.card_tier(db)\n"
        "assert torch.cuda.is_available() or TG.main(['xla8']) == 1\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CLOSE_KMERS_JAX_PLATFORM"}
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr


# The experiments of scripts/gather_exp.py's main beyond the floors above,
# by the names main selects them with; each case's measured names.
EXP_CASES = {
    "width1": ["width1", "width1_bitmap"],
    "probe_planes192": ["probe_planes192"],
    "gsort15m": ["gsort15m"],
    "probe111 probe128": ["probe111", "probe128"],
    "probe_fused64 probe_fused128": ["probe_fused64", "probe_fused128"],
    "probe128b": ["probe128b"],
    "probepal": ["probepal"],
    "pf0 pf1 pf2 pf3": ["pf0", "pf1", "pf2", "pf3"],
    "pf0f pf0p": ["pf0f", "pf0p"],
    "pfcross": ["sel_on_pfdata"],
    "sortflat_bad sortflat_good": ["sortflat_bad", "sortflat_good"],
    "rowsort_bad rowsort_odd": ["rowsort_bad", "rowsort_odd"],
    "probe2g": ["probe2g"],
    "xsort xargsort xsortpair": ["xsort", "xargsort", "xsortpair"],
    "xsort3": ["xsort3", "xsort6"],
    "scale_bin scale_csr slice128 slice256 scale_wide scale_fused "
    "scale_pay": ["slice128", "slice256", "scale_csr", "scale_wide",
                  "scale_fused", "scale_pay", "scale_bin"],
}
# leading sizes of the JAX script's fixed-size streams (flat probes of
# B x 304, the 14.96M flags of gsort15m, the cliff sizes) and rows of its
# [8192, W] batches: the bodies run on their first STREAM_CUT entries and
# first ROWS_CUT rows, both sides on the same arrays
STREAMS = {8192 * 304, 16384 * 913, 2_498_560, 2_498_568}
STREAM_CUT, ROWS_CUT = 40_000, 48


def _cut(a):
    a = np.asarray(a)
    if a.ndim >= 1 and a.shape[0] in STREAMS:
        return a[:STREAM_CUT]
    if a.ndim == 2 and a.shape[0] == 8192 and a.shape[1] > 1:
        return a[:ROWS_CUT]
    return a


def run_jax_main(monkeypatch, capsys, names):
    """scripts/gather_exp.main on JAX's CPU backend at small N_ROWS,
    N_IDX and EXP_SCALE_KEYS with ``measure`` recording (name, body,
    arrays) instead of timing, and the Pallas select in interpret mode.
    Returns the records and what main printed."""
    import close_kmers_tpu.ops.pallas_select as PS
    got = []
    monkeypatch.setattr(G, "N_ROWS", 3000)
    monkeypatch.setattr(G, "N_IDX", 5000)
    monkeypatch.setenv("EXP_SCALE_KEYS", "150000")
    monkeypatch.setattr(sys, "argv", ["gather_exp.py", *names])
    monkeypatch.setattr(G, "measure",
                        lambda name, fn, *args: got.append((name, fn, args)))
    monkeypatch.setattr(G.jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(PS, "select_wide_rows", functools.partial(
        PS.select_wide_rows, interpret=True))
    G.main()
    return got, capsys.readouterr().out


def _port_body(name, fn, printed):
    """The port's body of the JAX experiment ``name`` (``fn`` its JAX
    body), its static arguments bound as the JAX body binds them."""
    if name in ("pf0", "pf1", "pf2", "pf3"):
        return functools.partial(TG.pf_body, int(name[2]), G.N_ROWS)
    m = re.search(r"scale DB: ([0-9,]+) keys, max bucket (\d+)", printed)
    if name.startswith("scale_") and name != "scale_pay" \
            and name != "scale_csr":
        n, max_b = int(m.group(1).replace(",", "")), int(m.group(2))
        if name == "scale_bin":
            return functools.partial(TG.bin_body, fn.keywords["n_steps"], n)
        if name == "scale_wide":
            return functools.partial(TG.wide_body, max_b)
        return functools.partial(TG.scale_fused_body, max_b, n)
    return TG.BODIES[name]


@pytest.mark.parametrize("names", list(EXP_CASES))
def test_experiment_bodies_match_jax(monkeypatch, capsys, names):
    """Each experiment's body in the port against the JAX script's body
    on the JAX script's own arrays (made by its main from its numpy seed;
    a fixed-size stream cut to its first entries), zero tolerance: the
    int sums stay exact and f32 weights are bit patterns of small ints.
    probepal's rows get distinct lo slots first (a DB's rows have them;
    the kernel selects the one match, the Pallas sums add repeated ones)."""
    import jax.numpy as jnp
    got, printed = run_jax_main(monkeypatch, capsys, names.split())
    assert [name for name, _f, _a in got] == EXP_CASES[names]
    hits = None
    for name, fn, args in got:
        args = [_cut(a) for a in args]
        if name == "scale_csr":
            # the scale DB holds ~0.05 keys a bucket here, so the JAX
            # script's random probes all miss: the first 2,000 probes of
            # every scale probe become keys of the DB
            pair, lo_pad = args[0], args[1]
            rows = np.random.default_rng(0).integers(0, pair[-1, 1], 2000)
            hits = (np.searchsorted(pair[:, 1], rows, side="right")
                    .astype(np.int32), lo_pad[rows])
        if name in ("scale_csr", "scale_wide", "scale_fused", "scale_bin"):
            args[-2] = np.concatenate([hits[0], args[-2][2000:]])
            args[-1] = np.concatenate([hits[1], args[-1][2000:]])
        if name == "probepal":
            table = args[0].copy()
            table[:, 1:1 + TG.WD] = TG.distinct_lo_rows(
                torch.Generator().manual_seed(1), len(table), 128, TG.WD,
                "cpu")[:, 1:1 + TG.WD].numpy()
            args[0] = table
        want = np.float32(fn(jnp.float32(0), *map(jnp.asarray, args)))
        body = _port_body(name, fn, printed)
        have = body(*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in args))
        assert have.dtype == torch.float32 and have.dim() == 0
        assert float(have) == float(want), name


def test_distinct_lo_rows_and_probepal_select():
    """probepal's table: lo slots distinct in every row; on it the
    port's body equals probe128's arithmetic (a unique match makes the
    masked sums the matched slot's values)."""
    g = torch.Generator().manual_seed(3)
    tbl = TG.distinct_lo_rows(g, 2000, 128, TG.WD, "cpu")
    lo = tbl[:, 1:1 + TG.WD]
    assert (lo >= 0).all() and (lo < 100).all()
    assert all(len(set(r)) == TG.WD for r in lo.tolist())
    idx = torch.randint(0, 2000, (6000,), generator=g, dtype=torch.int32)
    lo_q = torch.randint(0, 100, (6000,), generator=g, dtype=torch.int32)
    assert float(TG.probepal_body(tbl, idx, lo_q)) == \
        float(TG.probe_select_body(TG.WD, tbl, idx, lo_q))


def test_scale_tables_as_the_jax_script_lays_them_out():
    """The scale experiments' DB made by torch: bucket counts and pairs
    agree, lo codes sorted within each bucket and padded by -9, and the
    lo_wide and fused rows hold each key at its slot."""
    g = torch.Generator().manual_seed(5)
    t = TG.scale_tables(400_000, g, "cpu")
    n, max_b = t["n"], t["max_b"]
    pair, los = t["pair"].long(), t["los"]
    assert int(pair[-1, 1]) == n == len(los) and max_b >= 1
    assert torch.equal(pair[:, 1] - pair[:, 0], t["cnt"])
    inside = t["seg"][1:] == t["seg"][:-1]
    assert (los[1:][inside] >= los[:-1][inside]).all()
    assert (t["lo_pad"][n:] == -9).all() and t["payload"].shape == (n + 1, 4)
    lw = TG.scale_wide_table(t)
    fw = TG.scale_fused_table(t, g)
    rows, slot = t["seg"], t["rank"]
    assert torch.equal(lw[rows, 1 + slot], los)
    assert torch.equal(fw[rows, 1 + slot] & TG.FUSED_MASK, los)
    assert torch.equal(lw[:, 0].long(), pair[:, 0])
    wt = fw[rows, 1 + max_b + slot].view(torch.float32)
    assert (wt >= 0.1).all() and (wt < 4.0).all()


def _np_scale_bodies(idx, bitmap, small, wide, mask, n8):
    """scripts/gather_scale_exp.py's five closures restated in numpy:
    int32 (wrapping) sums as f32, jnp.argsort's stable order."""
    def f32(x):
        return np.float32(x.astype(np.int64).sum().astype(np.int32))
    order = np.argsort(~mask, kind="stable")[:n8]
    w = bitmap[idx >> 5]
    return dict(bitmap=f32((w >> (idx & 31)) & 1), small=f32(small[idx]),
                wide=f32(wide[idx]), compact=f32(idx[order]),
                filtered=f32(wide[idx[order]]))


@pytest.mark.parametrize("n,h,density", [(20_000, 3_200, 0.08),
                                         (5_000, 640, 0.5)])
def test_gather_scale_bodies_match_numpy(n, h, density):
    """The port's gather_scale_exp bodies against numpy restatements of
    the JAX closures (the JAX script builds a 1.4-GB table in its main,
    too large for these tests, so its closures are restated, not run),
    on small arrays drawn as it draws them; zero tolerance."""
    from close_kmers_tpu_torch.scripts import gather_scale_exp as GS
    rng = np.random.default_rng(n)
    idx = rng.integers(0, h, size=n).astype(np.int32)
    bitmap = rng.integers(-2**31, 2**31 - 1, size=h // 32, dtype=np.int32)
    small = rng.integers(0, 100, size=h, dtype=np.int32)
    wide = rng.integers(0, 100, size=(h, GS.WIDTH), dtype=np.int32)
    mask = rng.random(n) < density
    n8 = int(n * density)
    want = _np_scale_bodies(idx, bitmap, small, wide, mask, n8)
    ti, tb, ts, tw, tm = map(t, (idx, bitmap, small, wide, mask))
    got = dict(bitmap=GS.s_bitmap(ti, tb), small=GS.s_small(ti, ts),
               wide=GS.s_wide(ti, tw), compact=GS.s_compact(ti, tm, n8),
               filtered=GS.s_filtered(ti, tm, tw, n8))
    for k, v in got.items():
        assert v.dtype == torch.float32 and float(v) == float(want[k]), k


def test_gather_scale_exp_needs_a_card():
    from close_kmers_tpu_torch.scripts import gather_scale_exp as GS
    with pytest.raises(ValueError, match="CUDA"):
        GS.run("cpu")
    if not torch.cuda.is_available():
        assert GS.main([]) == 1
