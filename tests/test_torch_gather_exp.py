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
    so does an experiment this port does not run."""
    with pytest.raises(ValueError, match="CUDA"):
        TG.run(["xla8"], "cpu")
    with pytest.raises(ValueError, match="probe111"):
        TG.run(["probe111"], "cpu")
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
