"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips when torch sees no card.  On the machine
with the card (which has no jax) run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports torch and the port only, never jax.
"""

import numpy as np
import pytest
import torch

from close_kmers_tpu_torch.core.device_score import DeviceScorer
from close_kmers_tpu_torch.core.engine import FastAnnotator
from close_kmers_tpu_torch.host import EngineParams, SignatureDB, params as P
from close_kmers_tpu_torch.ops.probe_select import (probe_select,
                                                    probe_select_plain)
from close_kmers_tpu_torch.ops.scan_score import (FLOAT_FIELDS, INT_FIELDS,
                                                  scan_score,
                                                  scan_score_plain)

pytestmark = pytest.mark.cuda

SCAN_PARAMS = [(5, 0, 200, 0), (2, 0, 10, 0), (1, 2, 50, 0), (2, 0, 200, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _random_table(rng, H, wd, row_w, n):
    pw = rng.integers(0, 1 << 20, size=(H, row_w)).astype(np.int32)
    lo = np.full((H, wd), 2 ** 30, np.int32)
    depth = rng.integers(0, wd + 1, size=H)
    for h in range(H):
        lo[h, :depth[h]] = rng.choice(P.LO_CARD, size=depth[h], replace=False)
    pw[:, 1:1 + wd] = lo
    pw[:, 0] = rng.integers(0, n, size=H)
    return pw, lo, depth


@pytest.mark.parametrize("wd", [1, 7, 32, 45])
def test_probe_select_kernel_matches_plain(cuda, wd):
    rng = np.random.default_rng(wd)
    H, N, n = 5000, 20000, 12345
    row_w = 1 + 5 * wd + 3
    pw, lo_plane, depth = _random_table(rng, H, wd, row_w, n)
    hi = rng.integers(0, H, size=N).astype(np.int32)
    lo = rng.integers(0, P.LO_CARD, size=N).astype(np.int32)
    hit = rng.random(N) < 0.5
    for i in np.nonzero(hit & (depth[hi] > 0))[0]:   # plant matches
        lo[i] = lo_plane[hi[i], rng.integers(0, depth[hi[i]])]
    hi[:50] = H + 7                                   # out of range
    valid = rng.random(N) < 0.9
    args = [torch.from_numpy(x) for x in (hi, lo, valid, pw)]
    want = probe_select_plain(*args, wd, n)
    before = probe_select.launches
    got = probe_select(*(a.to(cuda) for a in args), wd, n)
    torch.cuda.synchronize()
    assert probe_select.launches == before + 1
    assert want[0].sum() > N // 8
    for w, g in zip(want, got):
        assert torch.equal(bits(w), bits(g))


@pytest.mark.parametrize("p", SCAN_PARAMS)
def test_scan_kernel_matches_plain(cuda, p):
    rng = np.random.default_rng(sum(p))
    B, W = 777, 120                  # no tile multiple
    x = [torch.from_numpy(rng.random((B, W)) < 0.3),
         torch.from_numpy(rng.integers(0, 5, size=(B, W)).astype(np.int32)),
         torch.from_numpy(rng.integers(0, 300, size=(B, W)).astype(np.int32)),
         torch.from_numpy(rng.uniform(0.1, 3, size=(B, W)).astype(np.float32))]
    _, _, carry = scan_score_plain(*x, *p, want_emit=False)
    pos0 = torch.from_numpy(rng.integers(0, 500, size=B).astype(np.int32))
    flush = torch.from_numpy(rng.random(B) < 0.5)
    for kw in (dict(), dict(init=carry, pos0=pos0, final_flush=flush)):
        want = scan_score_plain(*x, *p, **kw)
        got = scan_score(*(t.to(cuda) for t in x), *p,
                         **{k: ({f: t.to(cuda) for f, t in v.items()}
                                if isinstance(v, dict) else v.to(cuda))
                            for k, v in kw.items()})
        torch.cuda.synchronize()
        assert want[0].sum() > 0
        assert torch.equal(want[0], got[0].cpu())
        for w, g in zip(want[1], got[1]):
            assert torch.equal(bits(w), bits(g))
        for k in INT_FIELDS + FLOAT_FIELDS:
            assert torch.equal(bits(want[2][k]), bits(got[2][k])), k


def _db(rng, n_funcs=20, prot_len=120):
    prots = rng.integers(0, 20, size=(n_funcs, prot_len))
    keys, fis = [], []
    for f in range(n_funcs):
        for i in range(prot_len - 7):
            keys.append(int(np.polyval(prots[f, i:i + 8], 20)))
            fis.append(f)
    keys, first = np.unique(np.array(keys, np.int64), return_index=True)
    n = len(keys)
    db = SignatureDB(keys, np.array(fis, np.int32)[first],
                     rng.integers(-1, 8, size=n).astype(np.int32),
                     rng.integers(0, 300, size=n).astype(np.int32),
                     rng.uniform(0.1, 4, size=n).astype(np.float32),
                     functions=[f"fn{i}" for i in range(n_funcs)])
    return db, prots.astype(np.uint8)


def test_paths_on_card_match_cpu(cuda):
    """probe_compact and DeviceScorer on the card equal the same calls
    on the CPU, and go through both kernels."""
    rng = np.random.default_rng(1)
    db, prots = _db(rng)
    offsets = np.full((64, 160), 20, np.uint8)
    lengths = rng.integers(30, 150, size=64).astype(np.int32)
    for b in range(64):
        offsets[b, :lengths[b]] = np.resize(prots[b % len(prots)],
                                            lengths[b])
    before = (probe_select.launches, scan_score.launches)
    fa_g, fa_c = FastAnnotator(db, cuda), FastAnnotator(db, "cpu")
    for rows_only in (False, True):
        hg = fa_g.probe_compact(offsets, lengths, rows_only=rows_only)
        hc = fa_c.probe_compact(offsets, lengths, rows_only=rows_only)
        for k in hc:
            assert np.array_equal(hg[k], hc[k]), k
    ds_g, ds_c = DeviceScorer(db, cuda), DeviceScorer(db, "cpu")
    for params in (EngineParams(), EngineParams(min_hits=2,
                                                order_constraint=1)):
        for slim in (0, 2, 3):
            og, _ = ds_g.score_batch_packed(offsets, lengths, params,
                                            calls_per_seq_cap=8, slim=slim)
            oc, _ = ds_c.score_batch_packed(offsets, lengths, params,
                                            calls_per_seq_cap=8, slim=slim)
            og = og.cpu().numpy()
            oc = oc.numpy()
            assert oc[:64].sum() > 0
            assert np.array_equal(og, oc)
    assert probe_select.launches > before[0]
    assert scan_score.launches > before[1]
