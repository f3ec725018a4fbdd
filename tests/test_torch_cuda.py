"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test skips when torch sees no card.  On the machine
with the card (which has no jax) run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports torch and the port only, never jax.
"""

import numpy as np
import pytest
import torch

from close_kmers_tpu_torch.core.api import KmerEngine
from close_kmers_tpu_torch.core.device_family import DeviceFamilyScorer
from close_kmers_tpu_torch.core.device_score import DeviceScorer
from close_kmers_tpu_torch.core.engine import (DeviceDB, FastAnnotator,
                                               encode_windows, probe_windows)
from close_kmers_tpu_torch.core import genome as G
from close_kmers_tpu_torch.core import matrix as M
from close_kmers_tpu_torch import params as P
from close_kmers_tpu_torch.db import family_db
from close_kmers_tpu_torch.db.signature_db import SignatureDB
from close_kmers_tpu_torch.params import EngineParams
from close_kmers_tpu_torch.ops import gather_exp as gx
from close_kmers_tpu_torch.ops.best_call import (CAPC, best_call,
                                                 best_call_plain)
from close_kmers_tpu_torch.ops.family_group import (SMEM_MAX_COLS,
                                                    family_group,
                                                    family_group_plain, route)
from close_kmers_tpu_torch.ops.probe_select import (famwide_select,
                                                    famwide_select_plain,
                                                    probe_select,
                                                    probe_select_plain)
from close_kmers_tpu_torch.ops.row_gather import (row_gather,
                                                  row_gather_plain)
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


def _probe_row_w(wd, aligned, lanes):
    """A payload-wide row width: 1 + 5*wd rounded up to ``lanes`` ints
    (rows 16-B aligned, the 16-B loads), or one past it and no multiple
    of 4 (the 4-B loads)."""
    if aligned:
        return -(-(1 + 5 * wd) // lanes) * lanes
    row_w = 2 + 5 * wd
    return row_w if row_w % 4 else row_w + 1


@pytest.mark.parametrize("wd", [1, 7, 22, 32, 45])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_select_kernel_matches_plain(cuda, wd, aligned):
    """The quarter-warp probe on rows 16-B aligned (row_w a multiple of 4:
    the 16-B loads) and not (the 4-B loads)."""
    rng = np.random.default_rng(wd)
    H, N, n = 5000, 20000, 12345
    row_w = _probe_row_w(wd, aligned, 4)
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


@pytest.mark.parametrize("wd", [1, 22, 31, 32, 33, 45, 256])
@pytest.mark.parametrize("n", [1, 127, 20479])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_select_windows_match_plain(cuda, wd, n, aligned):
    """The quarter-warp probe at wd in one to nine 32-int rounds (start
    and the lo plane are ints 0..wd, so wd = 31 fills one round and 32
    spills into a second), at N of one window and one short of a
    multiple of a block's 64 windows, on rows with and without 16-B
    alignment, with hi negative, hi past the table and invalid windows;
    hits on every slot, the first and the last among them."""
    rng = np.random.default_rng(wd * 1000 + n)
    H = 3000
    row_w = _probe_row_w(wd, aligned, 128)
    pw, lo_plane, depth = _random_table(rng, H, wd, row_w, 1 << 20)
    depth[:2] = wd                                    # two full rows
    for h in range(2):
        lo_plane[h] = rng.choice(P.LO_CARD, size=wd, replace=False)
    pw[:2, 1:1 + wd] = lo_plane[:2]
    hi = rng.integers(0, H, size=n).astype(np.int32)
    hi[rng.random(n) < 0.1] = rng.integers(0, 2)      # the full rows
    lo = rng.integers(0, P.LO_CARD, size=n).astype(np.int32)
    for i in np.nonzero((rng.random(n) < 0.6) & (depth[hi] > 0))[0]:
        lo[i] = lo_plane[hi[i], rng.integers(0, depth[hi[i]])]
    hi[rng.random(n) < 0.05] = H + 7                  # out of range
    hi[rng.random(n) < 0.05] = -3
    valid = rng.random(n) < 0.9
    if n > 2:                        # row 0's first and last slot
        hi[:2], lo[:2], valid[:2] = 0, lo_plane[0, [0, wd - 1]], True
    args = [torch.from_numpy(x) for x in (hi, lo, valid, pw)]
    want = probe_select_plain(*args, wd, 1 << 20)
    got = probe_select(*(a.to(cuda) for a in args), wd, 1 << 20)
    torch.cuda.synchronize()
    if n > 1:
        assert int(want[0].sum()) > n // 8
    if n > 2:
        assert bool(want[0][:2].all())
    for w_, g in zip(want, got):
        assert torch.equal(bits(w_), bits(g))


@pytest.mark.parametrize("wd", [22, 45])
def test_probe_select_invalid_windows_read_nothing(cuda, wd):
    """Every window invalid, or valid with hi far outside the table: each
    takes the miss values and reads no row (a read would fault)."""
    rng = np.random.default_rng(wd)
    H, n, n_db = 100, 4095, 777
    pw, _, _ = _random_table(rng, H, wd, -(-(1 + 5 * wd) // 128) * 128, n_db)
    pw_d = torch.from_numpy(pw).to(cuda)
    lo = torch.zeros(n, dtype=torch.int32, device=cuda)
    for hi, valid in ((torch.zeros(n, dtype=torch.int32), np.zeros(n, bool)),
                      (torch.full((n,), 1 << 30, dtype=torch.int32),
                       np.ones(n, bool))):
        found, fi, oi, avg_off, wt, idx = probe_select(
            hi.to(cuda), lo, torch.from_numpy(valid).to(cuda), pw_d, wd, n_db)
        torch.cuda.synchronize()
        assert not found.any()
        assert (fi == -1).all() and (oi == -1).all() and (avg_off == 0).all()
        assert (wt.view(torch.int32) == 0).all() and (idx == n_db).all()


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


def _scan_inputs(rng, B, W):
    return [torch.from_numpy(rng.random((B, W)) < 0.3),
            torch.from_numpy(rng.integers(0, 5, size=(B, W)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 300, size=(B, W))
                             .astype(np.int32)),
            torch.from_numpy(rng.uniform(0.1, 3, size=(B, W))
                             .astype(np.float32))]


def _assert_scan_equal(want, got):
    assert (want[0] is None) == (got[0] is None)
    if want[0] is not None:
        assert torch.equal(want[0], got[0].cpu())
        for w, g in zip(want[1], got[1]):
            assert torch.equal(bits(w), bits(g))
    for k in INT_FIELDS + FLOAT_FIELDS:
        assert torch.equal(bits(want[2][k]), bits(got[2][k])), k


@pytest.mark.parametrize("W", [1, 63, 64, 65, 304])
@pytest.mark.parametrize("B", [1, 33, 4096, 4097])
def test_scan_kernel_shapes_match_plain(cuda, B, W):
    """Every B and W, tile edges included, in the [B, W] / [B, W+1]
    layouts: fresh state, a chained tile (init, pos0, final_flush) and
    the state alone (want_emit=False)."""
    rng = np.random.default_rng(B * 1000 + W)
    x = _scan_inputs(rng, B, W)
    p = SCAN_PARAMS[(B + W) % len(SCAN_PARAMS)]
    _, _, carry = scan_score_plain(*x, *p, want_emit=False)
    pos0 = torch.from_numpy(rng.integers(0, 500, size=B).astype(np.int32))
    flush = torch.from_numpy(rng.random(B) < 0.5)
    on_card = {k: v.to(cuda) for k, v in carry.items()}
    before = scan_score.launches
    for kw, kw_card in (
            (dict(), dict()),
            (dict(init=carry, pos0=pos0, final_flush=flush),
             dict(init=on_card, pos0=pos0.to(cuda),
                  final_flush=flush.to(cuda))),
            (dict(init=carry, pos0=pos0, want_emit=False),
             dict(init=on_card, pos0=pos0.to(cuda), want_emit=False))):
        want = scan_score_plain(*x, *p, **kw)
        got = scan_score(*(t.to(cuda) for t in x), *p, **kw_card)
        torch.cuda.synchronize()
        _assert_scan_equal(want, got)
        if want[0] is not None:
            assert got[0].shape == (B, W + 1)
            assert all(f.shape == (B, W + 1) for f in got[1])
    assert scan_score.launches == before + 3


@pytest.mark.parametrize("B", [1, 9984])
def test_scan_kernel_genome_shape_matches_plain(cuda, B):
    """The genome program's scan: W = STEP = 1,016 windows a tile row, B
    up to 9,984 rows (a 5-Mbp genome), chained from an init built as the
    fixpoint builds it (rows of one [13, B] int32 buffer gathered by row,
    the f32 fields as views), with emit and final_flush, and the state
    alone."""
    rng = np.random.default_rng(B + 1016)
    W = G.STEP
    x = _scan_inputs(rng, B, W)
    for p in (SCAN_PARAMS[0], SCAN_PARAMS[3]):
        _, _, carry = scan_score_plain(*x, *p, want_emit=False)
        perm = torch.from_numpy(rng.permutation(B))
        packed = G._packed_state(carry)[:, perm]
        pos0 = torch.from_numpy((rng.integers(0, 9, size=B) * W)
                                .astype(np.int32))
        flush = torch.from_numpy(rng.random(B) < 0.2)
        for emit in (True, False):
            kw = dict(pos0=pos0, want_emit=emit,
                      final_flush=flush if emit else None)
            want = scan_score_plain(*x, *p, init=G._state_of(packed), **kw)
            got = scan_score(*(t.to(cuda) for t in x), *p,
                             init=G._state_of(packed.to(cuda)),
                             **{k: v.to(cuda) if torch.is_tensor(v) else v
                                for k, v in kw.items()})
            torch.cuda.synchronize()
            _assert_scan_equal(want, got)
            if emit and B > 1:
                assert want[0].sum() > 0


def test_scan_kernel_takes_misaligned_and_strided_inputs(cuda):
    """found starting off a 4-byte boundary (a view at storage offset 1)
    and column slices of wider planes give the plain version's result."""
    rng = np.random.default_rng(8)
    B, W = 37, 71
    x = _scan_inputs(rng, B, W + 3)
    want = scan_score_plain(*(t[:, 2:2 + W] for t in x), *SCAN_PARAMS[0])
    buf = torch.zeros(B * W + 1, dtype=torch.bool, device=cuda)
    buf[1:] = x[0][:, 2:2 + W].reshape(-1).to(cuda)
    found = buf[1:].view(B, W)
    assert found.data_ptr() % 4 == 1
    rest = [t.to(cuda)[:, 2:2 + W] for t in x[1:]]
    got = scan_score(found, *rest, *SCAN_PARAMS[0])
    torch.cuda.synchronize()
    assert want[0].sum() > 0
    _assert_scan_equal(want, got)


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


@pytest.mark.parametrize("n,w", [(1, 1), (4099, 3), (20000, 33),
                                 (5000, 300), (1_250_000, 3)])
def test_row_gather_kernel_matches_plain(cuda, n, w):
    rng = np.random.default_rng(n)
    table = torch.from_numpy(
        rng.integers(-1, 1 << 30, size=(3001, w)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 3001, size=n).astype(np.int32))
    before = row_gather.launches
    got, check = row_gather(table.to(cuda), idx.to(cuda))
    torch.cuda.synchronize()
    check.raise_if_bad()
    assert row_gather.launches == before + 1
    assert torch.equal(row_gather_plain(table, idx), got.cpu())


@pytest.mark.parametrize("bad_id", [3001, -1, 1 << 30])
def test_row_gather_bad_id_raises_at_the_check(cuda, bad_id):
    """A bad id writes a zero row and raises IndexError at the check,
    after the result's copy; the context stays usable afterwards."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(
        rng.integers(1, 1 << 30, size=(3001, 3)).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 3001, size=5000)
                           .astype(np.int32)).to(cuda)
    idx[1234] = bad_id
    out, check = row_gather(table, idx)
    host = out.cpu()                        # the caller's own copy
    with pytest.raises(IndexError):
        check.raise_if_bad()
    assert not host[1234].any() and host[1233].all()
    good = idx.clone()
    good[1234] = 7
    out, check = row_gather(table, good)
    torch.cuda.synchronize()
    check.raise_if_bad()
    assert torch.equal(out.cpu(), row_gather_plain(table.cpu(), good.cpu()))
    assert int((table + 1).sum().item()) != 0    # the context still works


@pytest.mark.parametrize("wd,d", [(1, 1), (22, 3), (40, 2)])
def test_famwide_select_kernel_matches_plain(cuda, wd, d):
    rng = np.random.default_rng(wd * 10 + d)
    H, N, lo_bits = 5000, 20000, 13
    row_w = (2 + d) * wd + 5
    tab = rng.integers(-1, 1 << 20, size=(H, row_w)).astype(np.int32)
    lo_plane = np.full((H, wd), (1 << 30) | 0x1FFF, np.int32)
    depth = rng.integers(0, wd + 1, size=H)
    for h in range(H):
        lo_plane[h, :depth[h]] = rng.choice(8000, size=depth[h],
                                            replace=False)
    fi = rng.integers(0, 1 << 18, size=(H, wd)).astype(np.int32)
    tab[:, :wd] = np.where(lo_plane < 8000, (fi << lo_bits) | lo_plane,
                           lo_plane)
    hi = rng.integers(0, H, size=N).astype(np.int32)
    lo = rng.integers(0, 8000, size=N).astype(np.int32)
    for i in np.nonzero((rng.random(N) < 0.5) & (depth[hi] > 0))[0]:
        lo[i] = lo_plane[hi[i], rng.integers(0, depth[hi[i]])]
    hi[:50] = H + 3                                   # out of range
    valid = rng.random(N) < 0.9
    args = [torch.from_numpy(x) for x in (hi, lo, valid, tab)]
    want = famwide_select_plain(*args, wd, d, lo_bits)
    before = famwide_select.launches
    got = famwide_select(*(a.to(cuda) for a in args), wd, d, lo_bits)
    torch.cuda.synchronize()
    assert famwide_select.launches == before + 1
    assert want[0].sum() > N // 8
    for w_, g in zip(want, got):
        assert torch.equal(bits(w_), bits(g))


@pytest.mark.parametrize("cap", [0, 3, 40, 901])
def test_family_group_kernel_matches_plain(cuda, cap):
    rng = np.random.default_rng(cap)
    B, W, D = 777, 300, 3
    fams = rng.integers(0, 60, size=(B, W, D)).astype(np.int32)
    fams[rng.random((B, W, D)) < 0.5] = -1
    fams = torch.from_numpy(fams)
    want = family_group_plain(fams, cap)
    before = family_group.launches
    got = family_group(fams.to(cuda), cap)
    torch.cuda.synchronize()
    assert family_group.launches == before + 1
    assert int(want[0].sum()) > B
    for w_, g in zip(want, got):
        assert torch.equal(bits(w_), bits(g))


def _edge_fams(case, rng):
    """[B, W, D] family rows for the fused kernel's edge cases; B = 13 is
    no multiple of the eight rows a block takes."""
    if case.startswith("d"):                          # d1, d3, d4, d8
        D = int(case[1:])
        fams = rng.integers(0, 300, size=(13, 200, D))
        fams[rng.random(fams.shape) < 0.4] = -1
    elif case == "all_pad":
        fams = np.full((13, 300, 3), -1)
    elif case == "one_family":
        fams = rng.integers(0, 300, size=(13, 304, 3))
        fams[rng.random(fams.shape) < 0.4] = -1
        fams[0] = 77                                  # every slot, M adds
        fams[1, :, 1] = 77                            # every window
    elif case == "ids_near_2^30":
        fams = rng.integers((1 << 30) - 40, 1 << 30, size=(13, 304, 3))
        fams[rng.random(fams.shape) < 0.3] = -1
    else:                                   # a row width: one per team
        W, D = {"m130": (43, 3), "m300": (100, 3), "m912": (304, 3),
                "m1500": (500, 3), "m3000": (1000, 3), "at_limit": (2048, 4),
                "past_limit": (2731, 3)}[case]
        fams = rng.integers(0, 500, size=(13, W, D))
        fams[rng.random(fams.shape) < 0.3] = -1
    return torch.from_numpy(fams.astype(np.int32))


@pytest.mark.parametrize("case", [
    "all_pad", "one_family", "d1", "d3", "d4", "d8", "ids_near_2^30",
    "m130", "m300", "m912", "m1500", "m3000", "at_limit", "past_limit"])
def test_family_group_edge_cases_match_plain(cuda, case):
    """Both routes of family_group bit for bit against the plain version
    at caps 0, 3 and W*D+1, on the fused kernel's edge cases and at a row
    width of each of its teams; the route is picked by W*D alone."""
    fams = _edge_fams(case, np.random.default_rng(len(case)))
    B, W, D = fams.shape
    assert route(W * D) == ("sorted" if case == "past_limit" else "fused")
    fams_d = fams.to(cuda)
    for cap in (0, 3, W * D + 1):
        want = family_group_plain(fams_d, cap)
        got = family_group(fams_d, cap)
        torch.cuda.synchronize()
        for w_, g in zip(want, got):
            assert torch.equal(bits(w_), bits(g))
    n = want[0].cpu()
    assert (n == 0).all() if case == "all_pad" else int(n.sum()) > B
    if case == "one_family":
        assert int(n[0]) == 1 and int(want[2][0, 0]) == W * D


def test_family_group_limit_matches_the_kernel(cuda):
    """The wrapper's route limit is the kernel's, and the kernel refuses
    a row past it."""
    from close_kmers_tpu_torch.ops import _build
    from close_kmers_tpu_torch.ops import family_group as FG
    assert _build.kernel("ck_family_group_max_cols", [])() == SMEM_MAX_COLS
    fams = torch.full((2, SMEM_MAX_COLS + 1, 1), 5, dtype=torch.int32,
                      device=cuda)
    with pytest.raises(RuntimeError, match="ck_family_group"):
        FG._launch(fams, FG._weights(1, fams.device), 3,
                   FG._outputs(2, 3, cuda))


def _famwide_table(rng, H, wd, d, row_w, lo_bits=13):
    tab = rng.integers(-1, 1 << 20, size=(H, row_w)).astype(np.int32)
    lo_plane = np.full((H, wd), (1 << 30) | ((1 << lo_bits) - 1), np.int32)
    depth = rng.integers(0, wd + 1, size=H)
    for h in range(H):
        lo_plane[h, :depth[h]] = rng.choice(8000, size=depth[h],
                                            replace=False)
    fi = rng.integers(0, 1 << 18, size=(H, wd)).astype(np.int32)
    tab[:, :wd] = np.where(lo_plane < 8000, (fi << lo_bits) | lo_plane,
                           lo_plane)
    return tab, lo_plane, depth


@pytest.mark.parametrize("wd", [1, 22, 32, 33, 64])
@pytest.mark.parametrize("n", [1, 127, 20479])
@pytest.mark.parametrize("aligned", [True, False])
def test_famwide_select_windows_match_plain(cuda, wd, n, aligned):
    """The quarter-warp kernel at wd in one and two 32-slot chunks, at N
    of one window and one short of a multiple of a block's 128 windows,
    on rows with and without 16-B alignment (the 16-B and the 4-B loads),
    with out-of-range hi and invalid windows."""
    rng = np.random.default_rng(wd * 1000 + n)
    H, d, lo_bits = 3000, 3, 13
    row_w = -(-(2 + d) * wd // 128) * 128 if aligned else (2 + d) * wd + 5
    tab, lo_plane, depth = _famwide_table(rng, H, wd, d, row_w, lo_bits)
    hi = rng.integers(0, H, size=n).astype(np.int32)
    lo = rng.integers(0, 8000, size=n).astype(np.int32)
    for i in np.nonzero((rng.random(n) < 0.6) & (depth[hi] > 0))[0]:
        lo[i] = lo_plane[hi[i], rng.integers(0, depth[hi[i]])]
    hi[rng.random(n) < 0.05] = H + 7                  # out of range
    hi[rng.random(n) < 0.05] = -3
    valid = rng.random(n) < 0.9
    args = [torch.from_numpy(x) for x in (hi, lo, valid, tab)]
    want = famwide_select_plain(*args, wd, d, lo_bits)
    got = famwide_select(*(a.to(cuda) for a in args), wd, d, lo_bits)
    torch.cuda.synchronize()
    if n > 1:
        assert int(want[0].sum()) > n // 8
    for w_, g in zip(want, got):
        assert torch.equal(bits(w_), bits(g))


@pytest.mark.parametrize("d", [1, 8])
def test_famwide_select_invalid_windows_read_nothing(cuda, d):
    """Every window invalid, or valid with hi far outside the table: each
    takes the miss values and reads no row (a read would fault)."""
    rng = np.random.default_rng(d)
    H, wd, n = 100, 22, 4095
    tab, _, _ = _famwide_table(rng, H, wd, d, 128 * (1 + (2 + d) * wd // 128))
    tab_d = torch.from_numpy(tab).to(cuda)
    lo = torch.zeros(n, dtype=torch.int32, device=cuda)
    for hi, valid in ((torch.zeros(n, dtype=torch.int32), np.zeros(n, bool)),
                      (torch.full((n,), 1 << 30, dtype=torch.int32),
                       np.ones(n, bool))):
        found, fi, wt, fams = famwide_select(
            hi.to(cuda), lo, torch.from_numpy(valid).to(cuda), tab_d, wd, d,
            13)
        torch.cuda.synchronize()
        assert not found.any()
        assert (fi == -1).all() and (fams == -1).all()
        assert (wt.view(torch.int32) == 0).all()


def test_family_path_on_card_matches_cpu(cuda):
    """DeviceFamilyScorer (famwide and two-gather) and the engine's
    best-match path on the card equal the same calls on the CPU, and go
    through the three family kernels."""
    rng = np.random.default_rng(2)
    db, prots = _db(rng)
    mapping = family_db.KmerFamilyMapping()
    for k in db.keys:
        for f in set(rng.integers(0, 30, size=rng.integers(1, 4)).tolist()):
            mapping.add_fam_mapping(int(f), int(k))
    mapping.families = [family_db.FamilyData(
        f"PGF_{f % 7:08d}", f"PLF_1_{f:08d}", 1, f"fn{f % 20}", f, 10, 3)
        for f in range(30)]
    offsets = np.full((64, 160), 20, np.uint8)
    lengths = rng.integers(30, 150, size=64).astype(np.int32)
    for b in range(64):
        offsets[b, :lengths[b]] = np.resize(prots[b % len(prots)],
                                            lengths[b])
    before = (row_gather.launches, famwide_select.launches,
              family_group.launches)
    for fw in (True, False):
        g = DeviceFamilyScorer(db, mapping, cuda, famwide=fw)
        c = DeviceFamilyScorer(db, mapping, "cpu", famwide=fw)
        for cap, row_cap in ((64, 0), (-4096, 0), (-4096, 16)):
            og = g.score_family_packed(offsets, lengths, EngineParams(), 4,
                                       cap, slim_calls=True, row_cap=row_cap)
            oc = c.score_family_packed(offsets, lengths, EngineParams(), 4,
                                       cap, slim_calls=True, row_cap=row_cap)
            assert int(oc[0][:64].sum()) > 0
            assert torch.equal(og[0].cpu(), oc[0])
            assert torch.equal(og[2].cpu(), oc[2])
    eg = KmerEngine(db, cuda, device_family_min=0)
    ec = KmerEngine(db, "cpu", device_family_min=0)
    alpha = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    items = [(f"s{b}", "".join(alpha[offsets[b, :lengths[b]]]))
             for b in range(64)]
    want = ec.best_family_matches(items, mapping, genus_filter=False)
    assert sum(1 for m in want if m.gfam_id) > 10
    assert eg.best_family_matches(items, mapping, genus_filter=False) == want
    after = (row_gather.launches, famwide_select.launches,
             family_group.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.parametrize("n,w,depth", [(2_490_000, 128, 16), (4099, 7, 1),
                                       (20000, 33, 32), (1, 128, 4)])
def test_dma_gather_kernel_matches_plain(cuda, n, w, depth):
    rng = np.random.default_rng(n + w)
    table = torch.from_numpy(
        rng.integers(-(1 << 30), 1 << 30, size=(3001, w)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 3001, size=n).astype(np.int32))
    before = gx.dma_gather.launches
    got = gx.dma_gather(table.to(cuda), idx.to(cuda), depth)
    torch.cuda.synchronize()
    assert gx.dma_gather.launches == before + 1
    assert torch.equal(gx.dma_gather_plain(table, idx), got.cpu())
    with pytest.raises(IndexError):
        gx.dma_gather(table.to(cuda), torch.full((5,), 3001, dtype=torch.int32,
                                                 device=cuda))


@pytest.mark.parametrize("rows,w,chunk,n_chunks,big", [
    (gx.VGATHER_TILE_ROWS, 128, 2048, 300, True),  # the experiment's tile
    (100, 37, 96, 300, False),     # 4-B reads; 3 of the 32 warps take ids
    (gx.VGATHER_TILE_ROWS, 128, 100, 500, True),   # no whole 32-id groups
    (gx.VGATHER_TILE_ROWS, 128, 2048, 1, True),    # one chunk in all
    (gx.VGATHER_TILE_ROWS, 128, 2048, 131, True),  # fewer chunks than SMs
    (gx.VGATHER_TILE_ROWS, 128, 2048, 4001, True),  # past one round a block
    (200, 256, 3000, 40, True),    # two 16-B reads a lane per row
    (64, 4, 33, 777, True)])       # a 16-B row, one lane reads it
def test_vgather_kernel_matches_plain(cuda, rows, w, chunk, n_chunks, big):
    rng = np.random.default_rng(rows * 7 + chunk + n_chunks)
    hi = (1 << 28) if big else 100
    tile = torch.from_numpy(rng.integers(-hi if chunk == 33 else 0, hi,
                                         size=(rows, w)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, rows, size=chunk * n_chunks)
                           .astype(np.int32))
    before = gx.vgather.launches
    got = gx.vgather(tile.to(cuda), idx.to(cuda), chunk)
    torch.cuda.synchronize()
    assert gx.vgather.launches == before + 1
    assert torch.equal(gx.vgather_plain(tile, idx, chunk).view(torch.int32),
                       got.cpu().view(torch.int32))


def test_vgather_extreme_values_match_plain(cuda):
    """Rows of INT32_MIN and INT32_MAX: the biased adds wrap and carry at
    every element, and the sum is still the exact one."""
    tile = torch.tensor([[-(1 << 31)] * 128, [(1 << 31) - 1] * 128,
                         [-1] * 128, [0] * 128], dtype=torch.int32)
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 4, size=2048 * 200)
                           .astype(np.int32))
    idx[:2048] = 0
    idx[2048:4096] = 1
    got = gx.vgather(tile.to(cuda), idx.to(cuda), 2048)
    torch.cuda.synchronize()
    want = gx.vgather_plain(tile, idx, 2048)
    assert float(want[0]) == -(2.0 ** 31) * 128 * 2048
    assert torch.equal(want.view(torch.int32), got.cpu().view(torch.int32))


def test_vgather_refuses_a_tile_past_shared_memory(cuda):
    tile = torch.zeros((gx.VGATHER_TILE_ROWS + 64, 128), dtype=torch.int32,
                       device=cuda)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        gx.vgather(tile, idx, 64)


@pytest.mark.parametrize("n_rows,w,blk", [(3_198_976, 128, 2048),
                                          (1001, 3, 77)])
def test_hbmstream_kernel_matches_plain(cuda, n_rows, w, blk):
    gen = torch.Generator(device=cuda).manual_seed(n_rows)
    table = torch.randint(-(1 << 30), 1 << 30, (n_rows, w), generator=gen,
                          device=cuda, dtype=torch.int32)
    before = gx.hbmstream.launches
    got = gx.hbmstream(table, blk)
    torch.cuda.synchronize()
    assert gx.hbmstream.launches == before + 1
    want = gx.hbmstream_plain(table, blk)
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("n_dmas,per_prog,rpd,w", [(32768, 256, 8, 128),
                                                   (600, 6, 3, 5)])
def test_dmaflush_kernel_matches_plain(cuda, n_dmas, per_prog, rpd, w):
    rng = np.random.default_rng(n_dmas)
    dst = torch.from_numpy(rng.permutation(n_dmas).astype(np.int32)
                           .reshape(-1, per_prog))
    buf = torch.from_numpy(rng.integers(0, 1 << 30, size=(per_prog * rpd, w))
                           .astype(np.int32))
    before = gx.dmaflush.launches
    got = gx.dmaflush(dst.to(cuda), buf.to(cuda), rpd)
    torch.cuda.synchronize()
    assert gx.dmaflush.launches == before + 1
    assert torch.equal(gx.dmaflush_plain(dst, buf, rpd), got.cpu())


TIER_FLAGS = [dict(wide=False, sub=False, wide_lo=False, fused=False),
              dict(wide=False, sub=False, fused=False),
              dict(wide=False, sub=False),
              dict(wide=False, sub=True, fused=False),
              dict(wide=True, wide_payload=False, fused=False),
              dict(wide=True, wide_payload=True)]


def test_tiers_on_card_match_cpu(cuda):
    """Each probe tier on the card equals the same tier on the CPU and the
    payload-wide probe; the sub tier goes through probe_select."""
    rng = np.random.default_rng(3)
    db, prots = _db(rng)
    offsets = np.full((64, 160), 20, np.uint8)
    lengths = rng.integers(30, 150, size=64).astype(np.int32)
    for b in range(64):
        offsets[b, :lengths[b]] = np.resize(prots[b % len(prots)],
                                            lengths[b])
    o, ln = torch.from_numpy(offsets), torch.from_numpy(lengths)
    base = probe_windows(DeviceDB.from_db(db, "cpu"), *encode_windows(o, ln))
    assert int(base[0].sum()) > 1000
    for kw in TIER_FLAGS:
        dg = DeviceDB.from_db(db, cuda, **kw)
        before = probe_select.launches
        got = probe_windows(dg, *encode_windows(o.to(cuda), ln.to(cuda)))
        torch.cuda.synchronize()
        assert (probe_select.launches > before) == (
            dg.tier in ("payload_wide", "sub_blocks")), dg.tier
        for w_, g in zip(base, got):
            assert torch.equal(bits(w_), bits(g)), dg.tier


# scripts/dna_bench.py CODON: one codon per amino acid, index = aa offset
CODON = ["GCG", "TGC", "GAT", "GAA", "TTT", "GGT", "CAT", "ATT", "AAA",
         "CTG", "ATG", "AAC", "CCG", "CAG", "CGT", "AGC", "ACC", "GTT",
         "TGG", "TAT"]


def test_genome_on_card_matches_cpu(cuda):
    """GenomeAnnotator on the card gives the CPU port's packed buffer and
    round count (a genome of ~4 tiles a frame: reverse-translated DB
    proteins between random DNA), through both kernels."""
    rng = np.random.default_rng(3)
    db, prots = _db(rng)
    parts = []
    while sum(map(len, parts)) < 4 * 3 * G.STEP:
        parts.append("".join(CODON[o] for o in prots[rng.integers(0, 20)]))
        parts.append("".join(rng.choice(list("ACGT"),
                                        size=int(rng.integers(0, 900)))))
    dna = "".join(parts)
    ga_g, ga_c = G.GenomeAnnotator(db, cuda), G.GenomeAnnotator(db, "cpu")
    before = (probe_select.launches, scan_score.launches)
    for params in (EngineParams(), EngineParams(min_hits=2, max_gap=50,
                                                order_constraint=1)):
        out_g, it_g, T = ga_g.dispatch(dna, params)
        out_c, it_c, _ = ga_c.dispatch(dna, params)
        assert np.array_equal(out_g.cpu().numpy(), out_c.numpy())
        assert it_g == it_c and out_c[:6 * T].sum() > 5
    assert probe_select.launches > before[0]
    assert scan_score.launches >= before[1] + 2 * (it_c + 1)


def test_matrix_on_card_matches_cpu(cuda):
    """DeviceMatrix on the card gives the CPU port's pairs, chunked with a
    padded tail and through the x4 cap retry, and one chunk's packed
    buffer word for word, through probe_select."""
    rng = np.random.default_rng(4)
    db, prots = _db(rng)
    n, P = len(db), 300
    deg = rng.integers(1, 4, size=n)
    peg_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=peg_offs[1:])
    peg_vals = rng.integers(0, 2 * P, size=int(peg_offs[-1]))
    rank = np.full(2 * P, 1 << 20, dtype=np.int64)
    rank[:P] = np.arange(P)
    offsets = np.full((P, 128), 20, np.uint8)
    lengths = rng.integers(20, 120, size=P).astype(np.int32)
    for b in range(P):
        offsets[b, :lengths[b]] = prots[rng.integers(0, 20), :lengths[b]]
    dm_g = M.DeviceMatrix(db, max_deg=3, device=cuda)
    dm_c = M.DeviceMatrix(db, max_deg=3, device="cpu")
    dm_g.CHUNK = dm_c.CHUNK = 128
    before = probe_select.launches
    csr_g = dm_g.stage_csr(peg_offs, peg_vals)
    csr_c = dm_c.stage_csr(peg_offs, peg_vals)
    for cap in (4, 32768):
        got = dm_g.count_pairs(offsets, lengths, *csr_g, rank, pair_cap=cap)
        want = dm_c.count_pairs(offsets, lengths, *csr_c, rank, pair_cap=cap)
        assert got == want and len(want) > 100
    assert probe_select.launches > before
    args = []
    for dm in (dm_g, dm_c):
        dev = dm.device
        args.append((torch.from_numpy(offsets[:128]).to(dev),
                     torch.from_numpy(lengths[:128]).to(dev), 0,
                     *dm.stage_csr(peg_offs, peg_vals),
                     torch.from_numpy(rank.astype(np.int32)).to(dev), 3,
                     4096))
    bg = M._matrix_pairs(dm_g.ddb, *args[0])
    bc = M._matrix_pairs(dm_c.ddb, *args[1])
    assert torch.equal(bg.cpu(), bc)


BC_WEIGHTS = np.array([0.1, 0.3, 0.5, 1.0, 1.5, 2.0, -0.0, 0.0], np.float32)


def _calls(rng, B, M, p_emit, n_funcs):
    """Scan outputs for best_call: emit at rate ``p_emit``, counts 1-13
    (bridges merge and not), few functions and a small weight set with
    both signed zeros (totals tie)."""
    return (rng.random((B, M)) < p_emit,
            rng.integers(1, 14, size=(B, M)).astype(np.int32),
            rng.integers(0, n_funcs, size=(B, M)).astype(np.int32),
            rng.choice(BC_WEIGHTS, size=(B, M)))


BC_WIDTHS = [1, 2, 15, 16, 17, 32, 33, 313, 511, 512, 513, 1017]


@pytest.mark.parametrize("B", [1, 33, 4097])
@pytest.mark.parametrize("M", BC_WIDTHS)
@pytest.mark.parametrize("p_emit", [0.1, 0.95])
def test_best_call_kernel_matches_plain(cuda, B, M, p_emit):
    """The warp-per-row kernel at B of one row, one past a block's eight
    rows and past 4096, and M of one byte, on both sides of a 16-B word,
    below, at and past the 32-call cap (rows of more than 32 calls at the
    high emit rate) and on both sides of a warp's 512-B round."""
    rng = np.random.default_rng(B * 1000 + M + int(p_emit * 10))
    x = [torch.from_numpy(a) for a in _calls(rng, B, M, p_emit, 2 + M % 4)]
    want = best_call_plain(*x)
    before = best_call.launches
    got = best_call(*(a.to(cuda) for a in x))
    torch.cuda.synchronize()
    assert best_call.launches == before + 1
    assert torch.equal(got.cpu(), want)
    if M > 2 * CAPC and p_emit > 0.9:
        assert bool(want[:, 8].any())


@pytest.mark.parametrize("M", [15, 16, 17, 313, 511, 512, 513, 1017])
def test_best_call_kernel_constructed_rows(cuda, M):
    """Rows of exactly 0, 1, 31, 32, 33 and 40 calls (those that fit in
    M), full ties, bridges that merge and not, signed zeros, on the scan's
    layout: the call planes as strided views of one [5, B, W+1]
    allocation.  Calls every 7 columns from column 3, or every column
    where 7 apart do not fit."""
    rows = [[], [(6, 1, 1.0)], [(6, 1, 1.0), (6, 2, 1.0)],
            [(7, 6, 2.0), (7, 7, 2.0), (7, 8, 2.0)],
            [(6, 1, 1.0), (4, 2, 1.0), (6, 1, 1.0)],
            [(6, 3, 1.0), (5, 4, 1.0), (6, 3, 1.0)],
            [(5, 2, -0.0), (5, 3, 0.0)]]
    rows += [[(1 + k % 5, k % 3, float(BC_WEIGHTS[k % 6])) for k in range(n)]
             for n in (31, 32, 33, 40) if n <= M]
    B = len(rows)
    emit = torch.zeros((B, M), dtype=torch.bool)
    planes = torch.zeros((5, B, M), dtype=torch.int32)
    wt = planes[4].view(torch.float32)
    for r, calls in enumerate(rows):
        cols = range(3, M, 7) if 3 + 7 * len(calls) <= M else range(M)
        for c, (n, f, w) in zip(cols, calls):
            emit[r, c] = True
            planes[2, r, c], planes[3, r, c], wt[r, c] = n, f, w
    want = best_call_plain(emit, planes[2], planes[3], wt)
    assert want[:, 8].tolist() == [int(len(r) > CAPC) for r in rows]
    pg = planes.to(cuda)
    got = best_call(emit.to(cuda), pg[2], pg[3], pg[4].view(torch.float32))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("M", BC_WIDTHS)
@pytest.mark.parametrize("col0,pad", [(0, 0), (0, 3), (1, 0), (7, 9),
                                      (15, 1), (16, 16)])
def test_best_call_kernel_views_and_edges(cuda, M, col0, pad):
    """emit and the call planes as column slices starting ``col0`` bytes
    into rows of col0 + M + pad, so row starts fall on and off 16-B
    alignment (row strides of multiples of 16 and not), with rows whose
    calls sit in the first byte, the last byte or both, rows of one call,
    and rows whose 33rd call lies past column 480."""
    rng = np.random.default_rng(M * 100 + col0 * 10 + pad)
    B, W = 70, col0 + M + pad
    emit, cnt, fi, wt = _calls(rng, B, W, 0.3 if M > 1 else 0.5, 3)
    emit[:8] = False
    emit[0, col0] = emit[1, col0 + M - 1] = True
    emit[2, col0] = emit[2, col0 + M - 1] = True
    emit[3, col0 + M // 2] = True
    if M > 481:
        emit[4, col0 + rng.choice(400, size=32, replace=False)] = True
        emit[4, col0 + 481 + rng.integers(0, M - 481)] = True
        emit[5, col0 + rng.choice(480, size=32, replace=False)] = True
        emit[5, col0 + M - 1] = True
    x = [torch.from_numpy(a) for a in (emit, cnt, fi, wt)]
    planes = torch.stack([x[1], x[2], x[3].view(torch.int32)])
    sl = slice(col0, col0 + M)
    cpu = [x[0][:, sl], planes[0][:, sl], planes[1][:, sl],
           planes[2].view(torch.float32)[:, sl]]
    want = best_call_plain(*cpu)
    e_g, p_g = x[0].to(cuda), planes.to(cuda)
    got = best_call(e_g[:, sl], p_g[0][:, sl], p_g[1][:, sl],
                    p_g[2].view(torch.float32)[:, sl])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if M > 481:
        assert want[4:6, 8].tolist() == [1, 1]


def test_best_calls_batch_on_card_matches_cpu(cuda):
    """DeviceScorer's fused best-call path on the card equals the CPU
    port's: the [B, 9] pack (a 40-call overflow row included) and every
    BestCall of best_calls_batch, through probe_select, scan_score and
    best_call."""
    rng = np.random.default_rng(6)
    db, prots = _db(rng)
    offsets = np.full((65, 512), 20, np.uint8)
    lengths = rng.integers(30, 500, size=65).astype(np.int32)
    for b in range(64):
        offsets[b, :lengths[b]] = np.resize(prots[b % len(prots)],
                                            lengths[b])
    # one row of 40 calls at min_hits=1: 40 fragments of 10 residues (3
    # hit windows), each of the next function, an invalid residue apart
    frag = np.concatenate([np.append(prots[f % 20, :10], 20)
                           for f in range(40)])
    offsets[64, :len(frag)], lengths[64] = frag, len(frag)
    g, c = DeviceScorer(db, cuda), DeviceScorer(db, "cpu")
    before = best_call.launches
    for params in (EngineParams(), EngineParams(min_hits=1)):
        og = g.best_batch_packed(offsets, lengths, params)
        oc = c.best_batch_packed(offsets, lengths, params)
        assert torch.equal(og.cpu(), oc) and int(oc[:, 0].sum()) > 20
        got = g.best_calls_batch(offsets, lengths, db.function_of, params)
        want = c.best_calls_batch(offsets, lengths, db.function_of, params)
        assert [vars(x) for x in got] == [vars(x) for x in want]
    assert int(oc[64, 8]) == 1                 # the overflow row
    assert best_call.launches >= before + 2


def _plain_results(results):
    """process_batch's (calls, hits, otu) as comparable values (the
    weights by their f32 bits)."""
    def bits(w):
        return int(np.float32(w).view(np.int32))
    return [([(x.start, x.end, x.count, x.fI, bits(x.weighted))
              for x in calls],
             [dict(vars(h), wt=bits(h.wt)) for h in hits],
             vars(otu)) for calls, hits, otu in results]


def test_tpu_engine_on_card_matches_cpu(cuda):
    """TpuEngine.process_batch and annotate_best_match on the card equal
    the same calls on a CPU engine."""
    from close_kmers_tpu_torch.core import family as F
    from close_kmers_tpu_torch.core.engine import TpuEngine
    rng = np.random.default_rng(7)
    db, prots = _db(rng)
    alpha = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    items = [(f"s{b}", "".join(alpha[np.resize(prots[b % 20],
                                               int(rng.integers(9, 300)))]))
             for b in range(48)] + [("e", ""), ("x", "XXXXXXXXXXXXX")]
    mapping = family_db.KmerFamilyMapping()
    for k in db.keys:
        for f in set(rng.integers(0, 30, size=rng.integers(1, 4)).tolist()):
            mapping.add_fam_mapping(int(f), int(k))
    mapping.families = [family_db.FamilyData(
        f"PGF_{f % 7:08d}", f"PLF_1_{f:08d}", 1, f"fn{f % 20}", f, 10, 3)
        for f in range(30)]
    g, c = TpuEngine(db, cuda), TpuEngine(db, "cpu")
    before = probe_select.launches
    for params in (EngineParams(), EngineParams(min_hits=2, max_gap=40)):
        want, got = (_plain_results(e.process_batch(items, params,
                                                    want_hits=True))
                     for e in (c, g))
        assert got == want
        assert sum(len(calls) for calls, _, _ in want) > 20
    want = F.annotate_best_match(c, items, mapping, db.function_of,
                                 genus_filter=False)
    got = F.annotate_best_match(g, items, mapping, db.function_of,
                                genus_filter=False)
    assert got == want and sum(1 for _, m in want if m.gfam_id) > 10
    assert probe_select.launches > before


def _deep_db(rng, n=8_000):
    """~60 hi buckets over 8k keys: sub-bucket blocks in every shard."""
    his = rng.integers(1_000_000, 1_000_060, size=n, dtype=np.int64)
    keys = np.unique(his * P.LO_CARD
                     + rng.integers(0, P.LO_CARD, size=n, dtype=np.int64))
    return SignatureDB(keys, rng.integers(0, 50, size=len(keys)).astype(
        np.int32), rng.integers(-1, 9, size=len(keys)).astype(np.int32),
        rng.integers(0, 300, size=len(keys)).astype(np.int32),
        rng.uniform(0.1, 4.0, size=len(keys)).astype(np.float32),
        functions=[f"fn{i}" for i in range(50)])


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_step_on_card_matches_single_card(cuda, shape, deep):
    """The sharded serving step on a mesh of four entries on one card
    (routed and replicated, with family rows) equals the single-card
    best-call pack and rollup and the same step on four CPU entries;
    probe_routed equals probe_sharded, ShardedEngine.probe_compact equals
    FastAnnotator's, and the five kernels of the path launch."""
    from close_kmers_tpu_torch.parallel import sharding as SH
    rng = np.random.default_rng(11)
    db = _deep_db(rng) if deep else _db(rng)[0]
    offsets = np.full((64, 160), 20, np.uint8)
    lengths = rng.integers(30, 150, size=64).astype(np.int32)
    for b in range(64):
        ks = rng.choice(db.keys, size=20)
        spelled = ((ks[:, None] // 20 ** np.arange(7, -1, -1)) % 20)
        offsets[b, :lengths[b]] = np.resize(spelled.reshape(-1), lengths[b])
    mapping = family_db.KmerFamilyMapping()
    for k in db.keys:
        for f in set(rng.integers(0, 30, size=rng.integers(1, 4)).tolist()):
            mapping.add_fam_mapping(int(f), int(k))
    fam = DeviceFamilyScorer(db, mapping, "cpu").fdb.fam.numpy()
    params = EngineParams(min_hits=2, max_gap=40)
    want_best = DeviceScorer(db, "cpu").best_batch_packed(offsets, lengths,
                                                          params)
    want_roll = DeviceFamilyScorer(db, mapping, "cpu").rollup(
        offsets, lengths, fams_per_seq_cap=64)
    names = ("probe_select", "scan_score", "row_gather", "family_group",
             "best_call")
    kernels = (probe_select, scan_score, row_gather, family_group, best_call)
    before = [k.launches for k in kernels]
    sdb = {}
    for dev in ("cpu", cuda):
        mesh = SH.make_mesh(*shape, devices=[dev] * 4)
        sdb[dev] = SH.ShardedDB.from_db(db, mesh)
    assert (sdb[cuda].sub_blocks is not None) == deep
    for routed in (True, False):
        outs = {dev: SH.serve_step_sharded(
            s, offsets, lengths, params=params,
            fam_shards=SH.shard_fam_table(fam, s), cap_seq=64,
            routed=routed) for dev, s in sdb.items()}
        got = outs[cuda]
        assert got[0].device.type == cuda.type
        assert torch.equal(got[0].cpu(), want_best)
        for a, b in zip(outs["cpu"], got):
            assert torch.equal(bits(a), bits(b))
        roll = DeviceFamilyScorer.finish_rollup_rows(got[3].cpu().numpy(),
                                                     64)
        for a, b in zip(want_roll, roll):
            assert np.array_equal(np.asarray(a).view(np.int32),
                                  np.asarray(b).view(np.int32))
        assert int(got[2].sum()) == 0
    rep = SH.probe_sharded(sdb[cuda], offsets, lengths)
    rt = SH.probe_routed(sdb[cuda], offsets, lengths)
    for a, b in zip(rep[:5], rt[:5]):
        assert torch.equal(bits(a), bits(b))
    hw = FastAnnotator(db, "cpu").probe_compact(offsets, lengths)
    for routed in (True, False):
        hg = SH.ShardedEngine(db, sdb[cuda].mesh, routed=routed) \
            .probe_compact(offsets, lengths)
        for k in hw:
            assert np.array_equal(np.asarray(hg[k]).view(np.int32),
                                  np.asarray(hw[k]).view(np.int32)), k
    assert len(hw["pos"]) > 500
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after, before)), \
        dict(zip(names, zip(before, after)))
