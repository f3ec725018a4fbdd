"""find_best_call's reductions over a scan's emitted CALLs, per row.

Port of ``close_kmers_tpu/core/device_score.py::_best_call_device`` (XLA
on the TPU): from the scan's [B, W+1] ``emit`` and its count, function
and weight planes, each row's first ``CAPC`` = 32 calls are collapsed
(adjacent same-function calls), bridge-merged (F1|F2|F1), summed per
function in ascending function order, and run through a literal replica
of libstdc++ ``partial_sort(first, first + 2)``.  A row with more than 32
calls is flagged as overflow and still reduced over its first 32, as in
JAX.

Both versions return the [B, 9] int32 pack of ``_probe_best_jit``:
``n_funcs, fi0, cnt0, wt0, fi1, cnt1, wt1, v2c, overflow``, the two
weights as their f32 bits and ``overflow`` as 0/1.  On CUDA tensors
:func:`best_call` launches the hand-written kernel ``csrc/best_call.cu``
(one warp per row); on CPU tensors it runs :func:`best_call_plain`, the
reference's batched scans written in torch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

CAPC = 32          # call stream cap (device_score.py:239)
BIG = 2 ** 30      # the totals' sort key of an invalid entry

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64] * 4
             + [ctypes.c_int32] * 2 + [ctypes.c_void_p] * 2)


def _left_pack(valid, fields):
    """Per-row stable compaction: the valid entries of each row move to
    the left in their order.  Returns (per-row count, packed fields)."""
    order = torch.sort(valid.logical_not().to(torch.int32), dim=1,
                       stable=True)[1]
    return (valid.sum(dim=1, dtype=torch.int32),
            [f.gather(1, order) for f in fields])


def _scan(step, init, xs):
    """``jax.lax.scan`` over the columns of the [B, M] tensors ``xs``:
    returns the final carry and each output stacked to [B, M]."""
    carry, ys = init, []
    for t in range(xs[0].shape[1]):
        carry, y = step(carry, [x[:, t] for x in xs])
        ys.append(y)
    return carry, [torch.stack(col, dim=1) for col in zip(*ys)]


def best_call_plain(emit, c_cnt, c_fi, c_wt):
    """``emit`` bool and ``c_cnt`` / ``c_fi`` i32, ``c_wt`` f32, all
    [B, M]: the [B, 9] int32 pack, by the reference's masked scans."""
    where = torch.where
    B, M = emit.shape
    dev = emit.device
    n_calls, (p_fi, p_cnt, p_wt) = _left_pack(emit, [c_fi, c_cnt, c_wt])
    if M > CAPC:
        overflow = n_calls > CAPC
        p_fi, p_cnt, p_wt = p_fi[:, :CAPC], p_cnt[:, :CAPC], p_wt[:, :CAPC]
        n_calls = n_calls.clamp(max=CAPC)
        M = CAPC
    else:
        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    valid = idx[None, :] < n_calls[:, None]
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    zf = torch.zeros(B, dtype=torch.float32, device=dev)
    no = torch.zeros(B, dtype=torch.bool, device=dev)

    def run_sum(s, x):
        """Adjacent equal-function runs summed (the collapse and the
        totals): emits the closed run where a new one starts."""
        have, cfi, ccnt, cwt = s
        v, fi, cnt, wt = x
        same = v & have & (fi == cfi)
        newg = v & (~have | (fi != cfi))
        y = (newg & have, cfi, ccnt, cwt)
        return (have | v, where(newg, fi, cfi),
                where(newg, cnt, where(same, ccnt + cnt, ccnt)),
                where(newg, wt, where(same, cwt + wt, cwt))), y

    # collapse adjacent same-function calls (kguts.cc:1023-1040)
    (have, cfi, ccnt, cwt), ys = _scan(run_sum, (no, zero, zero, zf),
                                       [valid, p_fi, p_cnt, p_wt])
    last = (have, cfi, ccnt, cwt)
    coll = [torch.cat([y, z[:, None]], dim=1) for y, z in zip(ys, last)]
    n2, (q_fi, q_cnt, q_wt) = _left_pack(coll[0], coll[1:])
    valid2 = torch.arange(q_fi.shape[1], device=dev)[None, :] < n2[:, None]

    # bridge-merge (kguts.cc:1063-1086): the current entry and a held one
    def bridge(s, x):
        have_c, fi_c, cnt_c, wt_c, have_h, fi_h, cnt_h, wt_h = s
        v, fi, cnt, wt = x
        a = v & ~have_c
        b = v & have_c & ~have_h
        c = v & have_c & have_h
        mrg = c & (fi == fi_c) & (cnt_h < 5) & (cnt_c + cnt >= 10)
        emit_cur = c & ~mrg
        y = (emit_cur, fi_c, cnt_c, wt_c)
        take = b | emit_cur
        return (have_c | a,
                where(a, fi, where(emit_cur, fi_h, fi_c)),
                where(a, cnt, where(mrg, cnt_c + cnt,
                                    where(emit_cur, cnt_h, cnt_c))),
                where(a, wt, where(mrg, wt_c + wt,
                                   where(emit_cur, wt_h, wt_c))),
                where(mrg, False, where(take, True, have_h)),
                where(take, fi, fi_h), where(take, cnt, cnt_h),
                where(take, wt, wt_h)), y

    sb, ysb = _scan(bridge, (no, zero, zero, zf, no, zero, zero, zf),
                    [valid2, q_fi, q_cnt, q_wt])
    br = [torch.cat([y, c[:, None], h[:, None]], dim=1)
          for y, c, h in zip(ysb, sb[:4], sb[4:])]

    # per-function totals in ascending function order, f32 adds in the
    # merged order: a stable sort by function (invalid entries keyed BIG)
    key = where(br[0], br[1], BIG)
    s_fi, order = torch.sort(key, dim=1, stable=True)
    s_cnt, s_wt = br[2].gather(1, order), br[3].gather(1, order)
    (have, tfi, tcnt, twt), yst = _scan(
        lambda s, x: run_sum(s, [x[0] < BIG, *x]), (no, zero, zero, zf),
        [s_fi, s_cnt, s_wt])
    last = (have, tfi, tcnt, twt)
    tot = [torch.cat([y, z[:, None]], dim=1) for y, z in zip(yst, last)]

    # the literal libstdc++ heap select over the totals stream
    # (device_score.py:352-404): comp(a, b) := a.wt > b.wt
    def heap(s, x):
        j, h0f, h0c, h0w, h1f, h1c, h1w, v2c = s
        v, fi, cnt, wt = x
        is0, is1, is2 = v & (j == 0), v & (j == 1), v & (j == 2)
        h0f, h0c, h0w = (where(is0, fi, h0f), where(is0, cnt, h0c),
                         where(is0, wt, h0w))
        c1 = wt > h0w
        mh0f = where(is1, where(c1, h0f, fi), h0f)
        mh0c = where(is1, where(c1, h0c, cnt), h0c)
        mh0w = where(is1, where(c1, h0w, wt), h0w)
        mh1f = where(is1, where(c1, fi, h0f), h1f)
        mh1c = where(is1, where(c1, cnt, h0c), h1c)
        mh1w = where(is1, where(c1, wt, h0w), h1w)
        cin = v & (j >= 2) & (wt > mh0w)
        v2c = where(is2, where(wt > mh0w, mh0c, cnt), v2c)
        c2 = mh1w > wt
        return (j + v.to(torch.int32),
                where(cin, where(c2, fi, mh1f), mh0f),
                where(cin, where(c2, cnt, mh1c), mh0c),
                where(cin, where(c2, wt, mh1w), mh0w),
                where(cin, where(c2, mh1f, fi), mh1f),
                where(cin, where(c2, mh1c, cnt), mh1c),
                where(cin, where(c2, mh1w, wt), mh1w), v2c), ()

    (n_funcs, h0f, h0c, h0w, h1f, h1c, h1w, v2c), _ = _scan(
        heap, (zero, zero, zero, zf, zero, zero, zf, zero), tot)
    # sort_heap's swap: vec0 = slot 1, vec1 = slot 0 (one function: slot 0)
    one = n_funcs == 1
    return torch.stack([
        n_funcs, where(one, h0f, h1f), where(one, h0c, h1c),
        where(one, h0w, h1w).view(torch.int32), h0f, h0c,
        h0w.view(torch.int32), v2c, overflow.to(torch.int32)], dim=1)


def _check(emit, c_cnt, c_fi, c_wt) -> torch.device:
    if emit.dtype != torch.bool:
        raise TypeError("emit must be bool")
    if c_cnt.dtype != torch.int32 or c_fi.dtype != torch.int32:
        raise TypeError("c_cnt and c_fi must be int32")
    if c_wt.dtype != torch.float32:
        raise TypeError("c_wt must be float32")
    if emit.dim() != 2 or any(t.shape != emit.shape
                              for t in (c_cnt, c_fi, c_wt)):
        raise ValueError("emit, c_cnt, c_fi and c_wt must share one [B, M] "
                         "shape")
    dev = emit.device
    if any(t.device != dev for t in (c_cnt, c_fi, c_wt)):
        raise ValueError("tensors on several devices: "
                         f"{[t.device for t in (emit, c_cnt, c_fi, c_wt)]}")
    return dev


def best_call(emit, c_cnt, c_fi, c_wt):
    """:func:`best_call_plain`'s contract; launches the CUDA kernel when
    the tensors lie on the card.  Rows may be strided (the scan's call
    planes are views of one allocation); each row itself must be
    contiguous, else it is copied.  Raises on a bad device, dtype or
    shape."""
    dev = _check(emit, c_cnt, c_fi, c_wt)
    if dev.type == "cpu":
        return best_call_plain(emit, c_cnt, c_fi, c_wt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ins = [t if t.stride(1) == 1 or t.shape[1] <= 1 else t.contiguous()
           for t in (emit, c_cnt, c_fi, c_wt)]
    out = torch.empty((emit.shape[0], 9), dtype=torch.int32, device=dev)
    if emit.shape[0]:
        _launch(*ins, out)
    return out


def _launch(emit, c_cnt, c_fi, c_wt, out):
    """The kernel launch alone, on checked CUDA tensors whose rows are
    contiguous and an allocated [B, 9] int32 ``out``."""
    B, M = emit.shape
    fn = _build.kernel("ck_best_call_device", _ARGTYPES)
    idx = emit.get_device()
    args = (emit.data_ptr(), emit.stride(0), c_cnt.data_ptr(),
            c_cnt.stride(0), c_fi.data_ptr(), c_fi.stride(0),
            c_wt.data_ptr(), c_wt.stride(0), B, M, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch.cuda.current_device():
        rc = fn(*args)
    else:            # the runtime launches on the calling thread's device
        with torch.cuda.device(idx):
            rc = fn(*args)
    _build.check(rc, "ck_best_call_device")
    best_call.launches += 1


best_call.launches = 0
