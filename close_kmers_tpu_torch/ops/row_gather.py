"""Row gather ``out[i] = table[idx[i]]`` over int32 rows.

Port of ``close_kmers_tpu/ops/pallas_gather.py::pallas_row_gather``, the
gather that the family path runs as ``core/device_family.py::
_gather_fams``.  On a CUDA tensor :func:`row_gather` launches the
hand-written kernel ``csrc/row_gather.cu``; on a CPU tensor it runs
:func:`row_gather_plain`.  Any number of ids and any row width: the
TPU's 1024-id chunks were its tiling rule, not part of the contract.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]


def row_gather_plain(table, idx):
    """``table`` [R, w] i32 rows picked by ``idx`` [n] i32: [n, w]."""
    return table[idx.long()]


def _check(table, idx) -> torch.device:
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("row_gather needs an int32 table and int32 ids")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError("row_gather needs a [R, w] table and flat ids")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather needs contiguous tensors")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, ids on {idx.device}")
    if idx.numel():
        # one host read of the id range (a sync on the card)
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= table.shape[0]:
            raise IndexError(f"row ids span [{lo}, {hi}], outside the "
                             f"{table.shape[0]} rows of the table")
    return table.device


def row_gather(table, idx):
    """:func:`row_gather_plain`'s contract; launches the CUDA kernel when
    the tensors lie on the card.  Raises on a bad dtype, shape, layout or
    device, and on ids outside ``[0, R)``."""
    dev = _check(table, idx)
    if dev.type == "cpu":
        return row_gather_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(table, idx)


def _launch(table, idx):
    """The kernel launch alone, on checked CUDA tensors."""
    dev = table.device
    n, w = idx.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.int32, device=dev)
    fn = _build.kernel("ck_row_gather", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), idx.data_ptr(), n, w, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
