"""Row gather ``out[i] = table[idx[i]]`` over int32 rows.

Port of ``close_kmers_tpu/ops/pallas_gather.py::pallas_row_gather``, the
gather that the family path runs as ``core/device_family.py::
_gather_fams``.  On a CUDA tensor :func:`row_gather` launches the
hand-written kernel ``csrc/row_gather.cu``; on a CPU tensor it runs
:func:`row_gather_plain`.  Any number of ids and any row width: the
TPU's 1024-id chunks were its tiling rule, not part of the contract.

Ids outside ``[0, R)`` never yield an answer.  On the CPU the wrapper
raises ``IndexError`` at once.  On the card the kernel tests every id
itself (a bad one writes a zero row and sets a flag in device memory);
the wrapper queues the flag's copy to the host right after the launch,
on the same stream, and returns it as an :class:`IdCheck`.  The caller
calls :meth:`IdCheck.raise_if_bad` after it has waited for its own copy
of the result, so the check adds no host read and no sync.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]

MAX_WIDTH = 8192    # ints per row: csrc/row_gather.cu's staging tile


class IdCheck:
    """The id test of one :func:`row_gather` call.  On the card it holds
    the kernel's bad-id flag on its way to pinned host memory; on the CPU
    (where the wrapper has already raised on a bad id) it holds nothing."""

    def __init__(self, flag: torch.Tensor | None = None, event=None,
                 rows: int = 0):
        self._flag = flag
        self._event = event
        self._rows = rows

    def raise_if_bad(self) -> None:
        """Raises ``IndexError`` if the kernel met an id outside
        ``[0, R)``.  Call it after waiting for a result that the launch
        fed: the flag's copy was queued before it, so the wait below has
        already passed and costs nothing."""
        if self._flag is None:
            return
        self._event.synchronize()
        if int(self._flag[0]):
            raise IndexError(f"row ids outside the {self._rows} rows of "
                             f"the table")


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
    return table.device


def row_gather(table, idx):
    """:func:`row_gather_plain`'s contract; returns ``(out, check)``.
    Launches the CUDA kernel when the tensors lie on the card.  Raises on
    a bad dtype, shape, layout or device; ids outside ``[0, R)`` raise
    ``IndexError`` here on the CPU and at ``check.raise_if_bad()`` on
    the card."""
    dev = _check(table, idx)
    if dev.type == "cpu":
        if idx.numel():
            lo, hi = (int(v) for v in torch.aminmax(idx))
            if lo < 0 or hi >= table.shape[0]:
                raise IndexError(f"row ids span [{lo}, {hi}], outside the "
                                 f"{table.shape[0]} rows of the table")
        return row_gather_plain(table, idx), IdCheck()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if table.shape[1] > MAX_WIDTH:
        raise ValueError(f"row_gather takes rows of at most {MAX_WIDTH} "
                         f"ints, not {table.shape[1]}")
    n, w = idx.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.int32, device=dev)
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    _launch(table, idx, out, bad)
    with torch.cuda.device(dev):
        flag = torch.empty(1, dtype=torch.int32, pin_memory=True)
        flag.copy_(bad, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return out, IdCheck(flag, event, table.shape[0])


def _launch(table, idx, out, bad):
    """The kernel launch alone (with the clearing of ``bad``), on checked
    CUDA tensors and allocated outputs."""
    dev = table.device
    fn = _build.kernel("ck_row_gather", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), idx.data_ptr(), idx.shape[0],
                table.shape[0], table.shape[1], out.data_ptr(),
                bad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ck_row_gather")
    row_gather.launches += 1


row_gather.launches = 0
