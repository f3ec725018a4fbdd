"""The probe-gather experiments' kernels: ports of the four Pallas kernels
of ``scripts/gather_exp.py``, the repo's instrument for the floors under
the probe's random row reads.

* :func:`dma_gather` -- ``pallas_dma_gather``: ``out[k] = table[idx[k]]``;
* :func:`vgather` -- ``pallas_vgather``: rows gathered from a tile held
  in on-chip memory, one sum per chunk of ids;
* :func:`hbmstream` -- ``pallas_hbmstream``: a sequential stream of the
  table, one sum per block of rows;
* :func:`dmaflush` -- ``pallas_dmaflush``: scattered block writes of one
  staged buffer.

On a CUDA tensor each wrapper launches its entry of the hand-written
kernel ``csrc/gather_exp.cu``; on a CPU tensor it runs its ``*_plain``
version.  Each computes what the Pallas kernel computes, not its (8,
128)-broadcast output tile.  The two sums are the exact integer sum,
rounded once to f32, on both routes.

The wrappers that take ids (:func:`dma_gather`, :func:`vgather`,
:func:`dmaflush`) read the id range back to the host before a launch (a
sync); each ``_launch_*`` is the launch alone, for timed loops over
checked inputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Largest [rows, 128] int32 tile that fits one block's shared memory on
# Hopper (227 KB opt-in, 232,448 B) beside the kernel's partial sums (256 B
# a chunk, one chunk at the least): 448 rows = 229,376 B, which leaves room
# for 12 chunks a round.  The TPU kernel held 2048 rows (1 MB of VMEM).
VGATHER_TILE_ROWS = 448
DMA_DEPTHS = (1, 2, 4, 8, 16, 32)

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _int32_2d(name: str, t) -> None:
    if t.dtype != torch.int32 or t.dim() != 2:
        raise TypeError(f"{name} must be a 2-d int32 tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ids(name: str, ids, bound: int, devices) -> torch.device:
    """Checks an int32 id tensor against [0, bound) (one host read of its
    range: a sync on the card) and that every tensor lies on one CPU or
    CUDA device; returns that device."""
    if ids.dtype != torch.int32:
        raise TypeError(f"{name} must be int32")
    if not ids.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    devs = {t.device for t in devices}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= bound:
            raise IndexError(f"{name} span [{lo}, {hi}], outside [0, "
                             f"{bound})")
    return dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- dma_gather ----------------------------------------------------------

def dma_gather_plain(table, idx):
    """``table`` [R, w] i32 rows picked by ``idx`` [n] i32: [n, w]."""
    return table[idx.long()]


def dma_gather(table, idx, depth: int = 16):
    """:func:`dma_gather_plain`'s contract for any n; on the card, each
    warp keeps ``depth`` rows in flight (a power of two up to 32).  Raises
    on a bad dtype, shape, layout or device, and on ids outside ``[0,
    R)``."""
    _int32_2d("table", table)
    if idx.dim() != 1:
        raise ValueError("idx must be flat")
    if depth not in DMA_DEPTHS:
        raise ValueError(f"depth must be one of {DMA_DEPTHS}")
    dev = _ids("idx", idx, table.shape[0], (table, idx))
    if dev.type == "cpu":
        return dma_gather_plain(table, idx)
    return _launch_dma_gather(table, idx, depth)


def _launch_dma_gather(table, idx, depth: int = 16):
    n, w = idx.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.int32, device=table.device)
    fn = _build.kernel("ck_dma_gather",
                       [_P, _P, _I64, _I32, _I32, _P, _P])
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), idx.data_ptr(), n, w, depth,
                out.data_ptr(), _stream(table.device))
    _build.check(rc, "ck_dma_gather")
    dma_gather.launches += 1
    return out


dma_gather.launches = 0


# -- vgather -------------------------------------------------------------

def vgather_plain(tile, idx, chunk: int):
    """``out[c]`` (f32) = the sum of every element of ``tile[id]`` over
    the ids ``idx[c*chunk:(c+1)*chunk]``: the exact int64 sum, rounded
    once.  ``idx`` [n] i32 with n a multiple of ``chunk``; [n // chunk]."""
    rows = tile[idx.long()].reshape(idx.shape[0] // chunk, -1)
    return rows.sum(dim=1, dtype=torch.int64).float()


def vgather(tile, idx, chunk: int):
    """:func:`vgather_plain`'s contract; on the card the tile lives in one
    block's shared memory, so it may hold at most 232,192 B (e.g.
    :data:`VGATHER_TILE_ROWS` rows of 128 ints).  Raises on a bad dtype,
    shape, layout or device, and on ids outside the tile."""
    _int32_2d("tile", tile)
    if idx.dim() != 1:
        raise ValueError("idx must be flat")
    if chunk <= 0 or idx.shape[0] % chunk:
        raise ValueError(f"{idx.shape[0]} ids are not whole chunks of "
                         f"{chunk}")
    dev = _ids("idx", idx, tile.shape[0], (tile, idx))
    if dev.type == "cpu":
        return vgather_plain(tile, idx, chunk)
    return _launch_vgather(tile, idx, chunk)


def _launch_vgather(tile, idx, chunk: int):
    rows, w = tile.shape
    n_chunks = idx.shape[0] // chunk
    out = torch.empty(n_chunks, dtype=torch.float32, device=tile.device)
    fn = _build.kernel("ck_vgather", [_P, _I32, _I32, _P, _I64, _I32, _P, _P])
    with torch.cuda.device(tile.device):
        rc = fn(tile.data_ptr(), rows, w, idx.data_ptr(), n_chunks, chunk,
                out.data_ptr(), _stream(tile.device))
    _build.check(rc, "ck_vgather")
    vgather.launches += 1
    return out


vgather.launches = 0


# -- hbmstream -----------------------------------------------------------

def hbmstream_plain(table, blk: int):
    """``out[b]`` (f32) = the sum of rows ``[b*blk, (b+1)*blk)`` of
    ``table`` [R, w] i32: the exact int64 sum, rounded once.  [R // blk];
    rows past the last whole block are not read, as in the Pallas
    kernel's grid."""
    n_blk = table.shape[0] // blk
    return table[:n_blk * blk].reshape(n_blk, -1).sum(
        dim=1, dtype=torch.int64).float()


def hbmstream(table, blk: int):
    """:func:`hbmstream_plain`'s contract.  Raises on a bad dtype, shape,
    layout or device."""
    _int32_2d("table", table)
    if blk <= 0:
        raise ValueError(f"bad block of {blk} rows")
    if table.device.type == "cpu":
        return hbmstream_plain(table, blk)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n_blk = table.shape[0] // blk
    out = torch.empty(n_blk, dtype=torch.float32, device=table.device)
    fn = _build.kernel("ck_hbmstream", [_P, _I64, _I64, _P, _P])
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), n_blk, blk * table.shape[1],
                out.data_ptr(), _stream(table.device))
    _build.check(rc, "ck_hbmstream")
    hbmstream.launches += 1
    return out


hbmstream.launches = 0


# -- dmaflush ------------------------------------------------------------

def dmaflush_plain(dst, buf, rows_per_dma: int):
    """``dst`` [P, J] i32, ``buf`` [J*rows_per_dma, w] i32 -> ``out``
    [P*J*rows_per_dma, w] with, for program i and slot j,
    ``out[dst[i,j]*rpd : +rpd] = buf[j*rpd : +rpd]``: every program
    flushes the same ``buf``.  ``dst`` must be a permutation of [0, P*J),
    so that every row of ``out`` is written; raises ValueError when it is
    not."""
    n_dmas = dst.numel()
    flat = dst.reshape(-1).long()
    if not torch.equal(torch.sort(flat)[0],
                       torch.arange(n_dmas, device=dst.device)):
        raise ValueError("dst is not a permutation of its own length")
    src = buf.reshape(dst.shape[1], -1)
    out = torch.empty((n_dmas, src.shape[1]), dtype=buf.dtype,
                      device=buf.device)
    out[flat] = src.repeat(dst.shape[0], 1)
    return out.reshape(n_dmas * rows_per_dma, buf.shape[1])


def dmaflush(dst, buf, rows_per_dma: int):
    """:func:`dmaflush_plain`'s contract.  On the card the wrapper checks
    that ``dst`` lies in range, but not that its rows are distinct (that
    would need a sort); a repeated row leaves another row unwritten."""
    _int32_2d("dst", dst)
    _int32_2d("buf", buf)
    if rows_per_dma <= 0 or buf.shape[0] != dst.shape[1] * rows_per_dma:
        raise ValueError(f"buf holds {buf.shape[0]} rows, not "
                         f"{dst.shape[1]} slots of {rows_per_dma}")
    dev = _ids("dst", dst, dst.numel(), (dst, buf))
    if dev.type == "cpu":
        return dmaflush_plain(dst, buf, rows_per_dma)
    return _launch_dmaflush(dst, buf, rows_per_dma)


def _launch_dmaflush(dst, buf, rows_per_dma: int):
    n_dmas, w = dst.numel(), buf.shape[1]
    out = torch.empty((n_dmas * rows_per_dma, w), dtype=torch.int32,
                      device=buf.device)
    fn = _build.kernel("ck_dmaflush", [_P, _P, _I64, _I32, _I64, _P, _P])
    with torch.cuda.device(buf.device):
        rc = fn(dst.data_ptr(), buf.data_ptr(), n_dmas, dst.shape[1],
                rows_per_dma * w, out.data_ptr(), _stream(buf.device))
    _build.check(rc, "ck_dmaflush")
    dmaflush.launches += 1
    return out


dmaflush.launches = 0
