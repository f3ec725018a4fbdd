"""Device-resident whole-genome annotation, torch port of
``close_kmers_tpu/core/genome.py``: the whole process_seq pipeline
(six-frame translate, window encode, probe, run/gap scoring) on the
device, downloading only the compacted CALL pack.

* **Translation on device**: the DNA uploads once as base digits (0-3
  acgt, 4 ambiguous: ``ops.translate._DNA_CHAR``); the reverse-complement
  digit is ``3 - d``, and table-11 codon -> aa offset is five 64-bit
  boolean functions of the codon index read with int32 shifts (no
  gather).  Equal to ``ops.translate.six_frame_kguts_offsets``.
* **Tiles scored in parallel**: each frame tiles into rows of
  TILE_CHARS chars (STEP windows each, a K-char halo) scanned as one
  batch by the ``scan_score`` kernel, after one ``probe_windows`` of all
  rows (the ``probe_select`` kernel on the payload-wide and sub-block
  tiers).  The 13-field scan state is the whole gather_hits state, so
  cross-tile exactness comes from a fixpoint: scan every tile from a
  guessed initial state, hand each row the final state of the previous
  hit-bearing row of its frame, repeat until the guesses stop changing.
  Tile 0 of a frame starts from the neutral state, so by induction the
  fixpoint is the untiled state (2-3 rounds in practice).  The loop runs
  on the host, one sync a round; the JAX package runs it as a
  ``while_loop``.
* **Call compaction**: the final pass's emissions left-pack into one
  [6T] ++ [5 * call_cap] int32 buffer (``device_score.compact_calls``),
  the only download.

The translate, the tiling, the fixpoint's shift and compare and the call
pack stay torch, as XLA ran them on the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.scan_score import FLOAT_FIELDS, INT_FIELDS, neutral_scan_state
from ..params import K, EngineParams
from .device_score import _scan_score_core, compact_calls
from .engine import DeviceDB, device_db_of, encode_windows, probe_windows

TILE_CHARS = 1024          # chars per tile row
STEP = TILE_CHARS - K      # windows contributed per interior tile
# DNA lengths bucket to multiples of this, so that genomes of nearby
# sizes share one (N, T) shape.
N_BUCKET = 3 * STEP * 32


def _codon_masks() -> np.ndarray:
    """aa-offset[codon] for the 64 unambiguous codons as five 64-bit
    boolean functions: bit k of the offset == bit ``codon`` of mask k.
    Stored as [5, 2] int32 (lo, hi words)."""
    from ..ops.encoder import AA_TO_OFFSET
    from ..ops.translate import KGUTS_TABLE
    off = AA_TO_OFFSET[KGUTS_TABLE[:64]].astype(np.int64)
    out = np.zeros((5, 2), dtype=np.uint32)
    for k in range(5):
        m = 0
        for idx in range(64):
            m |= ((int(off[idx]) >> k) & 1) << idx
        out[k, 0] = m & 0xFFFFFFFF
        out[k, 1] = m >> 32
    return out.view(np.int32)


_CODON_MASKS = _codon_masks()


def _aa_of_idx4(i4: torch.Tensor) -> torch.Tensor:
    """Table-11 aa offset of int32 codon index i4 in [0, 64) via mask
    shifts (branchless, no gather; arithmetic >> then & 1 reads any bit,
    also of the negative hi words)."""
    masks = torch.from_numpy(_CODON_MASKS).to(i4.device)
    lo_sel = i4 < 32
    sh = torch.where(lo_sel, i4, i4 - 32)
    aa = torch.zeros_like(i4)
    for k in range(5):
        word = torch.where(lo_sel, masks[k, 0], masks[k, 1])
        aa = aa | (((word >> sh) & 1) << k)
    return aa


def _frames_of_digits(d: torch.Tensor, Lpad: int) -> torch.Tensor:
    """[N] int32 digits -> [3, Lpad] aa offsets for reading frames 0, 1,
    2 (codon i of frame f starts at digit f + 3i).  Digits >= 4 poison
    their codons to offset 20 (ambiguous -> 'x', kguts.cc:530)."""
    i4 = d[:-2] * 16 + d[1:-1] * 4 + d[2:]
    valid = (d[:-2] < 4) & (d[1:-1] < 4) & (d[2:] < 4)
    # an invalid codon's index can pass 63; it reads codon 0 instead
    aa = torch.where(valid, _aa_of_idx4(torch.where(valid, i4, 0)), 20)
    need = 3 * Lpad
    aa = torch.cat([aa, aa.new_full((max(need - aa.shape[0], 0),), 20)])
    return aa[:need].reshape(Lpad, 3).T


def _packed_state(s: dict) -> torch.Tensor:
    """The 13-field scan state as one [13, B] int32 tensor, the f32
    fields as their bits."""
    return torch.stack([s[k] for k in INT_FIELDS]
                       + [s[k].view(torch.int32) for k in FLOAT_FIELDS])


def _state_of(packed: torch.Tensor) -> dict:
    """:func:`_packed_state`'s inverse (views of ``packed``'s rows)."""
    n = len(INT_FIELDS)
    s = dict(zip(INT_FIELDS, packed[:n]))
    s.update(zip(FLOAT_FIELDS, packed[n:].view(torch.float32)))
    return s


def _genome_tiles(digits: torch.Tensor, n_true: int):
    """The six frames of ``digits`` ([N] uint8 base digits padded with 4;
    ``n_true`` the real DNA length) as tile rows: returns (tiles [6T,
    TILE_CHARS] uint8 aa offsets, tlens [6T] frame chars in each tile,
    pos0 [6T] each tile's first frame position, t_of [6T] each row's tile
    index, T)."""
    dev = digits.device
    N = digits.shape[0]
    Lpad = N // 3
    T = -(-Lpad // STEP)
    d = digits.to(torch.int32)
    # reverse complement: flip puts the tail padding at the front; roll
    # it back to the end (pad digits are 4 -> ambiguous codons)
    dc = torch.roll(torch.flip(torch.where(d < 4, 3 - d, 4), [0]),
                    -(N - n_true))
    aa6 = torch.cat([_frames_of_digits(d, Lpad), _frames_of_digits(dc, Lpad)])

    # tile: row r = (frame r // T, tile r % T) covering frame chars
    # [t * STEP, t * STEP + TILE_CHARS); the halo overlaps K chars
    padded = torch.cat(
        [aa6, aa6.new_full((6, (T + 1) * STEP - Lpad), 20)], dim=1)
    body = padded[:, :T * STEP].reshape(6, T, STEP)
    halo = padded[:, STEP:STEP + T * STEP].reshape(6, T, STEP)[:, :, :K]
    tiles = torch.cat([body, halo], dim=2).reshape(6 * T, TILE_CHARS)
    tiles = tiles.to(torch.uint8)

    r = torch.arange(6 * T, dtype=torch.int32, device=dev)
    frame_of = r // T
    t_of = r % T
    # frame aa lengths (kguts.cc:513-539: floor((n - off) / 3))
    f3 = torch.arange(6, dtype=torch.int32, device=dev) % 3
    Lf = torch.div(n_true - f3, 3, rounding_mode="floor")
    tlens = torch.clamp(Lf[frame_of.long()] - t_of * STEP, 0, TILE_CHARS)
    return tiles, tlens, t_of * STEP, t_of, T


def _genome_calls(ddb: DeviceDB, digits: torch.Tensor, n_true: int,
                  min_hits, min_weighted_hits, max_gap, order_constraint,
                  call_cap: int):
    """``digits``: [N] uint8 base digits padded with 4, on ``ddb``'s
    device; ``n_true``: the real DNA length.  Returns (packed calls
    buffer, the fixpoint's round count), as JAX ``_genome_calls_jit``:
    [6T] per-row call counts ++ [5 * min(call_cap, 6T * (STEP + 1))]
    (start, end, cnt, fi, wt-bits) planes in (frame, position) order."""
    dev = digits.device
    tiles, tlens, pos0, t_of, T = _genome_tiles(digits, n_true)
    r = torch.arange(6 * T, dtype=torch.int32, device=dev)

    hi, lo, valid = encode_windows(tiles, tlens)
    found, p_fi, _p_oi, p_av, p_wt, _ = probe_windows(ddb, hi, lo, valid)
    scan_args = (found, p_fi, p_av, p_wt, min_hits, min_weighted_hits,
                 max_gap, order_constraint)

    # fixpoint over cross-tile carries (see the module docstring).  A
    # tile with no hits is an identity transfer (every scan update is
    # gated on a hit), so each row's init comes from the nearest PREVIOUS
    # hit-bearing row of its frame: hit-free runs are jumped in one step.
    neutral = _packed_state(neutral_scan_state(6 * T, dev))
    row_has = found.any(dim=1)
    cand = torch.where(row_has, r, -1).reshape(6, T)
    prev_idx = torch.cat([cand.new_full((6, 1), -1),
                          torch.cummax(cand, dim=1).values[:, :-1]],
                         dim=1).reshape(6 * T)
    src = prev_idx.clamp(min=0).long()
    first = prev_idx < 0

    g = neutral
    n_iters = 0
    done = False
    while not done and n_iters < T + 2:
        _, _, fin = _scan_score_core(*scan_args, init=_state_of(g),
                                     pos0=pos0, want_emit=False)
        g2 = torch.where(first, neutral, _packed_state(fin)[:, src])
        done = torch.equal(g2, g)      # every field, the f32 ones by bits
        g = g2
        n_iters += 1

    # final emission pass with the exact init states; only each frame's
    # last row performs the end-of-sequence flush (kguts.cc:873-877)
    emit, fields, _ = _scan_score_core(
        *scan_args, init=_state_of(g), pos0=pos0, want_emit=True,
        final_flush=t_of == T - 1)
    return compact_calls(emit, fields, call_cap), n_iters


def bucketed_digits(seq):
    """``seq`` (str/bytes DNA, or a uint8 digit array in the
    ops.translate._DNA_CHAR encoding) as base digits padded with 4 to a
    multiple of N_BUCKET (at least one bucket).  Returns (digits, the
    real length)."""
    from ..ops.translate import _DNA_CHAR, _to_bytes
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        d = seq
    else:
        d = _DNA_CHAR[_to_bytes(seq)]
    n = len(d)
    N = -(-max(n, 1) // N_BUCKET) * N_BUCKET
    if N != n:
        d = np.concatenate([d, np.full(N - n, 4, np.uint8)])
    return np.ascontiguousarray(d), n


class GenomeAnnotator:
    """process_seq for whole genomes, device-resident end to end.

    ``calls_of(seq)`` returns the six per-frame call lists in reference
    frame order (+0,+1,+2,-0,-1,-2, kguts.cc:910-937), each call (start,
    end, count, fI, weighted_f32) with frame-local positions, equal to
    oracle.process_seq's accumulation order.  It probes
    ``device_db_of(db_or_engine, device)``'s table."""

    def __init__(self, db_or_engine, device="cuda"):
        self.ddb = device_db_of(db_or_engine, device)
        self.device = self.ddb.payload.device

    def dispatch(self, seq, params: EngineParams | None = None,
                 call_cap: int = 8192):
        """Run the device program; returns (the packed buffer on the
        device, the fixpoint's round count, T).  ``seq`` may be str/bytes
        DNA or a uint8 digit array (ops.translate._DNA_CHAR encoding)."""
        params = params or EngineParams()
        d, n = bucketed_digits(seq)
        out, iters = _genome_calls(
            self.ddb, torch.from_numpy(d).to(self.device), n,
            params.min_hits, params.min_weighted_hits, params.max_gap,
            params.order_constraint, call_cap)
        return out, iters, -(-(len(d) // 3) // STEP)

    # Copied from close_kmers_tpu/core/genome.py (pure numpy).
    @staticmethod
    def finish(out_np: np.ndarray, T: int, call_cap: int):
        """Device buffer -> (n_calls_per_frame [6], per-frame call lists).
        Returns None if call_cap overflowed (caller retries bigger)."""
        n_calls = out_np[:6 * T]
        total = int(n_calls.sum())
        if total > call_cap:
            return None
        pack = out_np[6 * T:].reshape(5, -1)
        per_frame = n_calls.reshape(6, T).sum(axis=1)
        wt = pack[4].view(np.float32)
        frames = []
        k = 0
        for f in range(6):
            m = int(per_frame[f])
            frames.append([(int(pack[0][k + i]), int(pack[1][k + i]),
                            int(pack[2][k + i]), int(pack[3][k + i]),
                            np.float32(wt[k + i])) for i in range(m)])
            k += m
        return per_frame, frames

    def calls_of(self, seq, params: EngineParams | None = None,
                 call_cap: int = 8192):
        """The six frames' calls of ``seq``; a call-cap overflow reruns
        the program with 4x the cap."""
        out, _, T = self.dispatch(seq, params, call_cap)
        res = self.finish(out.cpu().numpy(), T, call_cap)
        if res is None:
            return self.calls_of(seq, params, call_cap * 4)
        return res
