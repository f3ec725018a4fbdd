# Frozen copy of close_kmers_tpu_torch/core/oracle.py at commit 8a7e9d7b116deea5496cfc89e97fd59b7681397e (with the constants of params.py and seq_to_offsets of ops/encoder.py it reads).
"""The plain reference's scoring: an exact re-statement of the reference
engine's hot-loop state machine (kguts.cc:682-973) in plain Python and
NumPy, copied so that a change to the port cannot move what the
benchmark calls correct.

* gather_hits / process_set_of_hits / advance_past_ambig  kguts.cc:682-877
* process_aa_seq                                        kguts.cc:888-908
* find_best_call                                        kguts.cc:1008-1199
* output formatting                                     kguts.cc:939-973

Floating point: weighted-hit accumulation is done in float32 in hit
order, as the reference's ``float weighted_hits`` adds are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

K = 8
MAX_HITS_PER_SEQ = 40000
HIT_BUFFER_CAP = MAX_HITS_PER_SEQ - 2

PROT_ALPHA = "ACDEFGHIKLMNPQRSTVWY"
# byte -> amino-acid offset, invalid = 20 (kmer_encoder.cc:7-13)
AA_TO_OFFSET = np.full(256, 20, dtype=np.uint8)
for _i, _c in enumerate(PROT_ALPHA):
    AA_TO_OFFSET[ord(_c)] = _i


@dataclasses.dataclass
class EngineParams:
    """KmerGuts::set_default_parameters (kguts.cc:236-242)."""
    order_constraint: int = 0
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200


# the float type of every weight sum: float32, as the reference adds; the
# benchmark's control rounds each sum to bfloat16 instead (:func:`bf16`)
F32 = np.float32


def bf16(x) -> np.float32:
    """``x`` as float32, rounded to the nearest bfloat16 (ties to even):
    the control's precision, the step below the float32 the
    configurations state."""
    b = np.asarray(x, dtype=np.float32).reshape(1).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)[0]


def seq_to_offsets(seq: str | bytes) -> np.ndarray:
    """Protein string -> uint8 offsets (invalid chars = 20)."""
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    return AA_TO_OFFSET[np.frombuffer(seq, dtype=np.uint8)]


@dataclasses.dataclass
class Hit:
    """One signature-kmer hit (KmerHit, kguts.h:154-163)."""
    oI: int
    pos: int            # from0_in_prot
    avg_off: int        # avg_off_from_end
    fI: int
    wt: float           # function_wt (float32 value)
    code: int = 0       # encoded kmer


@dataclasses.dataclass
class Call:
    """One run-of-hits call (KmerCall, kguts.h:166-183)."""
    start: int
    end: int
    count: int
    fI: int
    weighted: np.float32


class OtuStats:
    """KmerOtuStats (kguts.h:185-219): otu->count map finalized into a
    count-descending list; ties keep ascending-otu order (std::map
    iteration then stable sort by count desc)."""

    def __init__(self) -> None:
        self.otu_map: dict[int, int] = {}

    def add(self, oI: int) -> None:
        self.otu_map[oI] = self.otu_map.get(oI, 0) + 1

    def finalize(self) -> list[tuple[int, int]]:
        # std::map iterates keys ascending; std::sort by count desc is not
        # stable in general but less_second is a strict weak order on the
        # count only — we use Python's stable sort on the ascending-key
        # list, which matches libstdc++ behavior for the small lists here.
        items = sorted(self.otu_map.items())
        items.sort(key=lambda kv: -kv[1])
        self.otus_by_count = items
        return items


LookupFn = Callable[[int], tuple[int, int, int, float] | None]
# lookup(encoded_kmer) -> (fI, oI, avg_off, wt) or None


def advance_past_ambig(pI: np.ndarray, p: int, bound: int) -> int:
    """kguts.cc:682-732 (K==8 branch): advance p to the first position
    < bound whose 8-char window has no offset-20 character, scanning the
    window back-to-front and jumping past the offending character."""
    while p < bound:
        bad = False
        for j in range(K - 1, -1, -1):
            if pI[p + j] == 20:
                bad = True
                p += j + 1
                break
        if not bad:
            return p
    return p


class GatherState:
    """The mutable run state of gather_hits: the literal hit buffer plus
    current_fI, exactly as in the reference (kguts.h:263-264,285)."""

    def __init__(self, params: EngineParams):
        self.params = params
        self.hits: list[Hit] = []
        self.num_hits = 0
        self.current_fI = 0

    def _set(self, idx: int, h: Hit) -> None:
        if idx < len(self.hits):
            self.hits[idx] = h
        else:
            assert idx == len(self.hits)
            self.hits.append(h)

    def process_set_of_hits(self, calls: list[Call] | None, otu: OtuStats | None) -> None:
        """kguts.cc:734-781."""
        if calls is None and otu is None:
            return
        p = self.params
        fI_count = 0
        weighted = F32(0.0)
        last_hit = 0
        for i in range(self.num_hits):
            if self.hits[i].fI == self.current_fI:
                last_hit = i
                fI_count += 1
                weighted = F32(weighted + F32(self.hits[i].wt))
        if self.num_hits > 0 and fI_count >= p.min_hits and weighted >= p.min_weighted_hits:
            if calls is not None:
                calls.append(Call(self.hits[0].pos, self.hits[last_hit].pos + (K - 1),
                                  fI_count, self.current_fI, weighted))
            if otu is not None:
                for i in range(last_hit + 1):
                    if self.hits[i].fI == self.current_fI:
                        otu.add(self.hits[i].oI)
        # Run-reseed quirk (kguts.cc:772-777): if the final two buffered
        # hits agree on a function different from current_fI, they seed
        # the next run.
        if (self.num_hits >= 2
                and self.hits[self.num_hits - 2].fI != self.current_fI
                and self.hits[self.num_hits - 2].fI == self.hits[self.num_hits - 1].fI):
            self.current_fI = self.hits[self.num_hits - 1].fI
            self._set(0, self.hits[self.num_hits - 2])
            self._set(1, self.hits[self.num_hits - 1])
            self.num_hits = 2
        else:
            self.num_hits = 0

    def on_hit(self, h: Hit, calls: list[Call] | None, otu: OtuStats | None) -> None:
        """The per-hit body of the gather loop (kguts.cc:808-857), *after*
        the hit_cb has fired."""
        p = self.params
        # Gap flush (kguts.cc:821-831).
        if self.num_hits > 0 and self.hits[self.num_hits - 1].pos + p.max_gap < h.pos:
            if self.num_hits >= p.min_hits:
                self.process_set_of_hits(calls, otu)
            else:
                self.num_hits = 0
        if self.num_hits == 0:
            self.current_fI = h.fI
        # Order-constraint admission (kguts.cc:838-842).  The reference
        # computes the distance drift in unsigned 32-bit arithmetic, so a
        # negative drift wraps and always fails the <=20 test: the
        # effective admission is 0 <= drift <= 20.
        admit = True
        if p.order_constraint and self.num_hits > 0:
            prev = self.hits[self.num_hits - 1]
            drift = (h.pos - prev.pos) - (prev.avg_off - h.avg_off)
            admit = (h.fI == prev.fI) and (0 <= drift <= 20)
        if admit:
            self._set(self.num_hits, h)
            if self.num_hits < HIT_BUFFER_CAP:
                self.num_hits += 1
            # Two-in-a-row flush (kguts.cc:852-856).
            if (self.num_hits > 1 and self.current_fI != h.fI
                    and self.hits[self.num_hits - 2].fI == self.hits[self.num_hits - 1].fI):
                self.process_set_of_hits(calls, otu)

    def finish(self, calls: list[Call] | None, otu: OtuStats | None) -> None:
        """End-of-sequence flush (kguts.cc:873-877)."""
        if self.num_hits >= self.params.min_hits:
            self.process_set_of_hits(calls, otu)
        self.num_hits = 0


def gather_hits(
    pI: np.ndarray,
    lookup: LookupFn,
    params: EngineParams,
    calls: list[Call] | None,
    hit_cb: Callable[[Hit], None] | None,
    otu: OtuStats | None,
) -> None:
    """kguts.cc:783-877 over an offset-encoded sequence.

    Scans window start positions p in [0, len-K) — note the exclusive
    bound: the final full window at len-K is never probed (kguts.cc:792).
    """
    n = len(pI)
    bound = n - K  # exclusive (kguts.cc:792)
    state = GatherState(params)
    p = advance_past_ambig(pI, 0, bound)
    while p < bound:
        code = 0
        for j in range(K):
            code = code * 20 + int(pI[p + j])
        ent = lookup(code)
        if ent is not None:
            fI, oI, avg_off, wt = ent
            h = Hit(oI=oI, pos=p, avg_off=avg_off, fI=fI, wt=wt, code=code)
            if hit_cb is not None:
                hit_cb(h)
            state.on_hit(h, calls, otu)
        p += 1
        if p < bound and pI[p + K - 1] >= 20:
            p = advance_past_ambig(pI, p + K, bound)
    state.finish(calls, otu)


def process_aa_seq(
    seq: str,
    lookup: LookupFn,
    params: EngineParams | None = None,
    calls: list[Call] | None = None,
    hit_cb: Callable[[Hit], None] | None = None,
    otu: OtuStats | None = None,
) -> None:
    """kguts.cc:888-908."""
    params = params or EngineParams()
    pI = seq_to_offsets(seq)
    gather_hits(pI, lookup, params, calls, hit_cb, otu)
    if otu is not None:
        otu.finalize()


# ---------------------------------------------------------------------------
# find_best_call (kguts.cc:1008-1199)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BestCall:
    function_index: int
    function: str
    score: float
    weighted_score: float
    score_offset: float


def _heap2_make(vec, comp):
    """libstdc++ __make_heap on a 2-element range: value=vec[0] is removed,
    the child is copied up, then value is pushed down."""
    value = vec[0]
    vec[0] = vec[1]
    # __push_heap(first, hole=1, top=0, value)
    if comp(vec[0], value):
        vec[1] = vec[0]
        vec[0] = value
    else:
        vec[1] = value


def _heap2_pop_push(vec, i, comp):
    """libstdc++ __pop_heap variant used inside __heap_select: vec[i] and
    the heap root exchange, then re-heapify the 2-element heap."""
    value = vec[i]
    vec[i] = vec[0]
    vec[0] = vec[1]
    if comp(vec[0], value):
        vec[1] = vec[0]
        vec[0] = value
    else:
        vec[1] = value


def partial_sort_top2(vec: list, weighted_of: Callable[[object], float]) -> None:
    """Faithful std::partial_sort(first, first+2, last) with
    comp(a,b) = weighted(a) > weighted(b) (libstdc++ heap-select),
    reproducing tie resolution and the permutation of vec[2:]."""
    if len(vec) < 2:
        return
    comp = lambda a, b: weighted_of(a) > weighted_of(b)
    _heap2_make(vec, comp)
    for i in range(2, len(vec)):
        if comp(vec[i], vec[0]):
            _heap2_pop_push(vec, i, comp)
    # __sort_heap on 2 elements: single swap.
    vec[0], vec[1] = vec[1], vec[0]


def find_best_call(calls: list[Call], function_of: Callable[[int], str]) -> BestCall:
    """kguts.cc:1008-1199.

    ``function_of`` maps a function index to its name (function_at_index,
    kguts.h:361-366).
    """
    result = BestCall(-1, "", 0.0, 0.0, 0.0)
    if not calls:
        return result

    # 1. Collapse adjacent same-function runs (kguts.cc:1023-1040).
    collapsed: list[Call] = []
    i = 0
    while i < len(calls):
        cur = Call(calls[i].start, calls[i].end, calls[i].count,
                   calls[i].fI, F32(calls[i].weighted))
        i += 1
        while i < len(calls) and cur.fI == calls[i].fI:
            cur.end = calls[i].end
            cur.count += calls[i].count
            cur.weighted = F32(cur.weighted + F32(calls[i].weighted))
            i += 1
        collapsed.append(cur)

    # 2. Bridge-merge F1 | F2 | F1 when interior < 5 and combined
    #    exterior >= 10 (kguts.cc:1063-1086).
    merged: list[Call] = []
    interior_thresh, exterior_thresh = 5, 10
    i = 0
    while i < len(collapsed):
        cur = Call(collapsed[i].start, collapsed[i].end, collapsed[i].count,
                   collapsed[i].fI, F32(collapsed[i].weighted))
        merged.append(cur)
        i += 1
        while (i < len(collapsed) and i + 1 < len(collapsed)
               and cur.fI == collapsed[i + 1].fI
               and collapsed[i].count < interior_thresh
               and cur.count + collapsed[i + 1].count >= exterior_thresh):
            cur.end = collapsed[i + 1].end
            cur.count += collapsed[i + 1].count
            cur.weighted = F32(cur.weighted + F32(collapsed[i + 1].weighted))
            i += 2

    # 3. Per-function totals in a std::map (ascending function index,
    #    kguts.cc:1108-1131), f32 accumulation in merged order.
    by_func: dict[int, list] = {}
    for c in merged:
        ent = by_func.get(c.fI)
        if ent is None:
            by_func[c.fI] = [c.count, F32(c.weighted)]
        else:
            ent[0] += c.count
            ent[1] = F32(ent[1] + F32(c.weighted))
    vec = [(fi, cnt, wt) for fi, (cnt, wt) in sorted(by_func.items())]

    if len(vec) > 1:
        partial_sort_top2(vec, lambda e: e[2])

    # 4. Score offset and call decision (kguts.cc:1149-1198).
    if len(vec) == 1:
        score_offset = float(vec[0][1])
    else:
        score_offset = float(vec[0][1] - vec[1][1])
    result.score_offset = score_offset

    if score_offset >= 5.0:
        fi, cnt, wt = vec[0]
        result.function_index = fi
        result.function = function_of(fi)
        result.score = float(cnt)
        result.weighted_score = float(wt)
    else:
        if len(vec) >= 2:
            f1 = function_of(vec[0][0])
            f2 = function_of(vec[1][0])
            if f2 > f1:
                f1, f2 = f2, f1
            if len(vec) == 2:
                result.function = f"{f1} ?? {f2}"
                result.score = float(vec[0][1])
            else:
                pair_offset = float(vec[1][1] - vec[2][1])
                if pair_offset > 5.0:
                    result.function = f"{f1} ?? {f2}"
                    result.score = float(vec[0][1])
                    result.score_offset = pair_offset
                    result.weighted_score = float(vec[0][2])
    return result


# ---------------------------------------------------------------------------
# Output formatting (kguts.cc:939-973); C++ ostream floats default to
# 6-significant-digit %g.
# ---------------------------------------------------------------------------

def fmt_float(x) -> str:
    """Replicates `os << (float)x`: %g with 6 significant digits of the
    float32 value promoted to double."""
    return "%g" % float(np.float32(x))


def format_call(c: Call, function_of: Callable[[int], str]) -> str:
    return (f"CALL\t{c.start}\t{c.end}\t{c.count}\t{c.fI}\t"
            f"{function_of(c.fI)}\t{fmt_float(c.weighted)}\n")


def format_otu_stats(seq_id: str, size: int, otu: OtuStats) -> str:
    """kguts.cc:961-973 — only the top 5 OTUs are printed."""
    parts = [f"OTU-COUNTS\t{seq_id}[{size}]"]
    for oI, count in otu.otus_by_count[:5]:
        parts.append(f"\t{count}-{oI}")
    return "".join(parts) + "\n"


def function_of_factory(function_index: list[str]) -> Callable[[int], str]:
    """function_at_index parity (kguts.h:361-366)."""
    def fn(i: int) -> str:
        if i < 0 or i >= len(function_index):
            return "INVALID_OFFSET"
        return function_index[i]
    return fn
