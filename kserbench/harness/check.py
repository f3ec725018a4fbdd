"""What decides ``correct``: every request sent in the window was answered
whole, every protein of it in request order, and a sample of the served
records, drawn from the seed, equals the plain reference byte for byte.

Each number compared has its limit (:data:`LIMITS`):

* ``unanswered``: requests sent in the window whose answer never came
  whole (an error, a status other than 200, no end within the drain);
* ``misordered``: positions, over the answered requests, whose record
  is not the request's protein at that position (a protein dropped,
  added, or out of order);
* ``wrong``: sampled records that differ from the reference's;
* ``compared``: records compared (at least one).
"""

from __future__ import annotations

import numpy as np

from ..reference import oracle as O
from ..reference.answers import RefDB

HEADER = b"HTTP/1.1 200 OK\nContent-type: text/plain\n\n"

# name -> (kind, limit): "max" holds value <= limit, "min" value >= limit
LIMITS = {"unanswered": ("max", 0), "misordered": ("max", 0),
          "wrong": ("max", 0), "compared": ("min", 1)}


def passes(name: str, value) -> bool:
    kind, limit = LIMITS[name]
    return value <= limit if kind == "max" else value >= limit


def served(records, pool, t_end: float, endpoint):
    """(unanswered, misordered, answered): ``answered`` lists (request,
    position, record bytes) of every record served at its place."""
    unanswered = misordered = 0
    answered = []
    for r in records:
        if r.t_send >= t_end:
            continue
        if not (r.ok and r.t_done is not None
                and r.response.startswith(HEADER)):
            unanswered += 1
            continue
        req = pool.requests[r.index]
        recs = endpoint.split_records(r.response[len(HEADER):])
        ids = [endpoint.record_id(x) for x in recs]
        n = max(len(ids), len(req.ids))
        for i in range(n):
            if i < len(ids) and i < len(req.ids) and ids[i] == req.ids[i]:
                answered.append((req, i, recs[i]))
            else:
                misordered += 1
    return unanswered, misordered, answered


def sample(answered: list, n: int, seed: int) -> list:
    """``n`` of the answered records drawn from ``seed``, and the longest
    protein answered."""
    if not answered:
        return []
    rng = np.random.default_rng([seed, 0x5A4D])
    pick = set(rng.choice(len(answered), size=min(n, len(answered)),
                          replace=False).tolist())
    pick.add(max(range(len(answered)),
                 key=lambda k: int(answered[k][0].lengths[answered[k][1]])))
    return [answered[k] for k in sorted(pick)]


def expected(endpoint, ref: RefDB, pool, picked: list) -> list:
    params = O.EngineParams()
    return [endpoint.expected(ref, req.ids[i], pool.seq(req, i), params)
            .encode("latin-1") for req, i, _ in picked]


def with_precision(fn, cast):
    """``fn()`` with the reference's weight sums in ``cast``."""
    saved = O.F32
    O.F32 = cast
    try:
        return fn()
    finally:
        O.F32 = saved


def judge(records, pool, t_end: float, endpoint, ref: RefDB, n_sample: int,
          seed: int, control: bool = False) -> tuple:
    """(numbers compared, control's numbers or None): the numbers by
    name, each beside its limit in :data:`LIMITS`.  With ``control``,
    the reference in bfloat16 is put in the program's place on the same
    sample and judged the same way."""
    unanswered, misordered, answered = served(records, pool, t_end,
                                              endpoint)
    picked = sample(answered, n_sample, seed)
    want = expected(endpoint, ref, pool, picked)
    wrong = sum(w != got for w, (_, _, got) in zip(want, picked))
    numbers = dict(unanswered=unanswered, misordered=misordered,
                   wrong=wrong, compared=len(picked))
    ctl = None
    if control:
        low = with_precision(lambda: expected(endpoint, ref, pool, picked),
                             O.bf16)
        ctl = dict(unanswered=0, misordered=0,
                   wrong=sum(w != c for w, c in zip(want, low)),
                   compared=len(picked))
    return numbers, ctl
