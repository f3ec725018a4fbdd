"""The rooflines' byte counts: equal to hand counts at a small shape, and
the same whatever table layout the program probes through."""

import numpy as np
import pytest
import torch

from kserbench.roofline import family_group, probe_search


def test_probe_search_bytes_by_hand():
    # 3 windows, 2 found: each window 4 + 4 + 1 code bytes and 1 + 20
    # output bytes; each match its lo key (4) and payload (16)
    assert probe_search.bytes_moved(3, 2) == 3 * 30 + 2 * 20
    assert probe_search.bytes_moved(0, 0) == 0


def test_family_group_bytes_by_hand():
    # [2, 5, 3] rows: 30 ints read, 3 weights, 2 counts and 4 groups of
    # family, count, weight and first slot written
    assert family_group.bytes_moved(2, 5, 3, 4) == (
        30 * 4 + 3 * 4 + 2 * 4 + 4 * 16)


@pytest.mark.parametrize("tier", [{}, {"wide_payload": True}])
def test_probe_bytes_do_not_depend_on_the_layout(tier):
    """The probe's found windows (the only data its bytes read) are those
    whose code is a DB key, whatever tier (the binary search and its
    search rows, or payload-wide rows) the program builds."""
    from close_kmers_tpu_torch.core import engine
    from close_kmers_tpu_torch.db.signature_db import SignatureDB
    from kserbench.gen.scale_db import scale_db
    db = scale_db(40_000, True, 30, 3, torch.device("cpu"))
    sdb = SignatureDB(db.keys, db.fi, db.oi, db.avg_off, db.wt,
                      functions=db.functions)
    ddb = engine.DeviceDB.from_db(sdb, "cpu", **tier)
    rng = np.random.default_rng(1)
    B, L = 8, 64
    offsets = rng.integers(0, 20, size=(B, L)).astype(np.uint8)
    offsets[:, :8] = (db.keys[rng.integers(0, len(db), B)][:, None]
                      // 20 ** np.arange(7, -1, -1)) % 20
    lengths = np.full(B, L, np.int32)
    hi, lo, valid = engine.encode_windows(torch.from_numpy(offsets),
                                          torch.from_numpy(lengths))
    found = int(engine.probe_windows(ddb, hi, lo, valid)[0].sum())
    codes = np.lib.stride_tricks.sliding_window_view(
        offsets.astype(np.int64), 8, axis=1) @ (20 ** np.arange(7, -1, -1))
    # the scan's windows start at p < length - 8 (kguts.cc:792)
    want = int(np.isin(codes[:, :L - 8], db.keys).sum())
    assert found == want >= B
    assert probe_search.bytes_moved(hi.numel(), found) == \
        probe_search.bytes_moved(B * (L - 8), want)
