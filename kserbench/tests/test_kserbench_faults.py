"""The check has to fail a wrong answer: a call's weight altered where it
is produced, a protein dropped, two PGF ids swapped; and the control (the
plain reference in bfloat16 put in the program's place) has to fail."""

import numpy as np
import pytest

from conftest import run_tiny


def _nudge_weight(monkeypatch):
    """The first call's weight of each batch, raised ULP by ULP until its
    printed value changes: the smallest change the /query grammar shows
    (six significant digits hide a single ULP)."""
    from close_kmers_tpu_torch.native import api as native
    orig = native.score_batch

    def score_batch(*a, **kw):
        out = orig(*a, **kw)
        n_calls, cw = out[0], out[5]
        rows = np.nonzero(n_calls > 0)[0]
        if len(rows):
            r = rows[0]
            w0 = np.float32(cw[r, 0])
            w = w0
            while "%g" % float(w) == "%g" % float(w0):
                w = np.nextafter(w, np.float32(np.inf))
            cw[r, 0] = w
        return out
    monkeypatch.setattr(native, "score_batch", score_batch)


def _drop_protein(monkeypatch):
    """The last result of each engine call left out."""
    from close_kmers_tpu_torch.core import api
    orig = api.KmerEngine.annotate_with_hits

    def annotate_with_hits(self, items, *a, **kw):
        results, h = orig(self, items, *a, **kw)
        return results[:-1], h
    monkeypatch.setattr(api.KmerEngine, "annotate_with_hits",
                        annotate_with_hits)


def _swap_pgf(monkeypatch):
    """Two rows' PGF ids swapped in each batch's best matches."""
    from close_kmers_tpu_torch.core import family
    orig = family.find_best_family_matches_batch

    def batch(*a, **kw):
        ms = orig(*a, **kw)
        ids = [m.gfam_id for m in ms]
        for i in range(len(ms)):
            j = next((j for j in range(i + 1, len(ms))
                      if ids[j] and ids[j] != ids[i]), None)
            if ids[i] and j is not None:
                ms[i].gfam_id, ms[j].gfam_id = ms[j].gfam_id, ms[i].gfam_id
                break
        return ms
    monkeypatch.setattr(family, "find_best_family_matches_batch", batch)


@pytest.mark.parametrize("workload,fault,number", [
    ("tiny-query", _nudge_weight, "wrong"),
    ("tiny-query", _drop_protein, "misordered"),
    ("tiny-family", _swap_pgf, "wrong"),
])
def test_fault_is_not_correct(monkeypatch, workload, fault, number):
    fault(monkeypatch)
    r = run_tiny(workload, seed=11)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0


@pytest.mark.parametrize("workload", ["tiny-query", "tiny-family"])
def test_control_is_not_correct(workload):
    r = run_tiny(workload, seed=13, control=True)
    assert r["correct"] is True
    assert r["control"]["wrong"] > 0
