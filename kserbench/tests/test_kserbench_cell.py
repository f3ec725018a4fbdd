"""A tiny cell run end to end on the CPU: the port's server on its plain
kernels, the client process, the check against the plain reference, and
the contract's result line."""

import json

import pytest

from conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["tiny-query", "tiny-family"])
def test_tiny_cell_is_correct(workload, capsys):
    r = run_tiny(workload)
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["checks"]["compared"]["value"] > 0
    assert {"proteins_per_s", "request_p95_ms", "setup_s"} <= set(
        r["metrics"])
    # no device number from a CPU run
    assert "device_peak_gib" not in r["metrics"]
    json.loads(json.dumps(r))
    err = capsys.readouterr().err.strip().splitlines()
    assert [line.split()[1] for line in err[-4:]] == list(r["checks"])


def test_tiny_cell_traced_reports_layers():
    r = run_tiny("tiny-query", seed=7, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    for name in ("engine_ms_per_kprot.genomes", "server_self_ms_per_req.small",
                 "compute_wait_ms.small", "host_score_ms_per_kprot.genomes",
                 "device_program_ms_per_kprot.genomes",
                 "window_fill_pct.genomes"):
        assert m[name]["value"] > 0, name
    assert 0 < m["window_fill_pct.genomes"]["value"] <= 100
    # the CPU has no device trace: no roofline and no idle share
    assert not any("roofline" in k or "idle" in k for k in m)
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        run_tiny("tiny-query", device="cuda")


def test_innermost_span_of_each_gap():
    from kserbench.harness.cell import innermost
    spans = [("outer", 0, 10), ("inner", 2, 3), ("inner2", 5, 8),
             ("deep", 6, 7)]
    assert innermost(spans, [1, 2.5, 4, 5.5, 6.5, 7.5, 9, 11]) == [
        "outer", "inner", "outer", "inner2", "deep", "inner2", "outer",
        None]
