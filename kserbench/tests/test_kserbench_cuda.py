"""On the card (``cuda`` marker; skipped without one): the tiny cells
through the port's kernels, traced, with the rooflines and the idle
share read from the device trace."""

import pytest

from conftest import run_tiny

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["tiny-query", "tiny-family"])
def test_tiny_cell_on_the_card(card, workload):
    r = run_tiny(workload, seed=17, trace=True, control=True, device="cuda")
    assert r["correct"] is True
    assert r["control"]["wrong"] > 0
    m = r["metrics"]
    assert 0 < m["probe_search_roofline.genomes"]["value"] <= 105
    assert 0 <= m["device_idle_pct.genomes"]["value"] < 100
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    if workload == "tiny-family":
        assert 0 < m["family_group_roofline.genomes"]["value"] <= 105
