"""A new configuration, traffic mix or per-layer metric is a new file
found by its name: nothing of the harness is edited to add one."""

import json
import os

from conftest import DATA, TINY_SPEC, run_tiny


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    spec = json.load(open(TINY_SPEC))
    cfg = json.load(open(os.path.join(DATA, "configs", "tiny_query.json")))
    cfg.update(name="tiny_query_b", n_keys=120_000)
    cfg_path = tmp_path / "tiny_query_b.json"
    cfg_path.write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(DATA, "traffic", "tiny.json")))
    traffic.update(name="tiny_b", clients=1, request_proteins=[3, 3])
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny_b.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "requests_completed.b.py").write_text(
        "def read(run):\n"
        "    return float(sum(1 for r in run.records if r.t_done))\n")
    spec["configs"].append({"name": "tiny_query_b", "source": "test",
                            "file": str(cfg_path), "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny-b", "config": "tiny_query_b",
                              "traffic": "tiny_b", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({
        "name": "requests_completed.b", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "server",
        "moves": "proteins_per_s", "workloads": ["tiny-b"]})
    spec_path = tmp_path / "benchmark.json"
    spec_path.write_text(json.dumps(spec))

    from kserbench.harness.spec import Spec
    s = Spec(str(spec_path), str(tmp_path))
    cell = s.cell("tiny-b")
    assert s.config(cell)["n_keys"] == 120_000
    assert s.traffic(cell)["request_proteins"] == [3, 3]
    assert [m["name"] for m in s.metrics("tiny-b", True)] == [
        "requests_completed.b"]
    r = run_tiny("tiny-b", trace=True, spec_path=str(spec_path),
                 base=str(tmp_path))
    assert r["correct"] is True
    assert r["metrics"]["requests_completed.b"]["value"] >= 1
    assert r["checks"]["compared"]["value"] % 3 == 0


def test_metrics_without_workloads_follow_the_metric_they_move():
    from kserbench.harness.spec import Spec
    s = Spec(TINY_SPEC, DATA)
    s.data["per_layer"].append({"name": "x", "unit": "ms",
                                "better": "lower", "source": "program_span",
                                "layer": "server", "moves": "setup_s"})
    for cell in ("tiny-query", "tiny-family"):
        assert "x" in [m["name"] for m in s.metrics(cell, True)]
        assert "x" not in [m["name"] for m in s.metrics(cell, False)]


def test_every_metric_of_the_benchmark_has_a_reader():
    from kserbench.harness.spec import Spec
    s = Spec()
    for m in s.data["end_to_end"] + s.data["per_layer"]:
        assert callable(s.reader(m["name"])), m["name"]
    for w in s.data["workloads"]:
        assert s.traffic(w)["clients"] > 0
        assert s.endpoint(s.config(w)["endpoint"]).PATH


def test_a_suffixed_metric_falls_back_to_its_unsuffixed_reader(tmp_path):
    from kserbench.harness.spec import Spec
    s = Spec(TINY_SPEC, str(tmp_path))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "twice.py").write_text(
        "def read(run):\n    return 1.0\n")
    (tmp_path / "metrics" / "twice.small.py").write_text(
        "def read(run):\n    return 2.0\n")
    assert s.reader("twice.genomes")(None) == 1.0
    assert s.reader("twice.small")(None) == 2.0
    assert s.reader("device_idle_pct.small") is not None
    try:
        s.reader("no_such_metric.genomes")
    except FileNotFoundError:
        pass
    else:
        raise AssertionError("a metric with no reader was found")
