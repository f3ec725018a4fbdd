"""Finding what a cell needs by name: ``BENCHMARK.json`` names the cell,
its configuration (whose ``file`` holds it) and its traffic; the traffic
mix is ``traffic/<name>.json``, each metric's reader ``metrics/<name>.py``
and each endpoint ``endpoints/<name>.py``.  Nothing here lists a cell, a
configuration, a traffic mix or a metric: a new one is a new file and a
new entry."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)


class Spec:
    """``BENCHMARK.json`` (or ``path``) with its data looked up first in
    ``base`` and then in this package."""

    def __init__(self, path: str | None = None, base: str | None = None):
        self.path = path or os.path.join(REPO, "BENCHMARK.json")
        with open(self.path) as f:
            self.data = json.load(f)
        self.dirs = [d for d in (base, PKG) if d]

    def _find(self, kind: str, name: str, ext: str) -> str:
        for d in self.dirs:
            p = os.path.join(d, kind, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} in {self.dirs}")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                with open(os.path.join(REPO, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {cell['config']!r} in {self.path}")

    def traffic(self, cell: dict) -> dict:
        with open(self._find("traffic", cell["traffic"], ".json")) as f:
            return json.load(f)

    @staticmethod
    def endpoint(name: str):
        return importlib.import_module(f"kserbench.endpoints.{name}")

    def metrics(self, cell_name: str, trace: bool) -> list:
        """The metrics a run of the cell reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones; a metric without a
        ``workloads`` list counts in every cell that reports the
        end-to-end metric it moves."""
        e2e = [m for m in self.data["end_to_end"]
               if cell_name in m.get("workloads", [cell_name])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell_name in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in names)]

    def reader(self, name: str):
        """The ``read(run)`` function of ``metrics/<name>.py``, or, where
        there is none, of the file named without the traffic suffix
        (``device_idle_pct.py`` for ``device_idle_pct.small``): one
        quantity that reads alike in every traffic is one file."""
        try:
            path = self._find("metrics", name, ".py")
        except FileNotFoundError:
            if "." not in name:
                raise
            path = self._find("metrics", name.rsplit(".", 1)[0], ".py")
        spec = importlib.util.spec_from_file_location(
            f"kserbench_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
