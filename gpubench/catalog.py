"""Finds what a run needs by the names in ``BENCHMARK.json``.

Nothing here lists a configuration, a traffic mix or a metric: each is a
file of its own, found by its name.

  configuration   the ``file`` of its ``configs`` entry (JSON); its
                  ``driver`` names ``gpubench/drivers/<driver>.py``
  traffic mix     ``gpubench/traffic/<traffic>.json``
  metric reader   ``gpubench/metrics/<metric>.py``, a ``read(trace)``
                  that returns a number, or None where it finds nothing
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        known = ", ".join(e["name"] for e in self.data[key])
        raise KeyError(f"no {key} entry named {name!r}; known: {known}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "gpubench" / "traffic"
                           / f"{name}.json").read_text())

    def metrics(self, kind: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that the cell
        reports: those without a ``workloads`` list, and those whose list
        names it."""
        return [m for m in self.data[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read`` function of ``gpubench/metrics/<metric>.py``."""
        path = self.root / "gpubench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"gpubench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def driver(name: str):
    """The ``Driver`` class of ``gpubench/drivers/<name>.py``."""
    return importlib.import_module(f"gpubench.drivers.{name}").Driver
