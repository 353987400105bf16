"""A cell of ``BENCHMARK.json``, found by name: its entry, its
configuration file, its traffic mix and the driver that the mix names."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = ROOT / "BENCHMARK.json"
TRAFFIC = Path(__file__).resolve().parent / "traffic"


def manifest() -> Dict[str, Any]:
    return json.loads(MANIFEST.read_text())


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of the manifest: a deployment under a traffic mix."""

    name: str
    chips: int
    config: Dict[str, Any]      # the configuration file
    traffic: Dict[str, Any]     # the traffic file
    per_layer: List[str]        # per-layer metrics this cell reports
    end_to_end: List[str]       # end-to-end metrics this cell reports

    @property
    def driver(self):
        """The module that runs the cell, ``drivers/<driver>.py``, named
        by the traffic mix's ``driver``."""
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def _reports(metric: Dict[str, Any], name: str) -> bool:
    return name in metric.get("workloads", [name])


def cell(name: str, bench: Dict[str, Any] = None) -> Cell:
    """The manifest's workload `name` with its files."""
    bench = manifest() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((TRAFFIC / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                per_layer=[m["name"] for m in bench["per_layer"]
                           if _reports(m, name)],
                end_to_end=[m["name"] for m in bench["end_to_end"]
                            if _reports(m, name)])
