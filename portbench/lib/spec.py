"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cells, configurations and metrics; each piece is a file of
its own under ``portbench/`` (``configs/<config>.json``,
``traffic/<mix>.json`` and the ``generators/<name>.py`` it names,
``entries/<entry>.py``, ``metrics/<metric>.py``), so a later change adds a
cell, a mix or a metric by adding files."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                              # the checkout
_SAFE = re.compile(r"[^A-Za-z0-9_]")


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import one file by its path (names may hold dots and dashes)."""
    name = f"portbench_{prefix}_{_SAFE.sub('_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    entry and metric readers."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = json.loads((self.root / entry["file"]).read_text())
        here = self.root / "portbench"
        self.traffic = json.loads(
            (here / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.entry = load_module(here / "entries" / f"{self.config['entry']}.py", "entry")
        self.metrics: Dict[str, List[dict]] = {
            "end_to_end": self._metrics(bench["end_to_end"]),
            "per_layer": self._metrics(bench["per_layer"]),
        }
        self.readers = {
            m["name"]: load_module(here / "metrics" / f"{m['name']}.py", "metric")
            for ms in self.metrics.values() for m in ms
        }

    def _metrics(self, metrics: List[dict]) -> List[dict]:
        name = self.workload["name"]
        return [m for m in metrics if name in m.get("workloads", [name])]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])
