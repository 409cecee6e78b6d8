"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, found at
``cytobench/configs/<config>.json``, and a traffic mix, found at
``cytobench/traffic/<traffic>.json``; the cell's own data (its comparison
limits) is ``cytobench/workloads/<cell>.json``. Each metric is read by
``cytobench/end_to_end/<name>.py`` or ``cytobench/metrics/<name>.py``, a
module with ``read(record) -> float or None``. A new configuration, mix,
cell or metric is new files and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: Path, here: Path = HERE) -> None:
        self.root, self.here = Path(root), Path(here)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({[w['name'] for w in self.bench['workloads']]})")

    def _json(self, kind: str, name: str) -> Dict:
        return json.loads((self.here / kind / f"{name}.json").read_text())

    def config(self, cell: Dict) -> Dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: Dict) -> Dict:
        return self._json("traffic", cell["traffic"])

    def limits(self, cell: Dict) -> Dict[str, float]:
        return self._json("workloads", cell["name"])["limits"]

    def metrics(self, cell: Dict, trace: bool) -> List[Dict]:
        """The cell's metrics of the run's kind: end-to-end without trace,
        per-layer with it; those with a ``workloads`` key only in its cells."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: Dict, trace: bool) -> Callable[[Dict], Optional[float]]:
        folder = "metrics" if trace else "end_to_end"
        path = self.here / folder / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"cytobench_{folder}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
