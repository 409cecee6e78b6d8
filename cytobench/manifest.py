"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, found at
``cytobench/configs/<config>.json``, and a traffic mix, found at
``cytobench/traffic/<traffic>.json``; the cell's own data (its comparison
limits) is ``cytobench/workloads/<cell>.json``. Each metric is read by
``cytobench/end_to_end/<name>.py`` or ``cytobench/metrics/<name>.py``, a
module with ``read(record) -> float or None``. Each configuration names its
model family (key ``family``): ``cytobench/families/<family>.py``, a module
of plain functions that hold everything that reads the model's side of a
configuration (the weight tree, the port's pipeline, the encoder's class
and operations, the reference's embedding and crops). A new configuration,
mix, cell, metric or model family is new files and new entries in
``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
_FAMILIES: Dict[Path, ModuleType] = {}


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: Dict) -> ModuleType:
    """The module of the configuration's model family,
    ``families/<family>.py`` in the folder that :meth:`Manifest.config`
    noted under ``family_dir`` (this benchmark's by default). Loaded once a
    process, as an import is."""
    if "family" not in cfg:
        raise KeyError(f"the configuration {cfg.get('name')!r} names no model family: give it "
                       f"the key \"family\", the name of a module in cytobench/families/")
    path = Path(cfg.get("family_dir", HERE / "families")) / f"{cfg['family']}.py"
    if path not in _FAMILIES:
        _FAMILIES[path] = _load(path, f"cytobench_families_{path.stem}")
    return _FAMILIES[path]


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
        """The cell's configuration, with ``family_dir``: where its family
        is found. One that names no family is refused here."""
        entry = next(c for c in self.bench["configs"] if c["name"] == cell["config"])
        cfg = dict(json.loads((self.root / entry["file"]).read_text()),
                   family_dir=str(self.here / "families"))
        family(cfg)
        return cfg

    def family(self, cfg: Dict) -> ModuleType:
        """The module of the configuration's model family in this benchmark."""
        return family(dict(cfg, family_dir=str(self.here / "families")))

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
        return _load(path, f"cytobench_{folder}_{path.stem}").read
