"""Finding a cell's pieces by name: the cell file, its configuration, its
traffic mix and the readers of its metrics.

* cell ``<name>``: ``workloads/<name>.json``
* configuration ``<name>``: ``configs/<name>.json``
* traffic mix ``<name>``: ``traffic/<name>.json`` (read by
  ``traffic/generator.py``)
* metric ``<name>``: ``metrics/<name>.py``, a module with
  ``read(run) -> float | None``

Which metrics a run reports comes from ``BENCHMARK.json`` at the root of
the checkout: the ``end_to_end`` entries without ``--trace``, the
``per_layer`` entries with it, each only in the cells its ``workloads``
names (every cell where it has none).
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path, what: str) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    out = _json(HERE / "workloads" / f"{name}.json", f"cell {name!r}")
    out["name"] = name
    return out


def config(name: str) -> Dict:
    out = _json(HERE / "configs" / f"{name}.json", f"configuration {name!r}")
    if out.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself "
                         f"{out.get('name')!r}")
    return out


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json", "BENCHMARK.json")


def metrics_for(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metric entries a run of ``cell_name`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


_readers: Dict[str, Callable] = {}


def reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    if name not in _readers:
        path = HERE / "metrics" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
        mod_name = "moabench_metric_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]
