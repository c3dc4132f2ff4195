"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` names every piece; each lives in a file of its own
under this folder, so a new configuration, mix or metric is a new file and
a new entry, and no file here changes:

* a configuration is ``configs/<config>.json`` (the entry's ``file``),
  whose ``family`` names the module in ``families/`` that sets up its
  problem and its plain reference in ``reference/``: its
  ``Problem(config, mix, seed, device, group=None)`` and its
  ``tiny(config)``, the changes that make the tests' CPU twin.  A
  configuration that names a ``backend`` (``nccl``, ``gloo``) runs as a
  world of one rank a chip, its ``shards`` the cell's ``chips``
  (``world.py``); one without runs its shards stacked on one card;
* a traffic mix is ``traffic/<traffic>.json``, read by ``traffic.py``;
* a per-layer metric is ``metrics/<metric>.py``, whose ``read(ctx)``
  returns the value or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

#: the checkout's root: ``BENCHMARK.json`` and ``src/`` lie here
ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json``, with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path) -> ModuleType:
    """Import a harness file by its path (its name may hold '-' or '.')."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"workload {workload!r} not in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    (cfg,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        name=workload,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def family(cell: Cell, root: Path = ROOT) -> ModuleType:
    """The module of the configuration's problem family."""
    return load_module(root / "perfbench" / "families" / f"{cell.config['family']}.py")


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, ModuleType]:
    """The reader module of each of the cell's per-layer metrics."""
    return {m["name"]: load_module(root / "perfbench" / "metrics" / f"{m['name']}.py")
            for m in cell.per_layer}
