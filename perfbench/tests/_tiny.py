"""A copy of the benchmark with tiny cells, for runs on the CPU.

``tiny_root(path)`` copies ``BENCHMARK.json`` and the harness's files
under ``path`` and adds, for each cell, a ``tiny-`` twin: the same mix on
its configuration at a size the CPU's plain paths run in a second."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import spec

#: what each family's tiny configuration changes
TINY = {"convdiff": {"n": 16, "shards": 4}}


def tiny_root(path: Path) -> Path:
    shutil.copytree(spec.ROOT / "perfbench", path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    tiny = {}
    for c in list(bench["configs"]):
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        cfg.update(TINY[cfg["family"]])
        name = f"tiny-{c['name']}"
        rel = f"perfbench/configs/{name}.json"
        (path / rel).write_text(json.dumps(cfg))
        bench["configs"].append(dict(c, name=name, file=rel,
                                     reduced=sorted(TINY[cfg["family"]])))
        tiny[c["name"]] = name
    for w in list(bench["workloads"]):
        bench["workloads"].append(dict(w, name=f"tiny-{w['name']}", config=tiny[w["config"]]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny-{w}" for w in m["workloads"]]
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path


def cells() -> list:
    """The names of the benchmark's cells."""
    return [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
