"""A copy of the benchmark with tiny cells, for runs on the CPU.

``tiny_root(path)`` copies ``BENCHMARK.json`` and the harness's files
under ``path`` and adds, for each cell, a ``tiny-`` twin: the same mix on
its configuration at a size the CPU's plain paths run in a second, as the
family's ``tiny(config)`` gives it (a world's twin runs gloo ranks on the
CPU)."""
from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

from perfbench import spec


def tiny(config: dict) -> dict:
    """What the tiny twin of ``config`` changes, from its family's module."""
    fam = spec.load_module(spec.ROOT / "perfbench" / "families" / f"{config['family']}.py")
    return fam.tiny(config)


def tiny_root(path: Path) -> Path:
    shutil.copytree(spec.ROOT / "perfbench", path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    twins = {}
    for c in list(bench["configs"]):
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        changes = tiny(cfg)
        cfg.update(changes)
        name = f"tiny-{c['name']}"
        rel = f"perfbench/configs/{name}.json"
        (path / rel).write_text(json.dumps(cfg))
        bench["configs"].append(dict(c, name=name, file=rel, reduced=sorted(changes)))
        twins[c["name"]] = name
    for w in list(bench["workloads"]):
        bench["workloads"].append(dict(w, name=f"tiny-{w['name']}", config=twins[w["config"]]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny-{w}" for w in m["workloads"]]
    (path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return path


def cells() -> list:
    """The names of the benchmark's cells."""
    return [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def digest(root: Path) -> dict:
    """A hash of every file under ``root/perfbench``, by its path."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()}
