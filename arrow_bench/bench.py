"""What a run is made of, found by name: the manifest (``BENCHMARK.json``
at the root), a cell (one of its ``workloads``), the cell's configuration
(``configs/<config>.json``), its traffic mix (``mixes/<traffic>.json``),
its rate (``cells/<workload>.json``), the configuration's family on the
program (``families/<family>.py``) and plain reference
(``reference/<family>.py``), and one reader a metric
(``metrics/<metric>.py``). A later cell, mix, configuration or metric is
new files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    root: Path
    manifest: dict
    workload: dict
    conf: dict
    mix: dict
    rate: dict
    family: ModuleType
    reference: ModuleType
    bench_dir: Path = HERE

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> List[dict]:
        """The manifest's metrics this cell reports: its end-to-end ones
        without a trace, its per-layer ones with."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file (metric names hold dots, so they are loaded
    by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    root = Path(root)
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    confs = {c["name"]: c for c in manifest["configs"]}
    conf = _json(root / confs[w["config"]]["file"])
    mix = _json(bench_dir / "mixes" / f"{w['traffic']}.json")
    rate = _json(bench_dir / "cells" / f"{workload}.json")
    fam = conf["family"]
    family = load_module(bench_dir / "families" / f"{fam}.py",
                         f"arrow_bench_family_{fam}")
    reference = load_module(
        bench_dir / "reference" / f"{family.REFERENCE}.py",
        f"arrow_bench_reference_{family.REFERENCE}")
    return Cell(root, manifest, w, conf, mix, rate, family, reference,
                bench_dir)


def metric_readers(cell: Cell, trace: bool) -> Dict[str, ModuleType]:
    return {m["name"]: load_module(
        cell.bench_dir / "metrics" / f"{m['name']}.py",
        f"arrow_bench_metric_{m['name']}") for m in cell.metrics(trace)}
