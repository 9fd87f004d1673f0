"""A cell's files, found by name: its configuration (``configs/<config>.json``
with its plain reference beside it), its traffic mix
(``traffic/<traffic>.json``) and its load point and limits
(``cells/<workload>.json``). Nothing here imports the program."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    load: dict

    @property
    def deployment(self) -> dict:
        return self.config["deployment"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(has {[w['name'] for w in bench['workloads']]})")


def load_cell(name: str, *, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``bench_dir``."""
    bench = load_json(root / "BENCHMARK.json")
    w = find_workload(name, bench)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, chips=w["chips"],
                config=load_json(root / cfg["file"]),
                traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                load=load_json(bench_dir / "cells" / f"{name}.json"))


def load_module(path: Path, name: str):
    """A module from a file (metric readers and references are found by
    name, and their names carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: dict, bench_dir: Path = HERE):
    """The plain reference named by a configuration, from beside its file."""
    return load_module(bench_dir / "configs" / config["reference"],
                       "ooco_reference_" + Path(config["reference"]).stem)


def metric_readers(names, bench_dir: Path = HERE) -> dict:
    """``metrics/<name>.py`` for each per-layer metric name: each has a
    ``read(record) -> float | None``."""
    return {n: load_module(bench_dir / "metrics" / f"{n}.py",
                           "ooco_metric_" + n.replace(".", "_")).read
            for n in names}
