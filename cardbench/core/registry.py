"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its own
settings (``cells/<name>.json``: the offered rate of an open loop, the
correctness limits) and a reader for every metric it reports
(``metrics/<name>.py``, a module with ``read(record)``; a metric
``<name>.<mix>`` that has no file of its own is read by
``metrics/<name>.py``) and the family of its configuration
(``families/<model_type>.py``, by the file's published ``model_type``).
Adding a cell, a mix, a metric or a block adds files and entries; no file
here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list        # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    """A metric with no `workloads` is read in every cell; its reader
    returns None where it finds nothing."""
    return cell in metric.get("workloads", (cell,))


def cell(name: str, bench_dir: Path = BENCH_DIR,
         root: Path | None = None) -> Cell:
    root = bench_dir.parent if root is None else root
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=load_json(bench_dir / "traffic"
                                  / f"{w['traffic']}.json"),
                settings=load_json(bench_dir / "cells" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader_file(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    """``metrics/<metric>.py``, or for ``<name>.<mix>`` with no file of its
    own ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = bench_dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return path


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "cardbench_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The `read` function of the metric's file (`reader_file`)."""
    return _load(reader_file(metric, bench_dir), "metric_" + metric).read


def family(cfg: dict, bench_dir: Path = BENCH_DIR):
    """The module of the configuration's family, ``families/<model_type>.py``
    (its interface: ``families/__init__.py``)."""
    mt = cfg["model_type"]
    path = bench_dir / "families" / f"{mt}.py"
    if mt.startswith("_") or not path.is_file():
        known = sorted(f.stem for f in path.parent.glob("[!_]*.py"))
        raise KeyError(f"no family for model_type {mt!r}; there are {known}")
    return _load(path, "family_" + mt)
