"""A cell and its pieces, found by the names in ``BENCHMARK.json``:
``configs/<file>``, ``traffic/<traffic>.json``, ``metrics/<metric>.py``.
Adding a configuration, a traffic mix, a cell or a per-layer metric adds
files; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def reader(self, metric: str) -> Callable:
        return load_reader(metric)


def load_reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(run)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(Path(spec_path).read_text())
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    w = wl[name]
    cf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name, w["chips"], config, mix, e2e, per_layer)
