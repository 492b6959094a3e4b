"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root
pairs a configuration (configs/<name>.json, the entry's `file`) with a
traffic mix (traffic/<name>.json); each metric is read by
metrics/<name>.py, whose `read(record)` returns its value or None."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list       # BENCHMARK.json's entries that apply here
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reader(name: str):
    """metrics/<name>.py's `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, record) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
