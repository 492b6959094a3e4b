"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, traffic mix and metric it names has its file."""

import json
import re
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    for w in BENCH["command"][1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


def test_counts_and_chips():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert sum(c == 4 for c in chips) <= max(1, len(chips) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            reported = {e["name"] for e in spec.load(w).end_to_end}
            assert m["moves"] in reported, (m["name"], w)


def test_every_metric_has_a_reader_of_its_own():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in ("prime", "nrows", "ncols", "row_draws", "value_low",
                "value_high", "solver", "mesh_solver", "guarantee",
                "published", "assumed"):
        assert key in conf, key
    # every key cut from the published deployment is listed
    for key, value in conf["published"].items():
        if isinstance(value, int) and key in conf and conf[key] != value:
            assert key in entry["reduced"], key
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    assert TEXT.match(w["why"])
    cell = spec.load(w["name"])
    assert cell.traffic["name"] == w["traffic"]
    assert int(cell.traffic["n"]) >= 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_traffic_and_config_file_parses():
    for sub in ("traffic", "configs"):
        for path in (ROOT / "portbench" / sub).glob("*"):
            assert path.suffix == ".json", path
            assert json.loads(path.read_text())["name"] == path.stem


def test_every_file_name_is_a_name():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
