"""No module of the benchmark imports JAX or the JAX package; names are
compared whole at the top level, since the program's name
(block_lanczos_tpu_torch) begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FILES = sorted(HERE.rglob("*.py"))


def _imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_forbidden_import(path):
    assert not _imported(path) & set(run.FORBIDDEN)


def test_names_compare_whole():
    assert "block_lanczos_tpu_torch" not in run.FORBIDDEN
    assert _imported(HERE / "harness.py") >= {"portbench", "torch"}
    # a module of the program's name does not match the JAX package's
    sys.modules.setdefault("block_lanczos_tpu_torch", sys)
    assert "block_lanczos_tpu" not in run.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """Loading the harness, its metric readers and the program's solvers
    in a fresh process pulls in no JAX (the run checks the same after its
    window)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, spec, run, control\n"
        "import json\n"
        "b = json.load(open(%r))\n"
        "for m in b['end_to_end'] + b['per_layer']: spec.reader(m['name'])\n"
        "for c in b['configs']:\n"
        "    conf = json.load(open(%r + '/' + c['file']))\n"
        "    harness._load_class(conf['solver'])\n"
        "    harness._load_class(conf['mesh_solver'])\n"
        "print(run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "BENCHMARK.json"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_without_the_program_a_run_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dlp240-p30-n4",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
