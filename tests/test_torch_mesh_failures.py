"""A failing mesh: parallel/launch.py::spawn and the CLI's mesh path.

  * spawn raises RankFailed when a rank raises, when a rank exits non-zero
    and when the mesh outlives its wall limit (each spawned world with its
    own `wall_s`; the ranks are killed);
  * the CLI's mesh (`--grid`, gloo ranks on the CPU) exits 1 with no Python
    traceback when the matrix is missing ("cannot load matrix ..." on
    stderr) and when `--salvage` finds no vector (p = 3, n = 2 on a 1 x 2
    grid; p = 2, n = 1 with `--salvage-restarts 2` on a 2 x 1 grid), as
    the JAX package's CLI exits 1 on the same inputs.

The CLI runs are processes of their own, started together and killed at
their wall limit.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils.gen import write_random_mtx
from block_lanczos_tpu_torch.parallel import launch

import mesh_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 60
CLI_WALL_S = 120


@pytest.mark.parametrize("job,message", [
    (mesh_ranks.raising_job, "rank 1 raised on purpose"),
    (mesh_ranks.exiting_job, "exit code 3"),
], ids=["raises", "exits"])
def test_spawn_raises_rank_failed(job, message):
    with pytest.raises(launch.RankFailed, match=message):
        launch.spawn(job, ["cpu"] * 2, wall_s=WALL_S)


def test_spawn_wall_limit_raises_rank_failed():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="outlived its 3 s limit"):
        launch.spawn(mesh_ranks.sleeping_job, ["cpu"] * 2, wall_s=3)
    assert time.monotonic() - t0 < 20


# (id, both CLIs' arguments past --matrix, the port's grid)
SALVAGE = [
    ("salvage-p3-n2", ["--prime", "3", "--n", "2", "--salvage"], (1, 2)),
    ("salvage-restarts-p2-n1", ["--prime", "2", "--n", "1", "--salvage",
                                "--salvage-restarts", "2", "--no-checks"],
     (2, 1)),
]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Every failing mesh CLI run, started together: ({id: (rc, stdout,
    stderr)}, the matrix, the directory)."""
    tmp = tmp_path_factory.mktemp("mesh_failures")
    mtx = str(tmp / "m.mtx")
    write_random_mtx(mtx, 48, 32, 4, seed=7)   # breaks down at p = 2, 3
    runs = {"missing-matrix": [
        "--matrix", str(tmp / "absent.mtx"), "--prime", "65537", "--n", "4",
        "--grid", "2", "1"]}
    for name, extra, (R, C) in SALVAGE:
        runs[name] = ["--matrix", mtx, *extra, "--grid", str(R), str(C),
                      "--output-file", str(tmp / f"{name}.mtx")]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "block_lanczos_tpu_torch.utils.cli", *argv,
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for name, argv in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=CLI_WALL_S)
            out[name] = (proc.returncode, so, se)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return out, mtx, tmp


def test_mesh_cli_missing_matrix_exits_1(cli_runs):
    rc, _, err = cli_runs[0]["missing-matrix"]
    assert rc == 1, err
    assert "cannot load matrix" in err and "absent.mtx" in err
    assert "Traceback" not in err


@pytest.mark.parametrize("name,extra,grid", SALVAGE,
                         ids=[s[0] for s in SALVAGE])
def test_mesh_cli_empty_salvage_exits_1(cli_runs, tmp_path, name, extra,
                                        grid):
    rc, out, err = cli_runs[0][name]
    assert rc == 1, err
    assert "Salvage found no kernel vectors" in err
    assert "Traceback" not in err + out
    assert not os.path.exists(cli_runs[2] / f"{name}.mtx")   # nothing
    # the JAX package's CLI exits 1 on the same input
    assert jcli.main(["--matrix", cli_runs[1], *extra, "--single",
                      "--output-file", str(tmp_path / "k.mtx")]) == 1
