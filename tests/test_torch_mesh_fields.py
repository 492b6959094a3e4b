"""The port's GF(2) and wide-field mesh solvers against the JAX package's,
bit for bit, and the CLI's mesh forms, on CPU ranks over gloo.

  * GF(2) (left_p2_n32) and the wide field (a 2^61 - 1 instance built as
    tests/test_torch_wide_solver.py builds it) on a 2 x 2 grid of 4 ranks,
    and GF(2) again on a 4 x 1 grid (an axis of 4: 4-bit lanes), spawned
    once for the module: the kernel and (v, p) after every iteration equal
    to the JAX package's ShardedBlockLanczosGF2 / ShardedBlockLanczosWide
    on a mesh of the same shape, which run in this process meanwhile;
    GF(2)'s kernel equal to the golden; the GF(2) step's all-reduces are
    its workspace's bound forms (collectives.Pxor) alone, three an
    iteration;
  * the CLI (twins of tests/test_multihost.py's two-process runs):
    `--device cpu --grid 2 2` and two processes of `--local-devices 2`
    meeting at a file rendezvous write the goldens byte for byte;
    `--devices 2` at the wide prime writes the one-device CLI's file;
    `--device cuda --devices 2` on a host without two cards exits 2.

Tolerance zero everywhere.  Every spawn has a wall limit (120 s for the
module's ranks, 150 s for a CLI process group) that kills its ranks.
"""

import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.parallel.distributed_gf2 import \
    ShardedBlockLanczosGF2 as JGF2
from block_lanczos_tpu.parallel.distributed_wide import \
    ShardedBlockLanczosWide as JWide
from block_lanczos_tpu.parallel.mesh import make_mesh_grid
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.parallel import launch
from block_lanczos_tpu_torch.utils import cli

import mesh_ranks

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GF2 = os.path.join(GOLDEN, "left_p2_n32.mtx")
WALL_S = 120
CLI_WALL_S = 150
P61 = (1 << 61) - 1


def write_matrix(path, p, nrows, ncols, density, seed):
    """A sparse matrix file with values over the full wide range, some of
    them negative or above p (tests/test_torch_wide_solver.py's)."""
    from block_lanczos_tpu_torch.utils import gen
    rng = np.random.default_rng(seed)
    i, j, _ = gen.random_sparse(nrows, ncols, density, seed=seed)
    x = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, len(i))]
    x[0], x[1] = -1, p + 5
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{nrows} {ncols} {len(x)}\n")
        for a, b, c in zip(i, j, x):
            fh.write(f"{a + 1} {b + 1} {c}\n")
    return path


def _golden_bytes(name):
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        return fh.read()


def _jax_solve(cls, M, n, as_port, grid=(2, 2)):
    """JAX's sharded solve on an R x C mesh (`grid`), with (v, p) in true
    row order after every iteration, in the port's representation
    (as_port)."""
    js = cls(M, n=n, mesh=make_mesh_grid(*grid), sync_every=1)
    iterates = []

    def grab(solver, iteration, v, p_blk, start):
        iterates.append((iteration,
                         as_port(js.row_map.gather(np.asarray(v))),
                         as_port(js.row_map.gather(np.asarray(p_blk)))))

    return js.solve(on_iteration=grab), iterates


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    wide_mtx = write_matrix(str(tmp_path_factory.mktemp("mesh_wide") /
                                "m.mtx"), P61, 96, 64, 5, seed=7)
    tasks = [dict(field="gf2", matrix=GF2, prime=2, n=32, grid=(2, 2),
                  sync_every=1, capture=True, count_bound=True),
             dict(field="wide", matrix=wide_mtx, prime=P61, n=4, grid=(2, 2),
                  sync_every=1, capture=True),
             dict(field="gf2", matrix=GF2, prime=2, n=32, grid=(4, 1),
                  sync_every=1, capture=True, count_bound=True)]
    with ThreadPoolExecutor(1) as pool:      # the ranks run meanwhile
        port = pool.submit(launch.spawn, mesh_ranks.solve_job, ["cpu"] * 4,
                           args=(tasks,), wall_s=WALL_S)
        words = lambda w: w.view(np.int32)  # noqa: E731
        jax = {"gf2": _jax_solve(JGF2, jmmio.load_mtx(GF2, 2), 32, words),
               "wide": _jax_solve(JWide, jmmio.load_mtx(wide_mtx, P61), 4,
                                  lambda a: jgw.np_unpair(a).astype(
                                      np.int64)),
               "gf2-4x1": _jax_solve(JGF2, jmmio.load_mtx(GF2, 2), 32, words,
                                     grid=(4, 1))}
        gf2, wide, gf2_4x1 = port.result()[0]
    return {"gf2": gf2, "wide": wide, "gf2-4x1": gf2_4x1}, jax, wide_mtx


FIELDS = ["gf2", "wide", "gf2-4x1"]


@pytest.mark.parametrize("field", FIELDS)
def test_mesh_field_matches_jax(runs, field):
    got = runs[0][field]
    want, _ = runs[1][field]
    assert got["iterations"] == want.iterations
    assert (got["v_nonzero"], got["product_zero"]) == \
        (want.v_nonzero, want.product_zero)
    assert got["v_nonzero"] and got["product_zero"]
    np.testing.assert_array_equal(got["kernel"], want.kernel)
    if field.startswith("gf2"):
        ref = jmmio.read_array_mtx(os.path.join(GOLDEN,
                                                "left_p2_n32.kernel.mtx"))[2]
        np.testing.assert_array_equal(got["kernel"].astype(np.int64), ref)


@pytest.mark.parametrize("field", FIELDS)
def test_mesh_field_iterates_match_jax(runs, field):
    got = runs[0][field]["iterates"]
    _, want = runs[1][field]
    assert [it for it, _, _ in got] == [it for it, _, _ in want]
    for (it, gv, gp), (_, wv, wp) in zip(got, want):
        np.testing.assert_array_equal(gv, wv, err_msg=f"v at {it}")
        np.testing.assert_array_equal(gp, wp, err_msg=f"p at {it}")


@pytest.mark.parametrize("field", ["gf2", "gf2-4x1"])
def test_gf2_mesh_step_runs_the_bound_pxor(runs, field):
    """The GF(2) step reaches K3 only through its workspace's three
    collectives.Pxor (tmp, Av, the Grams): no sum reached the transport
    but theirs during the solve, and they ran three times a step."""
    got = runs[0][field]
    calls = got["bound_calls"]
    assert set(calls) == {"Pxor"}, calls
    assert calls["Pxor"] % 3 == 0
    assert calls["Pxor"] >= 3 * got["iterations"], (calls, got["iterations"])


def _start_cli(args):
    """The port's CLI in a process group of its own (it and its ranks)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "block_lanczos_tpu_torch.utils.cli", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _finish(procs):
    """Wait for every CLI process, killing every group at the wall limit;
    returns their outputs."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=CLI_WALL_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out
    return outs


def test_cli_grid_writes_the_golden(tmp_path):
    out = tmp_path / "k.mtx"
    _finish([_start_cli(["--matrix", os.path.join(GOLDEN,
                                                  "left_p65537_n4.mtx"),
                         "--prime", "65537", "--n", "4", "--device", "cpu",
                         "--grid", "2", "2", "--output-file", str(out)])])
    assert out.read_bytes() == _golden_bytes("left_p65537_n4")


def test_cli_two_processes_write_the_golden(tmp_path):
    """2 processes x 2 local ranks, one world of 4 (--devices 4: a 4 x 1
    grid), meeting at a file rendezvous; process 0's rank 0 writes."""
    out = tmp_path / "k.mtx"
    common = ["--matrix", GF2, "--prime", "2", "--n", "32", "--device",
              "cpu", "--coordinator", f"file://{tmp_path / 'rendezvous'}",
              "--num-processes", "2", "--local-devices", "2", "--devices",
              "4", "--output-file", str(out)]
    outs = _finish([_start_cli(common + ["--process-id", str(k)])
                    for k in range(2)])
    assert "sharded 4x1" in outs[0] and "sharded" not in outs[1]
    assert out.read_bytes() == _golden_bytes("left_p2_n32")


def test_cli_devices_at_a_wide_prime_writes_the_one_device_file(runs,
                                                               tmp_path):
    wide_mtx = runs[2]
    one, two = tmp_path / "one.mtx", tmp_path / "two.mtx"
    args = ["--matrix", wide_mtx, "--prime", str(P61), "--n", "4",
            "--device", "cpu"]
    assert cli.main(args + ["--output-file", str(one)]) == 0
    _finish([_start_cli(args + ["--devices", "2", "--output-file",
                                str(two)])])
    assert two.read_bytes() == one.read_bytes()


def test_cli_cuda_devices_beyond_the_cards_exit_2(tmp_path, capsys):
    """The refusal comes before the matrix is loaded (it does not exist)."""
    have = torch.cuda.device_count()
    if have >= 2:
        pytest.skip("this host has two CUDA devices")
    rc = cli.main(["--matrix", str(tmp_path / "absent.mtx"), "--prime",
                   "65537", "--n", "4", "--device", "cuda", "--devices", "2"])
    assert rc == 2
    assert f"torch.cuda.device_count() = {have}" in capsys.readouterr().err
