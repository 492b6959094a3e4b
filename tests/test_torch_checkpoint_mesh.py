"""Checkpoints of the port's mesh: CPU ranks over gloo (one spawned world
of 4 for every grid case of this file, tests/mesh_ranks.py::
checkpoint_job, with a wall limit), tolerance zero.

  * for each field, a checkpoint saved on a 2 x 2 grid (every rank gathers
    v and p whole, the root writes the JAX package's plain format) resumes
    bit-exactly on a 4 x 1 grid and, through the CLI, with --single: the
    uninterrupted kernel, the uninterrupted file byte for byte;
  * the due-check is the root's: when only the root requests a save, every
    rank saves at the same iteration and learns the root's signal; when
    only the other ranks request one, no rank saves;
  * the twin of tests/test_skewed_sharded.py::
    test_skewed_checkpoint_cross_layout_resume: a power-law matrix whose
    4 x 1 grid has a permuted (non-identity) row map saves there, and the
    checkpoint resumes bit-exactly in BlockLanczos and on a 2 x 2 grid;
  * the mesh CLI preempted: `--grid 2 2 --checkpoint 0 --sync-every 1`,
    SIGTERM to the parent process after the first save line; every rank
    saves and the CLI exits 143 (no rank failure); a --load-checkpoint run
    then writes a kernel the checker accepts.
"""

import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from block_lanczos_tpu_torch import convert
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.parallel import launch
from block_lanczos_tpu_torch.utils import checker
from block_lanczos_tpu_torch.utils import checkpoint as ckpt
from block_lanczos_tpu_torch.utils import cli, gen, mmio

import mesh_ranks

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = os.path.join(GOLDEN, "left_p65537_n4.mtx")
P55 = 36028797018963913
PRIME = 1073741789
WALL_S = 150
CLI_WALL_S = 150


def _skewed():
    """Power-law row weights (the JAX skew test's shape, smaller): the
    left kernel's rows are the heavy dimension."""
    nrows, ncols = 400, 300
    i, j, x = gen.random_sparse_skewed(ncols, nrows, 6, seed=11, alpha=1.2)
    order = np.lexsort((i, j))
    return (nrows, ncols, j[order].astype(np.int32),
            i[order].astype(np.int32),
            (x[order] % PRIME).astype(np.uint32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    wide = str(tmp / "mw.mtx")
    gen.write_random_mtx(wide, 96, 64, 5, seed=7)
    fields = {"narrow": (NARROW, 65537, 4, 7),
              "gf2": (os.path.join(GOLDEN, "left_p2_n32.mtx"), 2, 32, 2),
              "wide": (wide, P55, 4, 5)}
    tasks, index = [], {}
    for field, (mtx, prime, n, k) in fields.items():
        common = dict(field=field, matrix=mtx, prime=prime, n=n)
        d = str(tmp / f"{field}_ck")
        index[field] = len(tasks)
        tasks += [dict(common, grid=(2, 2), stop_after=k, save=dict(dir=d)),
                  dict(common, grid=(4, 1), resume=d)]
    narrow = dict(field="narrow", matrix=NARROW, prime=65537, n=4)
    index["root"] = len(tasks)
    tasks += [dict(narrow, grid=(2, 2), save=dict(
        dir=str(tmp / "root_ck"), interval=3600.0, request=(1, "root"))),
              dict(narrow, grid=(2, 2), save=dict(
                  dir=str(tmp / "other_ck"), interval=3600.0,
                  request=(1, "other")))]
    skew = dict(field="narrow", matrix=_skewed(), prime=PRIME, n=4)
    index["skew"] = len(tasks)
    tasks += [dict(skew, grid=(4, 1), stop_after=3,
                   save=dict(dir=str(tmp / "skew_ck"))),
              dict(skew, grid=(2, 2), stop_after=6,
                   resume=str(tmp / "skew_ck"))]
    out, world_view = launch.spawn(mesh_ranks.checkpoint_job, ["cpu"] * 4,
                                   args=(tasks,), wall_s=WALL_S)[0]
    return out, index, fields, tmp, world_view


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_mesh_checkpoint_resumes_on_another_grid_and_single(
        world, field, tmp_path):
    out, index, fields, tmp, _ = world
    mtx, prime, n, k = fields[field]
    saved, resumed = out[index[field]], out[index[field] + 1]
    # every rank saved at every iteration up to k (interval 0), in step
    assert [r[0] for r in saved["ranks"]] == [list(range(1, k + 1))] * 4
    d = str(tmp / f"{field}_ck")
    state = ckpt.load_checkpoint(d)
    assert state["iteration"] == k and "rowmap" not in state
    assert state["v"].dtype == np.uint32
    base = ["--matrix", mtx, "--prime", str(prime), "--n", str(n),
            "--device", "cpu"]
    full, res = str(tmp_path / "full.mtx"), str(tmp_path / "res.mtx")
    assert cli.main([*base, "--output-file", full]) == 0
    assert cli.main([*base, "--single", "--load-checkpoint",
                     "--checkpoint-dir", d, "--output-file", res]) == 0
    with open(full, "rb") as a, open(res, "rb") as b:
        assert a.read() == b.read()
    _, _, want = mmio.read_array_mtx(full)
    np.testing.assert_array_equal(resumed["kernel"].astype(np.int64), want)


def test_root_request_keeps_ranks_in_lockstep(world):
    """Only the root asks (interval 3600 s: no timer save): all four ranks
    save at iteration 1 and end with the root's SIGTERM; the solve then
    runs on to the uninterrupted kernel.  Only the other ranks ask: no
    rank saves."""
    out, index, _, tmp, _ = world
    root, other = out[index["root"]], out[index["root"] + 1]
    assert root["ranks"] == [([1], signal.SIGTERM)] * 4
    assert ckpt.load_checkpoint(str(tmp / "root_ck"))["iteration"] == 1
    assert other["ranks"] == [([], None)] * 4
    assert not os.path.exists(str(tmp / "other_ck"))
    want = BlockLanczos(mmio.load_mtx(NARROW, 65537), n=4,
                        device="cpu").solve()
    for res in (root, other):
        assert res["iterations"] == want.iterations
        np.testing.assert_array_equal(res["kernel"], want.kernel)


def test_skewed_checkpoint_cross_layout_resume(world):
    """Saved on the 4 x 1 grid, whose row map is permuted (the file holds
    true row order, no rowmap); resumed in BlockLanczos and on the 2 x 2
    grid (permuted too), both equal to the straight solve after 6."""
    out, index, _, tmp, _ = world
    saved, resumed = out[index["skew"]], out[index["skew"] + 1]
    assert not saved["row_identity"] and not resumed["row_identity"]
    state = ckpt.load_checkpoint(str(tmp / "skew_ck"))
    assert state["iteration"] == 3 and "rowmap" not in state
    nrows, ncols, i, j, x = _skewed()
    M = mmio.COOMatrix(nrows, ncols, len(x), i, j, x, PRIME)
    straight = BlockLanczos(M, n=4, device="cpu").solve(stop_after=6)
    single = BlockLanczos(M, n=4, device="cpu").solve(
        stop_after=6, resume_state=convert.FROM_NUMPY["narrow"](state, "cpu"))
    np.testing.assert_array_equal(single.kernel, straight.kernel)
    np.testing.assert_array_equal(resumed["kernel"], straight.kernel)
    assert resumed["iterations"] == straight.iterations == 6


def test_mesh_cli_sigterm_saves_exits_143_and_resumes(tmp_path):
    """The signal goes to the CLI's own process once the first save line
    is out (not after a sleep): the parent passes it to its ranks, which
    save at the next due-check and all return 143."""
    mtx = str(tmp_path / "m.mtx")
    gen.write_random_mtx(mtx, 2000, 1500, 8, seed=7)   # ~375 iterations
    ckdir = str(tmp_path / "ck")
    base = ["--matrix", mtx, "--prime", "65537", "--n", "4", "--device",
            "cpu", "--checkpoint-dir", ckdir]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "block_lanczos_tpu_torch.utils.cli", *base,
         "--grid", "2", "2", "--checkpoint", "0", "--sync-every", "1",
         "--output-file", str(tmp_path / "k.mtx")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)

    sent = []

    def run():
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if not sent and ">> checkpoint at iteration" in line:
                proc.send_signal(signal.SIGTERM)
                sent.append(line)
        return "".join(lines), proc.wait()

    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(run)
        try:
            out, rc = job.result(timeout=CLI_WALL_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
    assert sent, out[-2000:]
    assert rc == 128 + signal.SIGTERM, out[-2000:]
    assert "Received signal 15; state checkpointed" in out
    assert "the mesh failed" not in out
    state = ckpt.load_checkpoint(ckdir)
    assert 0 < state["iteration"] < 300
    kfile = str(tmp_path / "k2.mtx")
    assert cli.main([*base, "--load-checkpoint", "--output-file",
                     kfile]) == 0
    assert checker.check_kernel_file(mtx, kfile, 65537) is True


def test_multihost_root_and_count(world):
    """Rank 0 of a world of 4 is its root, every rank counts 4; a process
    without a world is a root of 1."""
    from block_lanczos_tpu_torch.parallel import multihost
    assert world[4] == [(True, 4)] + [(False, 4)] * 3
    assert multihost.is_root() and multihost.process_count() == 1
