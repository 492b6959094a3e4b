"""The port's narrow-field mesh solver (parallel/distributed.py) against the
JAX package's ShardedBlockLanczos, bit for bit, on CPU ranks over gloo.

One world of 8 ranks is spawned for the module (parallel/launch.py, a 120
s wall limit that kills its ranks) and runs every solve below on grids
over its first R * C ranks; the JAX solves run in this process meanwhile,
on the 8 virtual CPU devices of tests/conftest.py.

  * left_p65537_n4 on the grids (1,1), (2,1), (2,2), (1,4) and (4,2): the
    kernel equal to the golden and to JAX's on the same grid, and (v, p)
    in true row order after every iteration equal to JAX's;
  * stops after 1 and 6 iterations: (v, p) equal to JAX's at that
    iteration, the stop counted as the reference counts it;
  * right_pbig_n2 on (2,2) and left_pbig_n8_odd_dims on (4,2) (padded
    bands), each equal to JAX's on the grid and to the golden;
  * a resume on (2,1) from a JAX solver's state after 3 iterations;
  * a failed invariant on (2,2): every rank raises the reference's message;
  * a skewed matrix on (2,1), whose rows are re-balanced (a permuted band
    layout), equal to the port's single-device solve.

Tolerance zero everywhere.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from block_lanczos_tpu.models import lanczos as jl
from block_lanczos_tpu.parallel.distributed import \
    ShardedBlockLanczos as JSharded
from block_lanczos_tpu.parallel.mesh import make_mesh_grid
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.convert import state_from_numpy
from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.parallel import launch
from block_lanczos_tpu_torch.utils import mmio as tmmio

import mesh_ranks

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GRIDS = [(1, 1), (2, 1), (2, 2), (1, 4), (4, 2)]
STOPS = (1, 6)
OTHERS = {"right_pbig_n2": (1073741789, 2, True, (2, 2)),
          "left_pbig_n8_odd_dims": (1073741789, 8, False, (4, 2))}
WALL_S = 120


def _path(name):
    return os.path.join(GOLDEN, f"{name}.mtx")


def _golden_kernel(name):
    return tmmio.read_array_mtx(os.path.join(GOLDEN,
                                             f"{name}.kernel.mtx"))[2]


def _skewed():
    """A matrix whose heavy rows make the rows axis re-balance."""
    rng = np.random.default_rng(5)
    nrows, ncols, nnz = 160, 90, 1400
    i = rng.integers(0, nrows, nnz)
    i[:600] = rng.integers(0, 6, 600)            # six heavy rows
    j = rng.integers(0, ncols, nnz)
    x = rng.integers(1, 65537, nnz).astype(np.uint32)
    return nrows, ncols, i.astype(np.int32), j.astype(np.int32), x


def _jax_state():
    """The JAX single-device solver's state after 3 iterations."""
    js = jl.BlockLanczos(jmmio.load_mtx(_path("left_p65537_n4"), 65537), n=4,
                         sync_every=1)
    got = {}

    def grab(solver, iteration, v, p_blk, start):
        got.update(v=np.asarray(v), p=np.asarray(p_blk), iteration=iteration)

    js.solve(stop_after=3, on_iteration=grab)
    return got


def _tasks(jax_state):
    """The solves, ordered so that tasks on disjoint ranks run side by
    side (tests/mesh_ranks.py::solve_job)."""
    base = dict(field="narrow", matrix=_path("left_p65537_n4"), prime=65537,
                n=4)
    low, high = range(4), range(4, 8)

    def golden(grid, ranks):
        return dict(base, grid=grid, ranks=ranks, sync_every=1, capture=True)

    def other(name, ranks):
        p, n, right, g = OTHERS[name]
        return dict(field="narrow", matrix=_path(name), prime=p, n=n,
                    right=right, grid=g, ranks=ranks)

    return [golden((4, 2), range(8)),
            golden((2, 2), low), golden((1, 4), high),
            golden((2, 1), range(2)), golden((1, 1), [2]),
            dict(base, grid=(2, 2), ranks=high, sync_every=1,
                 stop_after=STOPS[0]),
            dict(base, grid=(2, 2), ranks=low, sync_every=1,
                 stop_after=STOPS[1]),
            other("right_pbig_n2", high),
            other("left_pbig_n8_odd_dims", range(8)),
            dict(base, grid=(2, 1), ranks=range(2), resume=jax_state),
            dict(field="narrow", matrix=_skewed(), prime=65537, n=4,
                 grid=(2, 1), ranks=range(2, 4)),
            dict(base, grid=(2, 2), ranks=high, skew_gram=True)]


def _jax_solve(M, n, right, grid):
    """JAX's sharded solve on `grid`, with (v, p) in true row order after
    every iteration."""
    js = JSharded(M, n=n, right=right, mesh=make_mesh_grid(*grid),
                  sync_every=1)
    iterates = []

    def grab(solver, iteration, v, p_blk, start):
        iterates.append((iteration, js.row_map.gather(np.asarray(v)),
                         js.row_map.gather(np.asarray(p_blk))))

    return js.solve(on_iteration=grab), iterates


@pytest.fixture(scope="module")
def runs():
    jax_state = _jax_state()
    tasks = _tasks(jax_state)
    with ThreadPoolExecutor(1) as pool:      # the ranks run meanwhile
        port = pool.submit(launch.spawn, mesh_ranks.solve_job, ["cpu"] * 8,
                           args=(tasks,), wall_s=WALL_S)
        M = jmmio.load_mtx(_path("left_p65537_n4"), 65537)
        jax = {g: _jax_solve(M, 4, False, g) for g in GRIDS}
        for name, (p, n, right, g) in OTHERS.items():
            jax[name] = _jax_solve(jmmio.load_mtx(_path(name), p), n, right,
                                   g)
        jax["resumed"] = jl.BlockLanczos(M, n=4).solve(
            resume_state=jax_state)
        results = port.result()[0]
    return tasks, results, jax


def _result(runs, **match):
    tasks, results, _ = runs
    found = [r for t, r in zip(tasks, results)
             if all(t.get(k) == v for k, v in match.items())]
    assert len(found) == 1, match
    return found[0]


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{r}x{c}" for r, c in GRIDS])
def test_mesh_solves_the_golden_on_every_grid(runs, grid):
    got = _result(runs, grid=grid, capture=True)
    want, _ = runs[2][grid]
    assert got["iterations"] == want.iterations == 20   # the stop probe
    assert got["v_nonzero"] and got["product_zero"]
    np.testing.assert_array_equal(got["kernel"], want.kernel)
    np.testing.assert_array_equal(got["kernel"].astype(np.int64),
                                  _golden_kernel("left_p65537_n4"))


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{r}x{c}" for r, c in GRIDS])
def test_mesh_iterates_match_jax_every_iteration(runs, grid):
    got = _result(runs, grid=grid, capture=True)["iterates"]
    _, want = runs[2][grid]
    assert [it for it, _, _ in got] == [it for it, _, _ in want]
    for (it, gv, gp), (_, wv, wp) in zip(got, want):
        np.testing.assert_array_equal(gv, wv.astype(np.int32),
                                      err_msg=f"v at {it}")
        np.testing.assert_array_equal(gp, wp.astype(np.int32),
                                      err_msg=f"p at {it}")


@pytest.mark.parametrize("k", STOPS)
def test_mesh_stop_after_matches_jax(runs, k):
    got = _result(runs, grid=(2, 2), stop_after=k)
    assert got["iterations"] == k and got["stopped_by_limit"]
    assert got["v_nonzero"] is None
    _, want = runs[2][(2, 2)]
    it, wv, _ = want[k - 1]
    assert it == k
    np.testing.assert_array_equal(got["kernel"], wv.astype(np.uint32))


@pytest.mark.parametrize("name", list(OTHERS))
def test_mesh_other_goldens(runs, name):
    got = _result(runs, matrix=_path(name))
    want, _ = runs[2][name]
    assert got["iterations"] == want.iterations
    assert got["v_nonzero"] and got["product_zero"]
    np.testing.assert_array_equal(got["kernel"], want.kernel)
    np.testing.assert_array_equal(got["kernel"].astype(np.int64),
                                  _golden_kernel(name))


def test_mesh_resumes_from_a_jax_state(runs):
    tasks, results, jax = runs
    task, got = [(t, r) for t, r in zip(tasks, results) if t.get("resume")][0]
    want = jax["resumed"]
    assert got["iterations"] == want.iterations
    np.testing.assert_array_equal(got["kernel"], want.kernel)
    np.testing.assert_array_equal(got["kernel"].astype(np.int64),
                                  _golden_kernel("left_p65537_n4"))
    # the state crosses to the port as NumPy (convert.py), as on one device
    st = state_from_numpy(task["resume"], "cpu")
    assert st["iteration"] == 3 and st["v"].shape == (120, 4)


def test_mesh_failed_invariant_raises_on_every_rank(runs):
    got = _result(runs, skew_gram=True)
    assert got["errors"] == ["vtAAv not symmetric"] * 4


def test_mesh_balances_a_skewed_matrix(runs):
    tasks, results, _ = runs
    got = [r for t, r in zip(tasks, results)
           if not isinstance(t["matrix"], str)][0]
    assert not got["row_identity"]            # a permuted band layout
    nrows, ncols, i, j, x = _skewed()
    M = tmmio.COOMatrix(nrows, ncols, len(i), i, j, x, 65537)
    want = tl.BlockLanczos(M, n=4, device="cpu").solve()
    assert got["iterations"] == want.iterations
    assert (got["v_nonzero"], got["product_zero"]) == \
        (want.v_nonzero, want.product_zero)
    np.testing.assert_array_equal(got["kernel"], want.kernel)
