"""The port's comm/compute overlap (overlap=True, the CLI's --overlap) in
the three mesh solvers, against the JAX package's overlap solvers, bit
for bit, on CPU ranks over gloo.

One world of 8 ranks is spawned for the module (parallel/launch.py, a 300
s wall limit that kills its ranks); the JAX solves run in this process
meanwhile, on the 8 virtual CPU devices of tests/conftest.py.

  * twins of tests/test_sharded.py's overlap tests: left_p65537_n4 on
    rows-only grids of 2 and 8, left_pbig_n4 on 2 x 4 (the narrow field),
    left_p2_n32 (GF(2)) and left_pbig_n4 at 2^61 - 1 (the wide field) on
    8 x 1 and 2 x 4: kernel and iterations equal to the JAX overlap
    solver's on the same grid and to the golden; on 2 x 4, (v, p) in true
    row order after every iteration equal to JAX's;
  * a twin of tests/test_skewed_sharded.py::test_skewed_overlap_parity
    (the overlap partition keeps the balanced band maps);
  * odd bands split at pad_multiple = 1 (chunks at any row offset);
  * bands too small to split: the JAX package's ValueError on every rank;
  * the CLI's solve as the ranks of a 2 x 2 grid: `--overlap` in each
    field writes the golden (the wide field: the JAX CLI's `--overlap
    --devices 8` file), and a mesh checkpoint resumes across the flag
    (saved without, resumed with, and the other way round) to the golden
    (`--overlap` alone, one gloo rank: tests/test_torch_cli.py).

Tolerance zero everywhere.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from block_lanczos_tpu.models.lanczos import BlockLanczos as JSingle
from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.parallel.distributed import \
    ShardedBlockLanczos as JNarrow
from block_lanczos_tpu.parallel.distributed_gf2 import \
    ShardedBlockLanczosGF2 as JGF2
from block_lanczos_tpu.parallel.distributed_wide import \
    ShardedBlockLanczosWide as JWide
from block_lanczos_tpu.parallel.mesh import make_mesh_grid
from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.parallel import launch
from block_lanczos_tpu_torch.utils import gen

import mesh_ranks

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
WALL_S = 300
P61 = (1 << 61) - 1
PBIG = 1073741789
TOO_SMALL = ("matrix bands too small to chunk for comm/compute overlap; "
             "use the default ShardedBlockLanczos")

# (name, field, golden, prime, n, grid, JAX check_invariants); the 2 x 4
# runs capture (v, p) after every iteration
GRID_RUNS = [
    ("narrow-2x1", "narrow", "left_p65537_n4", 65537, 4, (2, 1), False),
    ("narrow-8x1", "narrow", "left_p65537_n4", 65537, 4, (8, 1), False),
    ("narrow-2x4", "narrow", "left_pbig_n4", PBIG, 4, (2, 4), True),
    ("gf2-8x1", "gf2", "left_p2_n32", 2, 32, (8, 1), True),
    ("gf2-2x4", "gf2", "left_p2_n32", 2, 32, (2, 4), True),
    ("wide-8x1", "wide", "left_pbig_n4", P61, 4, (8, 1), True),
    ("wide-2x4", "wide", "left_pbig_n4", P61, 4, (2, 4), True),
]
JAX_SOLVERS = {"narrow": JNarrow, "gf2": JGF2, "wide": JWide}
AS_PORT = {"narrow": lambda a: a.astype(np.int32),
           "gf2": lambda w: w.view(np.int32),
           "wide": lambda a: jgw.np_unpair(a).astype(np.int64)}


def _path(name):
    return os.path.join(GOLDEN, f"{name}.mtx")


def _golden_kernel(name):
    return jmmio.read_array_mtx(os.path.join(GOLDEN,
                                             f"{name}.kernel.mtx"))[2]


def _golden_bytes(name):
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        return fh.read()


def _row_skewed(nrows=3000, ncols=2000, density=7, seed=5, alpha=1.2):
    """tests/test_skewed_sharded.py::row_skewed_matrix's COO (the port's
    generator draws the JAX package's): Zipf-weighted rows."""
    i, j, x = gen.random_sparse_skewed(ncols, nrows, density, seed=seed,
                                       alpha=alpha)
    order = np.lexsort((i, j))
    return (nrows, ncols, j[order].astype(np.int32),
            i[order].astype(np.int32), (x[order] % PBIG).astype(np.uint32))


def _tasks():
    """The solves, ordered so that tasks on disjoint ranks run side by
    side (tests/mesh_ranks.py::solve_job)."""
    tasks = [
        # three side by side on ranks 0-1, 2-3 and 4-5
        dict(name="skewed", field="narrow", matrix=_row_skewed(), prime=PBIG,
             n=4, grid=(2, 1), ranks=range(4, 6), overlap=True,
             stop_after=3),
        dict(name="pad1", field="narrow",
             matrix=_path("left_pbig_n8_odd_dims"), prime=PBIG, n=8,
             grid=(2, 1), ranks=range(2, 4), overlap=True, pad_multiple=1)]
    for name, field, golden, p, n, grid, _ in GRID_RUNS:
        task = dict(name=name, field=field, matrix=_path(golden), prime=p,
                    n=n, grid=grid, overlap=True,
                    check=field != "narrow" or grid == (2, 4))
        if grid == (2, 4):
            task.update(sync_every=1, capture=True)
        tasks.append(task)
    tasks += [
        dict(name="too-small", field="narrow",
             matrix=_path("left_pbig_n8_odd_dims"), prime=PBIG, n=8,
             grid=(1, 8), overlap=True)]
    return tasks


def _cli_cases(tmp):
    """(argv, (R, C), ranks) for mesh_ranks.cli_job: --overlap --grid 2 2
    in each field, then the checkpoint crossings."""
    def argv(golden, p, n, *extra):
        return ["--matrix", _path(golden), "--prime", str(p), "--n", str(n),
                "--device", "cpu", "--overlap", *extra]
    out = {f: str(tmp / f"{f}.mtx") for f in ("narrow", "gf2", "wide",
                                             "saved-off", "saved-on")}
    ck = {k: str(tmp / f"ck-{k}") for k in ("off", "on")}
    narrow = ["--matrix", _path("left_p65537_n4"), "--prime", "65537",
              "--n", "4", "--device", "cpu"]
    g = ((2, 2), range(4))
    cases = [
        (argv("left_p65537_n4", 65537, 4, "--output-file", out["narrow"]),
         *g),
        (argv("left_p2_n32", 2, 32, "--output-file", out["gf2"]), *g),
        (argv("left_pbig_n4", P61, 4, "--output-file", out["wide"]), *g),
        # saved without --overlap, resumed with it; and the other way round
        (narrow + ["--stop-after", "6", "--checkpoint", "0",
                   "--checkpoint-dir", ck["off"]], *g),
        (narrow + ["--overlap", "--load-checkpoint", "--checkpoint-dir",
                   ck["off"], "--output-file", out["saved-off"]], *g),
        (narrow + ["--overlap", "--stop-after", "6", "--checkpoint", "0",
                   "--checkpoint-dir", ck["on"]], *g),
        (narrow + ["--load-checkpoint", "--checkpoint-dir", ck["on"],
                   "--output-file", out["saved-on"]], *g)]
    return cases, out


def _jax_solve(field, golden, p, n, grid, check, capture):
    """JAX's overlap solve on `grid`, with (v, p) in true row order (the
    port's representation) after every iteration when `capture`."""
    js = JAX_SOLVERS[field](jmmio.load_mtx(_path(golden), p), n=n,
                            mesh=make_mesh_grid(*grid), overlap=True,
                            check_invariants=check,
                            sync_every=1 if capture else None)
    iterates = []

    def grab(solver, iteration, v, p_blk, start):
        iterates.append((iteration,
                         AS_PORT[field](js.row_map.gather(np.asarray(v))),
                         AS_PORT[field](js.row_map.gather(
                             np.asarray(p_blk)))))

    return js.solve(on_iteration=grab if capture else None), iterates


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_overlap")
    tasks = _tasks()
    cases, files = _cli_cases(tmp)
    jobs = [("solve_job", (tasks,)), ("cli_job", (cases,))]
    with ThreadPoolExecutor(1) as pool:      # the ranks run meanwhile
        port = pool.submit(launch.spawn, mesh_ranks.sequence_job,
                           ["cpu"] * 8, args=(jobs,), wall_s=WALL_S)
        jax = {name: _jax_solve(field, golden, p, n, grid, check,
                                grid == (2, 4))
               for name, field, golden, p, n, grid, check in GRID_RUNS}
        nr, nc, i, j, x = _row_skewed()
        jax["skewed"] = JSingle(jmmio.COOMatrix(nr, nc, len(i), i, j, x,
                                                PBIG), n=4).solve(
                                                    stop_after=3)
        jwide = str(tmp / "jax-wide.mtx")
        assert jcli.main(["--matrix", _path("left_pbig_n4"), "--prime",
                          str(P61), "--n", "4", "--devices", "8",
                          "--overlap", "--output-file", jwide,
                          "--no-checks"]) == 0
        results, rcs = port.result()[0]
    got = {t["name"]: r for t, r in zip(tasks, results)}
    return got, jax, rcs, files, jwide


@pytest.mark.parametrize("name", [r[0] for r in GRID_RUNS])
def test_overlap_matches_jax_and_the_golden(runs, name):
    _, field, golden, *_ = [r for r in GRID_RUNS if r[0] == name][0]
    got, (want, _) = runs[0][name], runs[1][name]
    assert got["iterations"] == want.iterations
    assert got["v_nonzero"] and got["product_zero"]
    assert (want.v_nonzero, want.product_zero) == (True, True)
    np.testing.assert_array_equal(got["kernel"], want.kernel)
    if field != "wide":   # no C-reference golden above its cap
        np.testing.assert_array_equal(got["kernel"].astype(np.int64),
                                      _golden_kernel(golden))


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_overlap_iterates_match_jax_every_iteration(runs, field):
    name = f"{field}-2x4"
    got = runs[0][name]["iterates"]
    _, want = runs[1][name]
    assert len(got) >= runs[0][name]["iterations"]
    assert [it for it, _, _ in got] == [it for it, _, _ in want]
    for (it, gv, gp), (_, wv, wp) in zip(got, want):
        np.testing.assert_array_equal(gv, wv, err_msg=f"v at {it}")
        np.testing.assert_array_equal(gp, wp, err_msg=f"p at {it}")


def test_skewed_overlap_parity(runs):
    """The overlap partition keeps the balanced (permuted) band maps."""
    got, want = runs[0]["skewed"], runs[1]["skewed"]
    assert not got["row_identity"]
    assert got["iterations"] == 3 and got["stopped_by_limit"]
    np.testing.assert_array_equal(got["kernel"], want.kernel)


def test_overlap_splits_odd_bands_at_pad_multiple_1(runs):
    got = runs[0]["pad1"]
    assert got["v_nonzero"] and got["product_zero"]
    np.testing.assert_array_equal(got["kernel"].astype(np.int64),
                                  _golden_kernel("left_pbig_n8_odd_dims"))


def test_overlap_refuses_bands_too_small_on_every_rank(runs):
    assert runs[0]["too-small"]["errors"] == [TOO_SMALL] * 8
    M = jmmio.load_mtx(_path("left_pbig_n8_odd_dims"), PBIG)
    with pytest.raises(ValueError, match=TOO_SMALL):
        JNarrow(M, n=8, mesh=make_mesh_grid(1, 8), overlap=True)


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_cli_overlap_grid_writes_the_golden(runs, field):
    """--overlap --grid 2 2: the golden, or for the wide field the JAX
    CLI's --overlap --devices 8 file, byte for byte."""
    _, _, rcs, files, jwide = runs
    assert rcs[:3] == [0, 0, 0]
    with open(files[field], "rb") as fh:
        got = fh.read()
    if field == "wide":
        with open(jwide, "rb") as fh:
            assert got == fh.read()
    else:
        assert got == _golden_bytes({"narrow": "left_p65537_n4",
                                     "gf2": "left_p2_n32"}[field])


@pytest.mark.parametrize("saved", ["off", "on"])
def test_cli_checkpoint_resumes_across_overlap(runs, saved):
    """A mesh checkpoint saved without --overlap resumes with it, and the
    other way round, to the golden (the file is in true row order)."""
    _, _, rcs, files, _ = runs
    assert rcs[3:] == [0, 0, 0, 0]
    with open(files[f"saved-{saved}"], "rb") as fh:
        assert fh.read() == _golden_bytes("left_p65537_n4")

