"""Degenerate inputs through the port, against the JAX package (twins of
tests/test_robustness.py's degenerate cases).

  * the solver classes on the CPU: a zero matrix, empty rows and columns,
    a single entry, 128 x 8 (left) and 8 x 128 (right), n > ncols, 1 x 1,
    1 x 40 and 40 x 1, each at p = 65537, 1073741789, 2 (the narrow field
    at the case's n, and GF(2) at n = 32) and 2^61 - 1: the iteration
    count, the final check's flags and the kernel equal to the JAX
    package's solver of the same field;
  * the mesh CLI (gloo ranks on the CPU, one spawned world of 4 for every
    case, a 120 s wall limit): a matrix that is zero mod p, 1 x 8 and
    8 x 1, each on two grids, write the JAX CLI's kernel file byte for
    byte.

Tolerance zero.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from block_lanczos_tpu.models import lanczos as jl
from block_lanczos_tpu.models import lanczos_gf2 as jlg
from block_lanczos_tpu.models import lanczos_wide as jlw
from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu.utils.gen import random_sparse
from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.models import lanczos_gf2 as tlg
from block_lanczos_tpu_torch.models import lanczos_wide as tlw
from block_lanczos_tpu_torch.parallel import launch
from block_lanczos_tpu_torch.utils import mmio as tmmio

import mesh_ranks

P61 = (1 << 61) - 1
WALL_S = 120


def _random(nrows, ncols, density, seed):
    i, j, x = random_sparse(nrows, ncols, density, seed=seed)
    return nrows, ncols, i, j, x


def _empty_rows_and_cols():
    """Entries on the even rows and the first half of the columns only."""
    rng = np.random.default_rng(0)
    i = np.arange(0, 64, 2).repeat(3)
    return 64, 32, i, rng.integers(0, 16, len(i)), \
        rng.integers(1, 1 << 30, len(i))


# name -> (nrows, ncols, i, j, x), n, right
CASES = {
    "zero": ((16, 8, [0], [0], [0]), 4, False),
    "empty-rows-and-cols": (_empty_rows_and_cols(), 4, False),
    "single-entry": ((4, 2, [1], [1], [123]), 2, False),
    "128x8": (_random(128, 8, 3, 4), 4, False),
    "8x128-right": (_random(8, 128, 3, 4), 4, True),
    "n-above-ncols": (_random(32, 6, 2, 5), 8, False),
    "1x1": ((1, 1, [0], [0], [5]), 1, False),
    "1x40": ((1, 40, [0, 0, 0], [0, 17, 39], [3, 5, 7]), 1, False),
    "40x1": ((40, 1, [0, 17, 39], [0, 0, 0], [3, 5, 7]), 1, False),
}
# field id -> (p, n; None: the case's)
FIELDS = {"p65537": (65537, None), "p1073741789": (1073741789, None),
          "p2": (2, None), "gf2-n32": (2, 32), "p61": (P61, None)}


def _coo(mod, coo, p):
    nrows, ncols, i, j, x = coo
    dtype = np.uint64 if p == P61 else np.uint32
    x = (np.asarray(x, dtype=np.uint64) % np.uint64(p)).astype(dtype)
    return mod.COOMatrix(nrows, ncols, len(x), np.asarray(i, np.int32),
                         np.asarray(j, np.int32), x, p)


def _solvers(p, n):
    if p == P61:
        return jlw.BlockLanczosWide, tlw.BlockLanczosWide
    if p == 2 and n % 32 == 0:
        return jlg.BlockLanczosGF2, tlg.BlockLanczosGF2
    return jl.BlockLanczos, tl.BlockLanczos


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("case", list(CASES))
def test_degenerate_solve_matches_jax(case, field):
    coo, n, right = CASES[case]
    p, n_field = FIELDS[field]
    n = n_field or n
    jcls, tcls = _solvers(p, n)
    want = jcls(_coo(jmmio, coo, p), n=n, right=right).solve()
    got = tcls(_coo(tmmio, coo, p), n=n, right=right, device="cpu").solve()
    assert (got.iterations, got.v_nonzero, got.product_zero) == \
        (want.iterations, want.v_nonzero, want.product_zero)
    np.testing.assert_array_equal(got.kernel, want.kernel)


def _write(path, nrows, ncols, entries):
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{nrows} {ncols} {len(entries)}\n")
        for a, b, v in entries:
            fh.write(f"{a} {b} {v}\n")
    return path


# name -> (nrows, ncols, 1-based entries, n, the two grids)
MESH_CASES = {
    # every coefficient a multiple of p: the solve stops at iteration 0
    "zero-mod-p": (16, 8, [(t + 1, t + 1, 65537 * (t + 1)) for t in
                           range(4)], 4, ((2, 2), (4, 1))),
    "1x8": (1, 8, [(1, 1, 3), (1, 8, 5)], 1, ((2, 2), (1, 4))),
    "8x1": (8, 1, [(1, 1, 3), (8, 1, 5)], 1, ((4, 1), (2, 2))),
}


@pytest.fixture(scope="module")
def mesh_cli_runs(tmp_path_factory):
    """Every mesh CLI case on its grids in one spawned world of 4 ranks,
    the JAX CLI's file of each case made here meanwhile."""
    tmp = tmp_path_factory.mktemp("degenerate_cli")
    keys, jobs, jax_argv = [], [], {}
    for name, (nrows, ncols, entries, n, grids) in MESH_CASES.items():
        mtx = _write(str(tmp / f"{name}.mtx"), nrows, ncols, entries)
        base = ["--matrix", mtx, "--prime", "65537", "--n", str(n)]
        for R, C in grids:
            out = str(tmp / f"{name}-{R}x{C}.kernel.mtx")
            keys.append((name, (R, C)))
            jobs.append((base + ["--output-file", out, "--device", "cpu"],
                         (R, C)))
        jax_argv[name] = base + ["--output-file",
                                 str(tmp / f"{name}.jax.kernel.mtx"),
                                 "--single"]
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch.spawn, mesh_ranks.cli_job, ["cpu"] * 4,
                           args=(jobs,), wall_s=WALL_S)
        jax_rcs = {name: jcli.main(argv) for name, argv in jax_argv.items()}
        rcs = port.result()[0]
    return tmp, dict(zip(keys, rcs)), jax_rcs


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_cli_degenerate_writes_the_jax_file(mesh_cli_runs, name):
    tmp, rcs, jax_rcs = mesh_cli_runs
    assert jax_rcs[name] == 0
    jax_bytes = (tmp / f"{name}.jax.kernel.mtx").read_bytes()
    for R, C in MESH_CASES[name][4]:
        assert rcs[name, (R, C)] == 0
        path = tmp / f"{name}-{R}x{C}.kernel.mtx"
        assert os.path.exists(path), (R, C)
        assert path.read_bytes() == jax_bytes, (R, C)
