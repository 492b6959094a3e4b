"""Random sparse test-matrix generation (the port's own copy).

Random sparse integer general MatrixMarket matrices, structurally like the
reference's benchmark inputs.  A left kernel (x*M == 0) is guaranteed
nontrivial whenever nrows > ncols.  The same seed gives the same matrix as
the JAX package's generator, for the uniform `random_sparse` and the
power-law `random_sparse_skewed` alike.
"""

from __future__ import annotations

import numpy as np

from block_lanczos_tpu_torch.utils import mmio

# The repo's bench matrix (bench.py's configuration), solved mod
# BENCH_PRIME; chip_smoke.py and utils/profile_solve.py build it from here.
BENCH_NROWS, BENCH_NCOLS, BENCH_DENSITY, BENCH_SEED = 300_000, 200_000, 15, 42
BENCH_PRIME = 1073741789
# the wide field's bench prime (bench.py's "wide p61" cell): 2^61 - 1
WIDE_BENCH_PRIME = (1 << 61) - 1


def random_sparse(nrows: int, ncols: int, row_density: int, seed: int = 0,
                  max_value: int = 1 << 20):
    """Random COO with ~row_density entries per row, unique (i, j) pairs."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(nrows, dtype=np.int64), row_density)
    j = rng.integers(0, ncols, size=len(i), dtype=np.int64)
    key = i * ncols + j
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    i, j = i[idx], j[idx]
    x = rng.integers(1, max_value, size=len(i), dtype=np.int64)
    return i, j, x


def write_random_mtx(path: str, nrows: int, ncols: int, row_density: int,
                     seed: int = 0, max_value: int = 1 << 20):
    i, j, x = random_sparse(nrows, ncols, row_density, seed, max_value)
    mmio.write_coo_mtx(path, nrows, ncols, i, j, x)
    return len(x)


def random_sparse_skewed(nrows: int, ncols: int, row_density: int,
                         seed: int = 0, alpha: float = 1.2,
                         max_value: int = 1 << 20):
    """Random COO with power-law (Zipf-like) column popularity.

    Matrices from integer factorization / discrete log have heavily skewed
    column weights (a few dense "small prime" columns, a long sparse tail);
    this generator reproduces that shape, which exercises the layouts'
    spill paths and the mesh's nnz-balanced band maps
    (parallel/sharding.py::balanced_band_map).
    """
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(nrows, dtype=np.int64), row_density)
    # inverse-CDF sample of a truncated zipf over column ranks
    ranks = np.arange(1, ncols + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w) / w.sum()
    j = np.searchsorted(cdf, rng.random(len(i))).astype(np.int64)
    j = np.minimum(j, ncols - 1)
    key = i * ncols + j
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    i, j = i[idx], j[idx]
    x = rng.integers(1, max_value, size=len(i), dtype=np.int64)
    return i, j, x
