"""The plain reference accepts a true left kernel block and rejects a
block with one residue or bit changed, zero columns and a wrong shape."""

import numpy as np
import pytest

from portbench.reference import check

PRIMES = [2, 65537, 1073741789, (1 << 61) - 1]


def _kernel_instance(p: int, seed: int = 3):
    """A sparse-ish M with a known kernel block: M = [A; K A] has the left
    kernel rows [-y K, y] for any y; exact in Python ints."""
    rng = np.random.default_rng(seed)

    def draw(shape, density=0.4):
        vals = [int(v) % p for v in rng.integers(1, 1 << 62, size=shape)
                .ravel()]
        keep = rng.random(shape).ravel() < density
        return np.array([v if k else 0 for v, k in zip(vals, keep)],
                        dtype=object).reshape(shape)
    a, c, ncols, n = 12, 9, 15, 3
    A, K = draw((a, ncols)), draw((c, a))
    M = np.vstack([A, K.dot(A) % p])
    y = draw((c, n), 1.0)
    x = np.vstack([(-K.T.dot(y)) % p, y])
    assert not (x.T.dot(M) % p).any()
    i, j = np.nonzero(M != 0)
    vals = np.array([int(M[r, s]) for r, s in zip(i, j)], dtype=object)
    kernel = x.astype(np.uint64) if p > 2 else (x % 2).astype(np.uint32)
    s = check.prepare(M.shape[0], M.shape[1], i, j,
                      vals.astype(np.uint64), p)
    return s, kernel


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("p", PRIMES)
def test_accepts_a_true_kernel(p, seed):
    s, kernel = _kernel_instance(p, seed)
    assert check.judge(s, kernel) == {"shape_bad": 0, "zero_columns": 0,
                                      "xM_nonzero": 0}


@pytest.mark.parametrize("p", PRIMES)
def test_rejects_one_changed_entry(p):
    s, kernel = _kernel_instance(p)
    for r in range(kernel.shape[0]):
        bad = kernel.copy()
        bad[r, 1] = (int(bad[r, 1]) + 1) % p
        got = check.judge(s, bad)
        # a row with entries moves its products; an empty row cannot
        assert (got["xM_nonzero"] > 0) == (r in set(s.src.tolist()))


@pytest.mark.parametrize("p", PRIMES)
def test_rejects_zero_columns_and_a_wrong_shape(p):
    s, kernel = _kernel_instance(p)
    assert check.judge(s, np.zeros_like(kernel))["zero_columns"] == 3
    one = kernel.copy()
    one[:, 2] = p if p > 2 else 2       # zero mod p
    assert check.judge(s, one) == {"shape_bad": 0, "zero_columns": 1,
                                   "xM_nonzero": 0}
    assert check.judge(s, kernel[:-1])["shape_bad"] == 1
    assert check.judge(s, kernel[:, :0])["shape_bad"] == 1


def test_wide_sums_match_python_ints():
    p = (1 << 61) - 1
    rng = np.random.default_rng(5)
    nrows, ncols, nnz = 40, 30, 300
    i = rng.integers(0, nrows, nnz)
    j = rng.integers(0, ncols, nnz)
    v = np.array([int(t) % p for t in rng.integers(1, 1 << 62, nnz)],
                 dtype=np.uint64)
    x = np.array([[int(t) % p for t in row]
                  for row in rng.integers(0, 1 << 62, (nrows, 2))],
                 dtype=np.uint64)
    s = check.prepare(nrows, ncols, i, j, v, p)
    got = check.product_modp(s, x)
    want = np.zeros((ncols, 2), dtype=object)
    for r, c, val in zip(i, j, v):
        for k in range(2):
            want[c, k] = (want[c, k] + int(x[r, k]) * int(val)) % p
    assert (got.astype(object) == want).all()
