"""The device generator's matrix, made here on the CPU at small sizes."""

import numpy as np
import pytest

from portbench import matrix

CONFIG = {"nrows": 4000, "ncols": 1000, "row_draws": 15, "value_low": 1,
          "value_high": 1 << 20, "prime": 1073741789}


def test_same_seed_same_matrix_other_seed_other():
    a = matrix.generate(CONFIG, 2**31 + 5, "cpu")
    b = matrix.generate(CONFIG, 2**31 + 5, "cpu")
    c = matrix.generate(CONFIG, 2**31 + 6, "cpu")
    for f in ("i", "j", "x"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.j, c.j)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**40 + 1])
def test_distribution(seed):
    m = matrix.generate(CONFIG, seed, "cpu")
    nrows, ncols, d = CONFIG["nrows"], CONFIG["ncols"], CONFIG["row_draws"]
    assert m.i.dtype == np.int32 and m.j.dtype == np.int32
    assert m.x.dtype == np.uint32
    # sorted by row then column, no repeated pair
    key = m.i.astype(np.int64) * ncols + m.j
    assert (np.diff(key) > 0).all()
    assert m.i.min() >= 0 and m.i.max() < nrows
    assert m.j.min() >= 0 and m.j.max() < ncols
    # every row keeps at most d entries; repeats merged as expected: the
    # mean distinct count of d draws from ncols columns
    per_row = np.bincount(m.i, minlength=nrows)
    assert per_row.max() <= d and per_row.min() >= 1
    expected = ncols * (1 - (1 - 1 / ncols) ** d) * nrows
    assert abs(m.nnz - expected) < 5 * np.sqrt(expected * 0.01) + 50
    # columns uniform: each column's count within 6 sigma of its mean
    per_col = np.bincount(m.j, minlength=ncols)
    mean = m.nnz / ncols
    assert np.abs(per_col - mean).max() < 6 * np.sqrt(mean)
    # values uniform in [1, 2^20)
    assert m.x.min() >= 1 and m.x.max() < 1 << 20
    assert abs(m.x.astype(np.float64).mean() / (1 << 19) - 1) < 0.02


def test_values_reduced_mod_p():
    conf = dict(CONFIG, prime=2)
    m = matrix.generate(conf, 1, "cpu")
    assert set(np.unique(m.x)) <= {0, 1}
    odd = m.x.mean()
    assert 0.45 < odd < 0.55
    wide = matrix.generate(dict(CONFIG, prime=(1 << 61) - 1), 1, "cpu")
    assert wide.x.dtype == np.uint64
