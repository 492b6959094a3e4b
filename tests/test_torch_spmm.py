"""The port's sparse product against the JAX package's, bit for bit.

The same COO goes through JAX `spmm.apply_op` (on its own hybrid layout)
and through the port's `spmv` on the port's layout (CPU tensors, so the
plain version of the spmv_ell kernel), in both directions; then both run on
one identical layout via `convert.hybrid_op_from_jax`.  Tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.ops import spmm as jspmm
from block_lanczos_tpu.ops.gfp import GFp as JGFp
from block_lanczos_tpu.utils.gen import random_sparse_skewed
from block_lanczos_tpu_torch.convert import hybrid_op_from_jax
from block_lanczos_tpu_torch.ops import spmm as tspmm
from block_lanczos_tpu_torch.ops.gfp import GFp as TGFp

P = 1073741789

# one compiled program per case instead of eager op-by-op dispatch
_apply_op = jax.jit(jspmm.apply_op, static_argnums=(0, 3))


def _uniform(rng, nrows, ncols, nnz, p):
    i = rng.integers(0, nrows, nnz)
    j = rng.integers(0, ncols, nnz)
    x = rng.integers(0, p, nnz)
    return i, j, x


def _skewed(rng, nrows, ncols, nnz, p):
    i, j, x = random_sparse_skewed(nrows, ncols, max(1, nnz // nrows),
                                   seed=int(rng.integers(1 << 30)),
                                   alpha=1.3)
    return i, j, x % p


def _empty_rows(rng, nrows, ncols, nnz, p):
    i, j, x = _uniform(rng, nrows // 3, ncols, nnz, p)
    return 3 * i, j, x        # two of every three rows are empty


def _compare(p, i, j, x, nrows, ncols, n, rng, out_pad=0, both=True):
    jf, tf = JGFp.make(p), TGFp.make(p)
    dirs = ((nrows, ncols, i, j), (ncols, nrows, j, i))
    for out_dim, in_dim, oi, ii in dirs if both else dirs[1:]:
        jop = jspmm.make_hybrid_op(jf, oi, ii, x, out_dim, in_dim)
        top = tspmm.make_hybrid_op(tf, oi, ii, x, out_dim, in_dim)
        v = rng.integers(0, p, (in_dim + 3, n), dtype=np.int64)
        out_rows = out_dim + out_pad
        want = np.asarray(_apply_op(jf, jop, jnp.asarray(
            v.astype(np.uint32)), out_rows))
        got = tspmm.spmv(top, torch.from_numpy(v.astype(np.int32)), out_rows)
        assert got.dtype == torch.int32 and got.shape == (out_rows, n)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        assert not got[out_dim:].any()
    return top


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("case", ["uniform_out_pad", "skewed", "empty_rows"])
def test_spmv_matches_jax(case, n):
    """Uniform (with out_rows > out_dim: padding rows must be zero),
    skewed (the spill must be busy) and mostly-empty-row matrices."""
    rng = np.random.default_rng(100 * len(case) + n)
    nrows, ncols, nnz = 150, 97, 1400
    make = {"uniform_out_pad": _uniform, "skewed": _skewed,
            "empty_rows": _empty_rows}[case]
    i, j, x = make(rng, nrows, ncols, nnz, P)
    top = _compare(P, i, j, x, nrows, ncols, n, rng,
                   out_pad=13 if case == "uniform_out_pad" else 0)
    if case == "skewed":
        # the transposed (column-popularity) direction must spill
        assert top.spill_nnz > 0


@pytest.mark.parametrize("p", [2, 3, 65537])
def test_spmv_small_primes_match_jax(p):
    rng = np.random.default_rng(p)
    i, j, x = _uniform(rng, 60, 45, 500, p)
    _compare(p, i, j, x, 60, 45, 4, rng, out_pad=3, both=False)


@pytest.mark.parametrize("p", [2, 65537, P])
def test_spmv_on_the_jax_layout(p):
    """Both SpMVs on ONE layout: the JAX HybridOp's arrays (delta=False,
    out_pad > out_dim, a forced narrow slab so the spill is busy)
    converted with hybrid_op_from_jax."""
    rng = np.random.default_rng(7 + p)
    jf = JGFp.make(p)
    out_dim, in_dim, n = 70, 90, 4
    i, j, x = _skewed(rng, in_dim, out_dim, 900, p)
    jop = jspmm.make_hybrid_op(jf, j, i, x, out_dim, in_dim, out_pad=80,
                               ell=3, delta=False)
    assert jop.spill.nnz > 0 and jop.cols is not None
    arrays = dict(out_dim=jop.out_dim, in_dim=jop.in_dim, nnz=jop.nnz,
                  ell=jop.ell, cols=np.asarray(jop.cols),
                  vals=np.asarray(jop.vals), spill_nnz=jop.spill.nnz,
                  spill_in_idx=np.asarray(jop.spill.in_idx),
                  spill_val_mont=np.asarray(jop.spill.val_mont),
                  spill_rowptr=np.asarray(jop.spill.rowptr))
    top = hybrid_op_from_jax(arrays, p)
    assert top.ell == 3 and top.cols.shape == (3, out_dim)
    assert top.spill_nnz == jop.spill.nnz
    v = rng.integers(0, p, (in_dim, n), dtype=np.int64)
    want = np.asarray(_apply_op(jf, jop, jnp.asarray(v.astype(np.uint32)),
                                88))
    got = tspmm.spmv(top, torch.from_numpy(v.astype(np.int32)), 88)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # and the port's own layout of the same COO gives the same residues
    own = tspmm.make_hybrid_op(TGFp.make(p), j, i, x, out_dim, in_dim)
    np.testing.assert_array_equal(
        tspmm.spmv(own, torch.from_numpy(v.astype(np.int32)), 88).numpy(),
        got.numpy())


def test_layout_matches_jax_width_choice():
    rng = np.random.default_rng(3)
    for _ in range(5):
        counts = rng.poisson(rng.uniform(1, 30), size=rng.integers(1, 400))
        assert tspmm.choose_ell_width(counts) == \
            jspmm.choose_ell_width(counts)
    assert tspmm.choose_ell_width(np.zeros(5, np.int64)) == 1


def test_spmv_rejects_bad_shapes():
    op = tspmm.make_hybrid_op(TGFp.make(P), [0, 1], [1, 0], [5, 6], 2, 2)
    with pytest.raises(ValueError):
        tspmm.spmv(op, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tspmm.spmv(op, torch.zeros((2, 4), dtype=torch.int32), out_rows=1)
