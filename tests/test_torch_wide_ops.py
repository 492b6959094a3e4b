"""The port's wide-field ops (CPU tensors: the plain versions of the four
wide kernels) against the JAX package's, bit for bit, on the same inputs
made with numpy from a seed:

  * spmv_wide against JAX spmv_wide on the port's own layout, on a layout
    carried over from a JAX WideHybridOp (convert.wide_op_from_jax) and
    against JAX's forced-banded operator (spmv_wide_banded);
  * gram_wide against JAX wide_ops.gram_mod over more than one of JAX's
    row chunks;
  * semi_inverse_wide against JAX semi_inverse_device and the host oracle
    semi_inverse_py (full rank, rank-deficient, zero), with the kernel's
    row-scaled Montgomery elimination mirrored in NumPy
    (ops/gfp_wide.py::semi_inverse_mont_np) and held against the oracle
    too;
  * the right-hand side and the checks against check_invariants_device and
    orthogonalize_device's prologue; orthogonalize_wide against
    orthogonalize_device, running and halted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos_wide as jlw
from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.ops import wide_ops as jwo
from block_lanczos_tpu_torch.convert import wide_op_from_jax
from block_lanczos_tpu_torch.models import lanczos_wide as tlw
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.ops import semi_inverse as tsi
from block_lanczos_tpu_torch.ops import wide_ops as two
from block_lanczos_tpu_torch.utils import gen

P30 = 1073741827
P55 = 36028797018963913
P61 = (1 << 61) - 1
P62 = 4611686018427387847


def rand_res(rng, p, shape):
    """Full-range residues (62 random bits, reduced)."""
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % p)


def pairs(a):
    return jnp.asarray(jgw.np_pair(np.asarray(a).astype(object)))


def unpair(a):
    return jgw.np_unpair(np.asarray(a)).astype(np.int64)


def matrix(p, nrows, ncols, density, seed):
    """COO arrays with full-range values (five of them p - 1) and one row
    far longer than the slab, so that the layout spills."""
    rng = np.random.default_rng(seed)
    i, j, _ = gen.random_sparse(nrows, ncols, density, seed=seed)
    extra = np.unique(rng.integers(0, ncols, 40))
    i = np.concatenate([i, np.full(len(extra), nrows - 1)])
    j = np.concatenate([j, extra])
    key = np.unique(i.astype(np.int64) * ncols + j)
    i, j = key // ncols, key % ncols
    x = rand_res(rng, p, len(i))
    x[:5] = p - 1
    return i.astype(np.int32), j.astype(np.int32), x


@pytest.mark.parametrize("p,n", [(P61, 4), (P62, 3), (P30, 1), (P55, 8)])
def test_spmv_wide_matches_jax(p, n):
    rng = np.random.default_rng(n)
    nrows, ncols = 90, 61
    i, j, x = matrix(p, nrows, ncols, 6, seed=n)
    f = gw.GFpWide.make(p)
    jf = jgw.GFpWide.make(p)
    xv = rand_res(rng, p, (ncols, n))
    xv[0] = p - 1
    want = unpair(jwo.spmv_wide(jf, jwo.make_wide_hybrid_op(
        jf, i, j, x.astype(object), nrows, ncols), pairs(xv), out_rows=96))
    oracle = jwo.spmv_wide_oracle(p, nrows, i, j, x.astype(object),
                                  xv.astype(object))
    # full-range values: every signed representative fits 31 bits only
    # below 2^32, so the default slab is narrow there; the u64 slab always
    fits = p < 1 << 32
    assert two.narrow_fits(p, x) == fits
    chosen = two.make_wide_op(f, i, j, x, nrows, ncols)
    assert chosen.vals.dtype == (torch.int32 if fits else torch.int64)
    for op in (chosen, two.u64_slab(chosen)):
        assert op.spill_nnz > 0
        assert op.sp_vals.dtype == op.vals.dtype
        got = two.spmv_wide(f, op, torch.from_numpy(xv), out_rows=96)
        assert got.dtype == torch.int64 and got.shape == (96, n)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[nrows:].any()
        # the oracle agrees too
        np.testing.assert_array_equal(got.numpy()[:nrows],
                                      oracle.astype(np.int64))


def test_spmv_wide_on_a_layout_from_jax():
    """The JAX op's Montgomery-pair slab and spill, carried over by
    wide_op_from_jax, give JAX's result on the port's plain product; a
    forced narrow slab makes a long spill."""
    p = P61
    rng = np.random.default_rng(11)
    nrows, ncols, n = 70, 50, 4
    i, j, x = matrix(p, nrows, ncols, 7, seed=11)
    jf, f = jgw.GFpWide.make(p), gw.GFpWide.make(p)
    xv = rand_res(rng, p, (ncols, n))
    for ell in (None, 2):
        jop = jwo.make_wide_hybrid_op(jf, i, j, x.astype(object), nrows,
                                      ncols, ell=ell)
        arrays = dict(out_dim=jop.out_dim, in_dim=jop.in_dim, nnz=jop.nnz,
                      ell=jop.ell, cols=np.asarray(jop.cols),
                      vals=np.asarray(jop.vals), spill_nnz=jop.spill.nnz,
                      spill_in_idx=np.asarray(jop.spill.in_idx),
                      spill_val_mont=np.asarray(jop.spill.val_mont),
                      spill_rowptr=np.asarray(jop.spill.rowptr))
        op = wide_op_from_jax(arrays, p)
        assert op.ell == jop.ell and op.spill_nnz == jop.spill.nnz
        want = unpair(jwo.spmv_wide(jf, jop, pairs(xv)))
        got = two.spmv_wide(f, op, torch.from_numpy(xv))
        np.testing.assert_array_equal(got.numpy(), want)
        if ell == 2:
            assert op.spill_nnz > nrows * 3


def test_spmv_wide_matches_jax_banded():
    """JAX's input-banded operator (3 bands, summed mod p) against the
    port's monolithic layout: mod-p sums are associative."""
    p = P62
    rng = np.random.default_rng(5)
    nrows, ncols, n = 80, 66, 2
    i, j, x = matrix(p, nrows, ncols, 6, seed=5)
    jf, f = jgw.GFpWide.make(p), gw.GFpWide.make(p)
    xv = rand_res(rng, p, (ncols, n))
    bop = jwo.make_wide_banded_op(jf, i, j, x.astype(object), nrows, ncols,
                                  nbands=3)
    assert len(bop.parts) == 3
    want = unpair(jwo.apply_wide(jf, bop, pairs(xv), out_rows=nrows))
    got = two.spmv_wide(f, two.make_wide_op(f, i, j, x, nrows, ncols),
                        torch.from_numpy(xv))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,n,N", [(P61, 4, 700), (P62, 2, 300),
                                   (P30, 3, 50)])
def test_gram_wide_matches_jax(p, n, N):
    rng = np.random.default_rng(N)
    v, av = rand_res(rng, p, (N, n)), rand_res(rng, p, (N, n))
    v[:20], av[:20] = p - 1, p - 1            # the worst case rows
    jf = jgw.GFpWide.make(p)
    want = unpair(jwo.gram_mod(jf, pairs(np.concatenate([v, av], 1)),
                               pairs(av)))
    got = two.gram_wide(torch.from_numpy(v), torch.from_numpy(av),
                        gw.GFpWide.make(p))
    assert got.shape == (2 * n, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_gram_wide_over_jax_row_chunks(monkeypatch):
    """JAX sums its Gram in row chunks; with chunks of 128 rows a 1000-row
    Gram crosses 8 of them."""
    p, n, N = P61, 4, 1000
    rng = np.random.default_rng(9)
    v, av = rand_res(rng, p, (N, n)), rand_res(rng, p, (N, n))
    monkeypatch.setattr(jwo, "_gram_chunk_rows", lambda _: 128)
    jf = jgw.GFpWide.make(p)
    want = unpair(jwo.gram_mod(jf, pairs(np.concatenate([v, av], 1)),
                               pairs(av)))
    got = two.gram_wide(torch.from_numpy(v), torch.from_numpy(av),
                        gw.GFpWide.make(p))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Semi-inverse
# ---------------------------------------------------------------------------

def low_rank_sym(rng, p, n, rank):
    B = rand_res(rng, p, (n, max(rank, 1))).astype(object)
    U = (B @ B.T) % p if rank else np.zeros((n, n), object)
    return U.astype(np.int64)


SI_CASES = [(P61, 4, 4), (P61, 4, 3), (P62, 5, 2), (P61, 3, 0),
            (P30, 6, 6), (P55, 8, 5), (P62, 1, 1)]


@pytest.mark.parametrize("p,n,rank", SI_CASES)
def test_semi_inverse_wide_matches_jax(p, n, rank):
    rng = np.random.default_rng(p % 991 + n + rank)
    U = low_rank_sym(rng, p, n, rank)
    A = rand_res(rng, p, (n, n)).astype(object)
    UA = ((A + A.T) % p).astype(np.int64)
    jf = jgw.GFpWide.make(p)
    jW, jd, jnpiv = jwo.semi_inverse_device(jf, pairs(U))
    pW, pd, pnpiv = jwo.semi_inverse_py(p, U.astype(object))
    state = tsi.new_state("cpu")
    si = two.semi_inverse_wide(torch.from_numpy(np.concatenate([U, UA])),
                               gw.GFpWide.make(p), state)
    np.testing.assert_array_equal(si.winv.numpy(), unpair(jW))
    np.testing.assert_array_equal(si.winv.numpy(), pW.astype(np.int64))
    np.testing.assert_array_equal(si.d.numpy(), np.asarray(jd))
    assert int(si.npiv[0]) == int(jnpiv) == pnpiv
    assert int(jnpiv) == min(rank, n)
    # the kernel's elimination, mirrored
    mW, md, mnpiv, steps = gw.semi_inverse_mont_np(p, U)
    np.testing.assert_array_equal(mW.astype(np.int64), si.winv.numpy())
    np.testing.assert_array_equal(md, pd)
    assert mnpiv == pnpiv
    assert 1 <= steps <= 2 * p.bit_length()
    # the checks, the stop flag and the right-hand side
    ok = jlw.check_invariants_device(jf, pairs(U), pairs(UA), jW, jd)
    assert bool(ok) and state.tolist() == [int(pnpiv == 0), 1, 0, 0]
    dm = np.asarray(jd).astype(bool)[None, :]
    spliced = np.where(dm, UA, U).astype(object)
    c = (-(pW @ spliced)) % p
    vtAvd = np.where(dm, (-U.astype(object)) % p, 0)
    want_rhs = np.block([[c, pW], [vtAvd, np.zeros((n, n), object)]])
    np.testing.assert_array_equal(si.rhs.numpy(), want_rhs.astype(np.int64))


def test_semi_inverse_wide_failing_check_and_frozen_state():
    p, n = P61, 4
    rng = np.random.default_rng(2)
    U = low_rank_sym(rng, p, n, 4)
    UA = U.copy()
    UA[0, 1] = (UA[0, 1] + 1) % p              # vtAAv not symmetric
    grams = torch.from_numpy(np.concatenate([U, UA]))
    f = gw.GFpWide.make(p)
    state = tsi.new_state("cpu")
    two.semi_inverse_wide(grams, f, state)
    assert state.tolist() == [0, 0, 0, 0]
    state = tsi.new_state("cpu")
    two.semi_inverse_wide(grams, f, state, check=False)
    assert state.tolist() == [0, 1, 0, 0]
    frozen = torch.tensor([1, 1, 7, 1], dtype=torch.int32)
    two.semi_inverse_wide(grams, f, frozen)
    assert frozen.tolist() == [1, 1, 7, 1]
    with pytest.raises(ValueError):
        two.semi_inverse_wide(grams[:5], f, state)


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,n", [(P61, 4), (P62, 3), (P55, 1)])
def test_orthogonalize_wide_matches_jax(p, n):
    rng = np.random.default_rng(n + 40)
    N = 37
    v, Av, pb = (rand_res(rng, p, (N, n)) for _ in range(3))
    v[0], Av[0], pb[0] = p - 1, p - 1, p - 1
    U = low_rank_sym(rng, p, n, max(n - 1, 1))
    UA = (U * 3 + 1) % p
    f, jf = gw.GFpWide.make(p), jgw.GFpWide.make(p)
    state = tsi.new_state("cpu")
    si = two.semi_inverse_wide(torch.from_numpy(np.concatenate([U, UA])), f,
                               state)
    want_v, want_p = jlw.orthogonalize_device(
        jf, pairs(v), pairs(Av), pairs(pb), jnp.asarray(si.d.numpy()
                                                        .astype(np.uint32)),
        pairs(U), pairs(UA), pairs(si.winv.numpy()))
    tv, tp = torch.from_numpy(v.copy()), torch.from_numpy(pb.copy())
    tlw.orthogonalize_wide(tv, tp, torch.from_numpy(Av), si.rhs, si.d, f,
                           state)
    np.testing.assert_array_equal(tv.numpy(), unpair(want_v))
    np.testing.assert_array_equal(tp.numpy(), unpair(want_p))
    assert state.tolist() == [0, 1, 1, 0]
    # a latched stop freezes v and p, counts the probe once, then nothing
    state[tsi.STOP] = 1
    before_v, before_p = tv.clone(), tp.clone()
    for _ in range(3):
        tlw.orthogonalize_wide(tv, tp, torch.from_numpy(Av), si.rhs, si.d,
                               f, state)
    assert torch.equal(tv, before_v) and torch.equal(tp, before_p)
    assert state.tolist() == [1, 1, 2, 1]
