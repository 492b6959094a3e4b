"""The arithmetic of the redesigned wide kernels, on the CPU, tolerance 0:

  * gram_wide's u8-limb tensor-core sums (csrc/gram_wide.cu), through
    their NumPy mirror ops/gfp_wide.py::gram_wide_tc_np: the folded limbs
    and the shift classes, their s32 bounds at the fold rows, the 128-bit
    recombination and the CTAs' 31-bit halves, against Python ints and the
    JAX package's wide gram_mod;
  * spmv_wide's narrow slab (csrc/spmv_wide.cu): the signed 21-bit limb
    sums and their fold (narrow_dot_np) against Python ints, the choice
    of slab by make_wide_op, and both slabs against the JAX package's
    spmv_wide, on the port's layout and on one converted from JAX;
  * orthogonalize_wide's two paths (csrc/orthogonalize_wide.cu): the
    tensor cores' u8-limb shift classes, their s32 bounds at p - 1 and
    n = 64 and the 32-bit-half recombination (ortho_wide_tc_np), and the row
    path's Montgomery rhs with the base in the high word (ortho_row_np),
    against Python ints and the JAX package's orthogonalize_device
    (wide_ops.matmul_mont);
  * semi_inverse_wide's binary inverse (modp64.cuh::mont_inverse, mirrored
    by mont_inverse_np) against pow and the JAX package's modinv_device;
  * the CUDA sources' constants against their Python mirrors.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos_wide as jlw
from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.ops import wide_ops as jwo
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.convert import wide_op_from_jax
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.ops import wide_ops as two

P30 = 1073741827
P61 = (1 << 61) - 1
P62 = 4611686018427387847
PRIMES = (P30, P61, P62)
CMAX = (1 << 31) - 1


def rand_res(rng, p, shape):
    return rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % p


def pairs(a):
    return jnp.asarray(jgw.np_pair(np.asarray(a).astype(object)))


def unpair(a):
    return jgw.np_unpair(np.asarray(a)).astype(np.int64)


def gram_ints(p, v, av):
    X = np.concatenate([v, av], 1).astype(object)
    return ((X.T @ av.astype(object)) % p).astype(np.int64)


# ---------------------------------------------------------------------------
# gram_wide: the limb sums, their bounds, the recombination, the halves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_gram_tensor_core_mirror_matches_python_ints(p, n):
    """Both limb layouts, three CTAs, random rows and rows of p - 1."""
    rng = np.random.default_rng(p % 97 + n)
    v, av = rand_res(rng, p, (90, n)), rand_res(rng, p, (90, n))
    v[:30], av[:30] = p - 1, p - 1
    f = gw.GFpWide.make(p)
    want = gram_ints(p, v, av)
    np.testing.assert_array_equal(gw.gram_wide_tc_np(f, v, av), want)
    for folded in (True, False):
        np.testing.assert_array_equal(
            gw.gram_wide_tc_np(f, v, av, folded=folded), want)


@pytest.mark.parametrize("p", PRIMES)
def test_gram_tensor_core_mirror_matches_jax(p):
    rng = np.random.default_rng(3)
    n, N = 4, 300
    v, av = rand_res(rng, p, (N, n)), rand_res(rng, p, (N, n))
    jf = jgw.GFpWide.make(p)
    want = unpair(jwo.gram_mod(jf, pairs(np.concatenate([v, av], 1)),
                               pairs(av)))
    got = gw.gram_wide_tc_np(gw.GFpWide.make(p), v, av, ctas=7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("folded", [True, False])
def test_gram_limb_sums_fit_s32_at_the_fold_rows(folded):
    """Every residue p - 1 at the largest prime, over the fold rows: the s32
    sums stay below 2^31 (the mirror asserts it), and the bound the kernel
    proves (255^2 a limb pair, 1 or at most 8 pairs an accumulator) holds
    at the fold rows and fails one row past its largest K."""
    p = P62
    K = gw.GW_FOLDED_FOLD_ROWS if folded else gw.GW_CLASS_FOLD_ROWS
    pairs_max = 1 if folded else 8
    assert K * pairs_max * 255 ** 2 < 1 << 31
    kmax = ((1 << 31) - 1) // (pairs_max * 255 ** 2)
    assert kmax == (33025 if folded else 4128) and K <= kmax
    assert (kmax + 1) * pairs_max * 255 ** 2 >= 1 << 31
    full = np.full((K, 2), p - 1, np.int64)
    S = gw.gram_limb_sums_np(full, full, folded)
    assert S.max() < 1 << 31
    # the shift class s + t = 7 collects the most pairs: 8
    if not folded:
        assert sum(1 for s in range(8) for t in range(8) if s + t == 7) == 8
    # the whole Gram over more than one fold block, in one CTA
    f = gw.GFpWide.make(p)
    rows = np.full((K + 37, 1), p - 1, np.int64)
    np.testing.assert_array_equal(
        gw.gram_wide_tc_np(f, rows, rows, folded=folded, ctas=1),
        gram_ints(p, rows, rows))


def test_gram_limbs_and_weights():
    """Eight u8 limbs recombine to the residue, the top one below 2^6; the
    weights are 2^(8k) mod p for the 15 shift classes."""
    rng = np.random.default_rng(8)
    for p in PRIMES:
        x = np.concatenate([rand_res(rng, p, 50), [0, p - 1]])
        L = gw.limbs_np(x)
        assert L.shape == (52, gw.GW_LIMBS) and (L[:, -1] < 64).all()
        back = sum(L[:, s].astype(object) << (8 * s) for s in range(8))
        np.testing.assert_array_equal(back.astype(np.int64), x)
        assert gw.limb_weights_np(gw.GFpWide.make(p)) == \
            [pow(2, 8 * k, p) for k in range(gw.GW_CLASSES)]


@pytest.mark.parametrize("p", PRIMES)
def test_cta_halves_are_exact_at_the_most_ctas(p):
    """GW_MAX_CTA_WARPS warp residues p - 1 in each of GW_MAX_CTAS CTAs,
    added as 31-bit halves: each half's sum stays below 2^45, and
    hi 2^31 + lo, reduced by reduce128, is the sum mod p."""
    f = gw.GFpWide.make(p)
    terms = gw.GW_MAX_CTAS * gw.GW_MAX_CTA_WARPS
    r = np.full(terms, p - 1, object)
    lo, hi = int((r & ((1 << 31) - 1)).sum()), int((r >> 31).sum())
    assert lo < 1 << 45 and hi < 1 << 45
    assert terms * ((1 << 31) - 1) < 1 << 45
    t = (hi << 31) + lo
    got = int(gw.reduce128_np(f, np.uint64(t >> 64),
                              np.uint64(t & ((1 << 64) - 1))))
    assert got == terms * (p - 1) % p
    # and through the mirror: many CTAs and warps of one row each, and the
    # most warps a CTA
    rng = np.random.default_rng(1)
    v, av = rand_res(rng, p, (40, 2)), rand_res(rng, p, (40, 2))
    want = gram_ints(p, v, av)
    np.testing.assert_array_equal(
        gw.gram_wide_tc_np(f, v, av, ctas=10, warps=4), want)
    np.testing.assert_array_equal(
        gw.gram_wide_tc_np(f, v, av, ctas=2, warps=gw.GW_MAX_CTA_WARPS), want)


# ---------------------------------------------------------------------------
# spmv_wide's narrow slab
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PRIMES)
def test_narrow_product_matches_python_ints(p):
    """Signed coefficients +-1, +-(2^31 - 1), 0 and random against x = 0,
    p - 1 and random, in runs past the fold (NARROW_FOLD entries)."""
    f = gw.GFpWide.make(p)
    rng = np.random.default_rng(p % 13)
    edge_c = [1, -1, CMAX, -CMAX, 0]
    edge_x = [0, p - 1]
    for c in edge_c:
        for x in edge_x:
            assert gw.narrow_dot_np(f, [c], [x]) == c * x % p
    cs = rng.choice(edge_c, 3 * gw.NARROW_FOLD + 5)
    xs = rng.choice(np.array(edge_x + [1, p // 2], np.int64), cs.size)
    assert gw.narrow_dot_np(f, cs, xs) == \
        sum(int(c) * int(x) for c, x in zip(cs, xs)) % p
    # the worst magnitude: every entry -(2^31 - 1) against p - 1
    n = 2 * gw.NARROW_FOLD + 1
    assert gw.narrow_dot_np(f, [-CMAX] * n, [p - 1] * n) == \
        -CMAX * (p - 1) * n % p
    cs = rng.integers(-CMAX, CMAX + 1, 700)
    xs = rand_res(rng, p, 700)
    assert gw.narrow_dot_np(f, cs, xs) == \
        sum(int(c) * int(x) for c, x in zip(cs, xs)) % p


def test_narrow_fold_bound():
    """After a fold a limb sum is below p < 2^62; each term is below
    (2^21 - 1)(2^31 - 1) < 2^52; 1023 terms keep it inside int64, 1024 of
    2^52 would not: the fold every NARROW_FOLD = 512 entries is safe."""
    term = ((1 << gw.NARROW_LIMB_BITS) - 1) * CMAX
    assert 3 * gw.NARROW_LIMB_BITS >= 62 and term < 1 << 52
    assert (1 << 62) + 1023 * term < 1 << 63
    assert (1 << 62) + 1024 * (1 << 52) >= 1 << 63
    assert gw.NARROW_FOLD <= 1023


@pytest.mark.parametrize("p", PRIMES)
def test_layout_picks_the_slab(p):
    f = gw.GFpWide.make(p)
    i = np.array([0, 0, 1, 2, 2, 2])
    j = np.array([0, 1, 1, 0, 1, 2])
    signed = np.array([1, -1, CMAX, -CMAX, 5, -7])
    op = two.make_wide_op(f, i, j, signed % p, 3, 3, ell=2)
    assert op.vals.dtype == torch.int32 and op.sp_vals.dtype == torch.int32
    got = np.concatenate([op.vals.numpy().T.ravel(), op.sp_vals.numpy()])
    reps = two.signed_coefficients(p, signed % p)
    assert sorted(got[got != 0].tolist()) == sorted(reps.tolist())
    # each its representative in (-p/2, p/2): the values themselves where
    # they lie there (2^31 - 1 < p / 2 above 2^32)
    assert (reps == signed).all() == (p > 1 << 32)
    forced = two.u64_slab(op)
    assert forced.vals.dtype == torch.int64
    assert forced.sp_vals.dtype == torch.int64
    assert two.u64_slab(forced) is forced
    np.testing.assert_array_equal(
        forced.vals.numpy(), np.remainder(op.vals.numpy().astype(np.int64), p))
    # one coefficient past 31 bits (if p allows one) takes the u64 slab
    big = np.append(signed, 1 << 31) % p
    i2, j2 = np.append(i, 1), np.append(j, 2)
    fits = p < 1 << 32     # 2^31 mod p is then small
    assert two.narrow_fits(p, big) == fits
    op2 = two.make_wide_op(f, i2, j2, big, 3, 3, ell=2)
    assert (op2.vals.dtype == torch.int32) == fits
    assert op2.sp_vals.dtype == op2.vals.dtype
    # the representative: r <= (p - 1) / 2 stays, r > (p - 1) / 2 is r - p
    reps = two.signed_coefficients(p, np.array([0, 1, p // 2, p // 2 + 1,
                                                p - 1]))
    assert reps.tolist() == [0, 1, p // 2, p // 2 + 1 - p, -1]


def narrow_matrix(rng, p, nrows, ncols):
    """Small signed coefficients (with +-1 and +-(2^31 - 1)) as residues,
    and one spill row longer than the narrow slab's fold."""
    from block_lanczos_tpu_torch.utils import gen
    i, j, _ = gen.random_sparse(nrows, ncols, 5, seed=4)
    i = np.concatenate([i, np.full(2 * gw.NARROW_FOLD + 40, nrows - 1)])
    j = np.concatenate([j, rng.integers(0, ncols, 2 * gw.NARROW_FOLD + 40)])
    c = rng.integers(-CMAX, CMAX + 1, i.size)
    c[:8] = [1, -1, CMAX, -CMAX, 1, -1, CMAX, -CMAX]
    return i.astype(np.int32), j.astype(np.int32), c % p


@pytest.mark.parametrize("p", PRIMES)
def test_both_slabs_match_jax(p):
    rng = np.random.default_rng(p % 31)
    nrows, ncols, n = 60, 45, 3
    i, j, x = narrow_matrix(rng, p, nrows, ncols)
    f, jf = gw.GFpWide.make(p), jgw.GFpWide.make(p)
    xv = rand_res(rng, p, (ncols, n))
    xv[0], xv[1] = 0, p - 1
    want = unpair(jwo.spmv_wide(jf, jwo.make_wide_hybrid_op(
        jf, i, j, x.astype(object), nrows, ncols), pairs(xv), out_rows=64))
    chosen = two.make_wide_op(f, i, j, x, nrows, ncols)
    for op, dtype in ((chosen, torch.int32),
                      (two.u64_slab(chosen), torch.int64)):
        assert op.vals.dtype == dtype and op.spill_nnz > 2 * gw.NARROW_FOLD
        got = two.spmv_wide(f, op, torch.from_numpy(xv), out_rows=64)
        np.testing.assert_array_equal(got.numpy(), want)
    # one row as the narrow kernel sums it, spill and all
    op = two.make_wide_op(f, i, j, x, nrows, ncols)
    r = nrows - 1
    cs = [int(c) for c in op.vals.numpy()[:, r]] + \
        [int(c) for c in op.sp_vals.numpy()[op.rowptr[r]:op.rowptr[r + 1]]]
    js = [int(c) for c in op.cols.numpy()[:, r]] + \
        [int(c) for c in op.sp_cols.numpy()[op.rowptr[r]:op.rowptr[r + 1]]]
    for col in range(n):
        assert gw.narrow_dot_np(f, cs, [xv[jj, col] for jj in js]) == \
            want[r, col]


@pytest.mark.parametrize("slab", ["chosen", "u64"])
def test_narrow_slab_on_a_layout_from_jax(slab):
    """A JAX WideHybridOp with small signed coefficients, carried over by
    wide_op_from_jax, takes the narrow slab, and gives JAX's result on it
    and on the u64 slab (u64_slab)."""
    p = P61
    rng = np.random.default_rng(12)
    nrows, ncols, n = 50, 40, 4
    i, j, x = narrow_matrix(rng, p, nrows, ncols)
    jf, f = jgw.GFpWide.make(p), gw.GFpWide.make(p)
    xv = rand_res(rng, p, (ncols, n))
    jop = jwo.make_wide_hybrid_op(jf, i, j, x.astype(object), nrows, ncols,
                                  ell=3)
    arrays = dict(out_dim=jop.out_dim, in_dim=jop.in_dim, nnz=jop.nnz,
                  ell=jop.ell, cols=np.asarray(jop.cols),
                  vals=np.asarray(jop.vals), spill_nnz=jop.spill.nnz,
                  spill_in_idx=np.asarray(jop.spill.in_idx),
                  spill_val_mont=np.asarray(jop.spill.val_mont),
                  spill_rowptr=np.asarray(jop.spill.rowptr))
    op = wide_op_from_jax(arrays, p)
    assert op.vals.dtype == torch.int32
    if slab == "u64":
        op = two.u64_slab(op)
        assert op.vals.dtype == torch.int64
    assert op.sp_vals.dtype == op.vals.dtype
    want = unpair(jwo.spmv_wide(jf, jop, pairs(xv)))
    got = two.spmv_wide(f, op, torch.from_numpy(xv))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# orthogonalize_wide: the shift classes, the row path's Montgomery sums
# ---------------------------------------------------------------------------

def ortho_ints(p, v, pb, av, rhs, d):
    """(v', p') of the update with Python ints."""
    n = v.shape[1]
    dm = d.astype(bool)[None, :]
    base = np.concatenate([np.where(dm, av, v), np.where(dm, 0, pb)], 1)
    out = (base.astype(object) + np.concatenate([v, pb], 1).astype(object)
           @ rhs.astype(object)) % p
    out = out.astype(np.int64)
    return out[:, :n], out[:, n:]


def ortho_inputs(rng, p, N, n):
    v, pb, av = (rand_res(rng, p, (N, n)) for _ in range(3))
    v[:3], pb[:3], av[:3] = p - 1, p - 1, p - 1
    rhs = rand_res(rng, p, (2 * n, 2 * n))
    rhs[n:, n:] = 0
    rhs[0] = p - 1
    d = rng.integers(0, 2, n)
    d[:2] = (0, 1)[:n]
    return v, pb, av, rhs, d


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [1, 3, 4, 8, 17, 32, 33])
def test_ortho_mirrors_match_python_ints(p, n):
    """The shift classes at every n, the row path up to OW_ROW_MAX_N, on
    random rows, rows and an rhs row of p - 1, mixed d."""
    rng = np.random.default_rng(p % 89 + n)
    f = gw.GFpWide.make(p)
    args = ortho_inputs(rng, p, 9, n)
    want = ortho_ints(p, *args)
    for got in [gw.ortho_wide_tc_np(f, *args)] + (
            [gw.ortho_row_np(f, *args)] if n <= gw.OW_ROW_MAX_N else []):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", [4, 32])
def test_ortho_mirrors_match_jax(p, n):
    """The rhs the port builds (wide_ops.orthogonalize_rhs) through both
    mirrors equals the JAX package's orthogonalize_device, whose product
    is wide_ops.matmul_mont on Montgomery pairs."""
    rng = np.random.default_rng(p % 61 + n)
    N = 20
    v, pb, av = (rand_res(rng, p, (N, n)) for _ in range(3))
    A, B, C = (rand_res(rng, p, (n, n)) for _ in range(3))
    U, UA = (A + A.T) % p, (B + B.T) % p
    d = rng.integers(0, 2, n)
    jf = jgw.GFpWide.make(p)
    want_v, want_p = jlw.orthogonalize_device(
        jf, pairs(v), pairs(av), pairs(pb),
        jnp.asarray(d.astype(np.uint32)), pairs(U), pairs(UA), pairs(C))
    rhs = two.orthogonalize_rhs(p, torch.from_numpy(U), torch.from_numpy(UA),
                                torch.from_numpy(C),
                                torch.from_numpy(d)).numpy()
    f = gw.GFpWide.make(p)
    for mirror in (gw.ortho_wide_tc_np,
                   gw.ortho_row_np)[:2 if n <= gw.OW_ROW_MAX_N else 1]:
        got_v, got_p = mirror(f, v, pb, av, rhs, d)
        np.testing.assert_array_equal(got_v, unpair(want_v))
        np.testing.assert_array_equal(got_p, unpair(want_p))


def test_ortho_limb_sums_fit_s32_at_their_widest_n():
    """Every residue and rhs entry p - 1 at the largest prime and n = 64:
    each shift class below 2^31, all 15 below 2^29 (the mirror asserts
    both), with the margins the kernel's header states; the update equals
    Python ints."""
    p, n = P62, gw.OW_MAX_N
    assert 8 * 2 * n * 255 ** 2 == 66_585_600 < 1 << 31
    assert 64 * 2 * n * 255 ** 2 < 1 << 29
    full = np.full((16, n), p - 1, np.int64)
    rhs = np.full((2 * n, 2 * n), p - 1, np.int64)
    rhs[n:, n:] = 0
    S = gw.ortho_class_sums_np(full, full, rhs)
    # class 7 holds 8 limb pairs; p - 1's top limb is below 2^6
    assert S.shape == (gw.OW_CLASSES, 16, 2 * n) and S.max() < 1 << 31
    assert S.sum(0).max() < 1 << 29
    d = np.array([0, 1] * (n // 2))
    f = gw.GFpWide.make(p)
    got = gw.ortho_wide_tc_np(f, full, full, full, rhs, d)
    want = ortho_ints(p, full, full, full, rhs, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("p", PRIMES)
def test_ortho_row_path_with_the_base_in_the_high_word(p):
    """The row path's lazy sum from base 2^64 at its worst case (every x,
    rhs~ and base p - 1, n = OW_ROW_MAX_N: a fold inside the v' columns'
    16 products) stays below 2^128 (asserted inside), and the budget
    holds for every p < 2^62; the weights of the tensor-core path are
    2^(8q) 2^64 mod p."""
    cap = 1 << 62
    assert (cap << 64) + gw.WIDE_FOLD * cap ** 2 < 1 << 128
    n = gw.OW_ROW_MAX_N
    f = gw.GFpWide.make(p)
    full = np.full((2, n), p - 1, np.int64)
    rhs = np.full((2 * n, 2 * n), p - 1, np.int64)
    d = np.zeros(n, np.int64)
    got = gw.ortho_row_np(f, full, full, full, rhs, d)
    rhs[n:, n:] = 0      # the block the kernel never reads
    want = ortho_ints(p, full, full, full, rhs, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert gw.ortho_weights_np(f) == [pow(2, 8 * q + 64, p)
                                      for q in range(gw.OW_CLASSES)]


# ---------------------------------------------------------------------------
# semi_inverse_wide: the binary inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PRIMES)
def test_mont_inverse_matches_pow_and_jax(p):
    """a in {1, 2, p - 1, 2^k, random}: the Montgomery form of a^-1 from
    that of a equals pow(a, -1, p) 2^64 mod p and the JAX package's
    modinv_device; the almost inverse takes k in [bitlen(p), 2 bitlen(p)]
    bit steps, in at most k of the kernel's subtraction steps."""
    rng = np.random.default_rng(p % 53)
    m = p.bit_length()
    vals = [1, 2, p - 1] + [1 << k for k in (3, 29, m - 1)] + \
        [int(x) for x in rand_res(rng, p, 20) if x]
    f = gw.GFpWide.make(p)
    R = 1 << 64
    got, steps = zip(*(gw.mont_inverse_np(f, a * R % p) for a in vals))
    assert list(got) == [pow(a, -1, p) * R % p for a in vals]
    for a, n in zip(vals, steps):
        x, k, n2 = gw.almost_inverse_np(p, a)
        assert n == n2 and 1 <= n <= k and m <= k <= 2 * m
        assert x == pow(a, -1, p) * pow(2, k, p) % p
    jinv = unpair(jgw.modinv_device(jgw.GFpWide.make(p),
                                    pairs(np.array(vals, object))))
    assert [g * pow(R, -1, p) % p for g in got] == jinv.tolist()
    # a = 1 takes the fewest bit steps, k = m <= 64 (the Barrett end of
    # the correction); a random residue at 2^61 - 1 or above takes k > 64
    x, k, n = gw.almost_inverse_np(p, 1)
    assert k == m and x == pow(2, k, p)


# ---------------------------------------------------------------------------
# The CUDA sources' constants
# ---------------------------------------------------------------------------

def define(name, macro):
    src = (kernels.CSRC / name).read_text()
    return int(re.search(rf"#define {macro} \(?(\d+)", src).group(1))


def test_constants_match_the_redesigned_kernels():
    assert define("gram_wide.cu", "GW_LIMBS") == gw.GW_LIMBS
    assert define("gram_wide.cu", "GW_FOLDED_MAX_N") == gw.GW_FOLDED_MAX_N
    assert define("gram_wide.cu", "GW_FOLDED_FOLD_ROWS") == \
        gw.GW_FOLDED_FOLD_ROWS
    assert define("gram_wide.cu", "GW_CLASS_FOLD_ROWS") == \
        gw.GW_CLASS_FOLD_ROWS
    assert define("gram_wide.cu", "GW_MAX_CTAS") == gw.GW_MAX_CTAS
    assert define("gram_wide.cu", "GW_MAX_CTA_WARPS") == gw.GW_MAX_CTA_WARPS
    src = (kernels.CSRC / "gram_wide.cu").read_text()
    assert "#define GW_CLASSES (2 * GW_LIMBS - 1)" in src
    assert gw.GW_CLASSES == 2 * gw.GW_LIMBS - 1
    # the classes take over right after the folded limbs by default
    assert "#define GW_CLASS_MIN_N (GW_FOLDED_MAX_N + 1)" in src
    assert define("spmv_wide.cu", "SPMV_WIDE_NARROW_FOLD") == gw.NARROW_FOLD
    assert define("spmv_wide.cu", "SPMV_WIDE_LIMB_BITS") == \
        gw.NARROW_LIMB_BITS
    assert two.NARROW_COEF_MAX == CMAX
    # orthogonalize_wide's limbs, classes and paths
    assert define("orthogonalize_wide.cu", "OW_LIMBS") == gw.OW_LIMBS
    assert define("orthogonalize_wide.cu", "OW_ROW_MAX_N") == \
        gw.OW_ROW_MAX_N
    assert define("orthogonalize_wide.cu", "OW_MAX_N") == gw.OW_MAX_N
    src = (kernels.CSRC / "orthogonalize_wide.cu").read_text()
    assert "#define OW_CLASSES (2 * OW_LIMBS - 1)" in src
    assert gw.OW_CLASSES == 2 * gw.OW_LIMBS - 1
    assert define("orthogonalize_wide.cu", "OW_MMA_MIN_N") == \
        gw.OW_MMA_MIN_N
    assert 1 <= gw.OW_MMA_MIN_N <= gw.OW_ROW_MAX_N + 1
    # semi_inverse_wide's one-warp elimination holds n^2 <= 32 entries
    reg = define("semi_inverse_wide.cu", "SIW_REG_MAX_N")
    assert 0 <= reg and reg ** 2 <= 32
    assert "mont_inverse(s.pref[n], f, steps)" in \
        (kernels.CSRC / "semi_inverse_wide.cu").read_text()
    assert "inv_mont" not in (kernels.CSRC / "modp64.cuh").read_text()
    # the narrow flag rides between sp_vals and x
    args = kernels.SIGNATURES["spmv_wide"][1]
    assert args[7] == kernels._I and args.count(kernels._P) == 8
