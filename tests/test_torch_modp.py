"""The kernels' mod-p arithmetic (csrc/modp.cuh), through its host mirrors in
the port's ops/gfp.py, against Python's `%` and `pow`, and against the JAX
package's field where it has the same function.

Barrett reduction with the host constant mu = floor(2^64 / p) for any u64,
its 32-bit step (m = mu >> 32) for any u32, the short reduction (32-bit multiplies, constants derived from mu) for
products and two-term sums, the Fermat inverse on short-Barrett products,
and the lazy sums (raw products folded once every LAZY_FOLD terms) at their
worst case: every term (p - 1)^2, at the fold length and past it.
Tolerance zero.
"""

import re

import numpy as np
import pytest

from block_lanczos_tpu.ops import dense as jdense
from block_lanczos_tpu.ops import gfp as jgfp
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops import gfp as tgfp

PRIMES = [2, 3, 65537, 1073741789, (1 << 30) - 35]


@pytest.mark.parametrize("p", PRIMES)
def test_barrett_mu_host_constant(p):
    mu = tgfp.barrett_mu(p)
    assert mu == (1 << 64) // p
    assert mu * p <= 1 << 64 < (mu + 1) * p
    assert tgfp.barrett_mu(p) is mu       # computed once per prime
    assert mu < 1 << 64                   # fits the kernels' u64 argument


def test_barrett_mu_rejects_out_of_range():
    for bad in (0, 1, 1 << 63):
        with pytest.raises(ValueError):
            tgfp.barrett_mu(bad)


def _u64_cases(p, kind, rng):
    if kind == "edges":
        base = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, (p - 1) ** 2,
                (p - 1) ** 2 + p - 1, (1 << 64) - 1, 1 << 63, (1 << 63) - 1,
                (1 << 64) - p, ((1 << 64) - 1) // p * p]
        return np.array([b for b in base if b < 1 << 64], np.uint64)
    if kind == "products":  # a * b for a, b in {0, 1, p - 1} and at random
        a = np.concatenate([[0, 1, p - 1, 0, p - 1, 1],
                            rng.integers(0, p, 2000)]).astype(np.uint64)
        b = np.concatenate([[p - 1, p - 1, p - 1, 0, 1, 1],
                            rng.integers(0, p, 2000)]).astype(np.uint64)
        return a * b
    return rng.integers(0, np.iinfo(np.uint64).max, 4000, dtype=np.uint64,
                        endpoint=True)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("kind", ["edges", "products", "full_u64"])
def test_barrett_reduce_matches_mod(p, kind):
    x = _u64_cases(p, kind, np.random.default_rng(p % 1000 + len(kind)))
    got = tgfp.barrett_reduce_np(x, p)
    want = np.array([int(v) % p for v in x], np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", PRIMES + [(1 << 16) + 1])
def test_barrett_reduce32_matches_mod(p):
    """psum_mod's 32-bit fold: m = mu >> 32 is floor(2^32 / p), and the
    step is exact at 0, p - 1, the largest int32 sum of R ranks' residues
    R (p - 1) <= 2^31 - 1, 2^32 - 1 and across the u32 range."""
    assert tgfp.barrett_mu(p) >> 32 == (1 << 32) // p
    R = ((1 << 31) - 1) // (p - 1)
    edges = [0, 1, p - 1, p, R * (p - 1), (1 << 31) - 1, 1 << 31,
             (1 << 32) - 1]
    rng = np.random.default_rng(p % 1009)
    x = np.concatenate([np.array(edges, np.uint64),
                        rng.integers(0, 1 << 32, 4000, dtype=np.uint64)])
    got = tgfp.barrett_reduce32_np(x, p)
    assert got.dtype == np.uint32
    assert got.tolist() == [int(v) % p for v in x]


@pytest.mark.parametrize("p", PRIMES)
def test_short_barrett_constants(p):
    """mu_k, derived on the device as mu >> (64 - 2k), is floor(2^(2k)/p)
    and fits the 32-bit multiply the kernels use."""
    k, mu_k = tgfp.short_barrett(p)
    assert 1 << (k - 1) <= p < 1 << k and k <= 30
    assert mu_k == (1 << (2 * k)) // p
    assert (1 << k) < mu_k <= 1 << (k + 1) and mu_k < 1 << 32


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("kind", ["edges", "random"])
def test_reduce_short_matches_mod(p, kind):
    """Every x < 2^(2k+1): the products of two residues, the kernels'
    two-term sums a * R + (p - b) * R_P (at most 2p^2), and the range's
    top."""
    k, _ = tgfp.short_barrett(p)
    top = 1 << (2 * k + 1)
    if kind == "edges":
        x = [0, 1, p - 1, p, 2 * p - 1, 4 * p - 1, (p - 1) ** 2,
             (p - 1) ** 2 + p * (p - 1), 2 * p * p - 1, top - 1, top - p,
             (1 << (2 * k)) - 1, 1 << (2 * k)]
        x = np.array([v for v in x if v < top], np.uint64)
    else:
        rng = np.random.default_rng(p % 977)
        x = rng.integers(0, top, 5000, dtype=np.uint64)
    got = tgfp.reduce_short_np(x, p)
    np.testing.assert_array_equal(
        got, np.array([int(v) % p for v in x], np.uint64))


@pytest.mark.parametrize("p", PRIMES)
def test_umul64hi_matches_python(p):
    rng = np.random.default_rng(p % 997)
    a = np.concatenate([rng.integers(0, np.iinfo(np.uint64).max, 500,
                                     dtype=np.uint64, endpoint=True),
                        np.array([0, 1, (1 << 64) - 1], np.uint64)])
    mu = np.uint64(tgfp.barrett_mu(p))
    got = tgfp.umul64hi_np(a, mu)
    want = np.array([(int(v) * int(mu)) >> 64 for v in a], np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [3, 65537])
def test_inv_fermat_every_residue(p):
    a = np.arange(1, p, dtype=np.uint64)
    inv = tgfp.inv_fermat_np(a, p)
    np.testing.assert_array_equal(inv * a % np.uint64(p), np.ones_like(a))
    np.testing.assert_array_equal(
        inv, np.array([pow(int(v), p - 2, p) for v in a], np.uint64))


@pytest.mark.parametrize("p", PRIMES)
def test_inv_fermat_matches_pow_and_jax(p):
    rng = np.random.default_rng(p % 991)
    a = np.unique(np.concatenate([[1, p - 1], rng.integers(1, p, 300)])) \
        if p > 2 else np.array([1])
    a = a[a > 0].astype(np.uint64)
    inv = tgfp.inv_fermat_np(a, p)
    np.testing.assert_array_equal(
        inv, np.array([pow(int(v), p - 2, p) for v in a], np.uint64))
    want = np.asarray(jgfp.modinv_device(
        jgfp.GFp.make(p), a.astype(np.uint32)))
    np.testing.assert_array_equal(inv, want.astype(np.uint64))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("length", [1, tgfp.LAZY_FOLD, tgfp.LAZY_FOLD + 1,
                                    2 * tgfp.LAZY_FOLD + 1, 333])
def test_lazy_sum_worst_case(p, length):
    """Every term (p - 1)^2, at the fold length, one past it, and long."""
    terms = [p - 1] * length
    assert tgfp.lazy_dot_int(p, terms, terms) == length * (p - 1) ** 2 % p


@pytest.mark.parametrize("p", PRIMES)
def test_lazy_sum_random_matches_mod(p):
    rng = np.random.default_rng(p % 983)
    a = rng.integers(0, p, 77)
    b = rng.integers(0, p, 77)
    want = sum(int(x) * int(y) for x, y in zip(a, b)) % p
    assert tgfp.lazy_dot_int(p, a, b) == want


def test_lazy_fold_bound_and_kernel_constant():
    """A reduced accumulator plus LAZY_FOLD worst-case products stays in
    u64 at the largest prime; 17 would not; csrc/modp.cuh uses the same
    LAZY_FOLD as the host mirror."""
    p = tgfp.PRIME_CAP
    assert (p - 1) + tgfp.LAZY_FOLD * (p - 1) ** 2 < 1 << 64
    assert (p - 1) + 16 * (p - 1) ** 2 < 1 << 64 <= 17 * (p - 1) ** 2
    src = (kernels.CSRC / "modp.cuh").read_text()
    m = re.search(r"#define LAZY_FOLD (\d+)", src)
    assert m and int(m.group(1)) == tgfp.LAZY_FOLD
    assert tgfp.LAZY_FOLD & (tgfp.LAZY_FOLD - 1) == 0  # the kernels mask by it


# ---------------------------------------------------------------------------
# The tensor-core arithmetic (csrc/mma_u8.cuh): u8 limbs, s32 shift classes
# ---------------------------------------------------------------------------

MMA_NS = [1, 3, 4, 16, 31, 32, 33, 64]


def _exact_matmul(A, B, base=None):
    A, B = np.asarray(A).astype(object), np.asarray(B).astype(object)
    C = A @ B
    return C if base is None else C + np.asarray(base).astype(object)


@pytest.mark.parametrize("p", PRIMES)
def test_limb_weights_match_pow(p):
    assert tgfp.limb_weights_np(p) == [pow(2, 8 * s, p) for s in range(7)]


def test_limb_fold_interval_and_kernel_constants():
    """4 limb pairs of 255^2 per term fit s32 for 8192 terms, not for
    8257; the recombination of 8192 rows stays in u64; the kernels' headers
    use the host's constants."""
    assert 4 * tgfp.MMA_FOLD_ROWS * 255 ** 2 < 1 << 31 <= 4 * 8257 * 255 ** 2
    assert (1 << 30) + (1 << 30) * 16 * tgfp.MMA_FOLD_ROWS * 255 ** 2 \
        < 1 << 64
    src = (kernels.CSRC / "mma_u8.cuh").read_text()
    assert int(re.search(r"#define MMA_FOLD_ROWS (\d+)", src).group(1)) \
        == tgfp.MMA_FOLD_ROWS
    assert int(re.search(r"#define MMA_CLASSES (\d+)", src).group(1)) \
        == tgfp.LIMB_CLASSES
    assert "mulmod(" not in (kernels.CSRC / "modp.cuh").read_text()
    for name in ("gram_mod", "orthogonalize"):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert "barrett_reduce" in src and "mma_limb_classes" in src, name


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("n", MMA_NS)
def test_limb_matmul_matches_mod_and_jax(p, n):
    """[v | p] (N, 2n) x rhs (2n, 2n) plus a reduced base, through the
    limb mirror, against exact integers and the JAX package's
    dense.matmul_mod; one row and one rhs column at p - 1."""
    rng = np.random.default_rng(p % 1009 + n)
    A = rng.integers(0, p, (9, 2 * n), dtype=np.int64)
    B = rng.integers(0, p, (2 * n, 2 * n), dtype=np.int64)
    B[n:, n:] = 0
    A[0], B[:, 0] = p - 1, p - 1
    base = rng.integers(0, p, (9, 2 * n), dtype=np.int64)
    got = tgfp.limb_matmul_np(A, B, p, base)
    np.testing.assert_array_equal(got.astype(object),
                                  _exact_matmul(A, B, base) % p)
    want = np.asarray(jdense.matmul_mod(jgfp.GFp.make(p),
                                        A.astype(np.uint32),
                                        B.astype(np.uint32)))
    np.testing.assert_array_equal(tgfp.limb_matmul_np(A, B, p),
                                  want.astype(np.uint64))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("K", [1, 32, 128, tgfp.MMA_FOLD_ROWS])
def test_limb_worst_case(p, K):
    """Every residue p - 1 over the longest contractions the kernels run
    (orthogonalize K = 2n <= 128, gram_mod 8192 rows between folds)."""
    A = np.full((2, K), p - 1, np.int64)
    B = np.full((K, 3), p - 1, np.int64)
    got = tgfp.limb_matmul_np(A, B, p, np.full((2, 3), p - 1))
    want = (p - 1 + K * (p - 1) ** 2) % p
    assert (got == want).all()


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("N,fold", [(1, 8), (200, 64), (257, 256),
                                    (3 * tgfp.MMA_FOLD_ROWS + 5,
                                     tgfp.MMA_FOLD_ROWS)])
def test_mma_gram_mirror_across_folds(p, N, fold):
    rng = np.random.default_rng(N + p % 101)
    X = rng.integers(0, p, (N, 2), dtype=np.int64)
    W = rng.integers(0, p, (N, 1), dtype=np.int64)
    X[-1], W[-1] = p - 1, p - 1
    got = tgfp.mma_gram_np(X, W, p, fold)
    np.testing.assert_array_equal(got.astype(object),
                                  _exact_matmul(X.T, W) % p)


@pytest.mark.parametrize("p", PRIMES)
def test_warp_reduce_scatter_lane_holds_its_output(p):
    """Lane L ends with output L >> 1 of its parity's block, summed over
    the 16 lanes of that parity."""
    rng = np.random.default_rng(p % 89)
    vals = rng.integers(0, p, (32, 16), dtype=np.int64)
    vals[0] = p - 1
    got = tgfp.warp_reduce_scatter_np(vals, p)
    want = [vals[lane & 1::2, lane >> 1].sum() % p for lane in range(32)]
    np.testing.assert_array_equal(got, want)
    full = np.full((32, 16), p - 1, np.int64)
    np.testing.assert_array_equal(tgfp.warp_reduce_scatter_np(full, p),
                                  np.full(32, 16 * (p - 1) % p))


@pytest.mark.parametrize("p", PRIMES)
def test_lazy_sum_from_a_reduced_base(p):
    """The CUDA-core paths start their lazy sum at the reduced base
    (where(d, Av, v) or where(d, 0, p)), then fold as before."""
    terms = [p - 1] * (2 * tgfp.LAZY_FOLD + 3)
    want = (p - 1 + len(terms) * (p - 1) ** 2) % p
    assert tgfp.lazy_dot_int(p, terms, terms, p - 1) == want
