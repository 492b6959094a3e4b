"""The port's wide field (2^30 - 35 < p < 2^62) below the solver, against
Python ints and the JAX package, tolerance 0:

  * mmio's wide branch and the xoshiro fill_mod64 against the JAX package;
  * the plain int64 field operations (ops/gfp_wide.py) at edge values of
    the first wide prime, 2^61 - 1, a 55-bit prime and the largest prime
    below 2^62;
  * the NumPy mirrors of csrc/modp64.cuh (the 128-bit product, REDC, the
    Barrett fold, reduce128, the lazy-sum budget, the binary Montgomery
    inverse) against Python ints, the budget at its worst case;
  * the checker's wide branch against the JAX checker.
"""

import numpy as np
import pytest
import torch

from block_lanczos_tpu.utils import checker as jchecker
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu.utils.rng import Xoshiro256Plus as JXoshiro
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.utils import checker as tchecker
from block_lanczos_tpu_torch.utils import gen
from block_lanczos_tpu_torch.utils import mmio as tmmio
from block_lanczos_tpu_torch.utils.rng import Xoshiro256Plus

P30 = 1073741827                  # 2^30 + 3, the first wide prime
P55 = 36028797018963913           # a 55-bit prime
P61 = (1 << 61) - 1
P62 = 4611686018427387847         # the largest prime below 2^62
PRIMES = [P30, P55, P61, P62]


def edge_values(p):
    vals = [0, 1, 2, p - 2, p - 1, p // 2, (1 << 31) - 1, 1 << 31,
            (1 << 32) - 1, (1 << 61) + 12345, p - (1 << 31)]
    return [v for v in vals if 0 <= v < p]


# ---------------------------------------------------------------------------
# mmio and the random stream
# ---------------------------------------------------------------------------

def test_wide_load_mtx_matches_jax(tmp_path):
    """p + 5 loads as 5, -1 as p - 1, as uint64: the JAX loader's wide
    branch (the port read every coefficient through uint32 before)."""
    path = str(tmp_path / "w.mtx")
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write("2 3 5\n")
        fh.write(f"1 1 {P61 + 5}\n1 2 -1\n2 2 7\n2 3 {(1 << 62) + 9}\n")
        fh.write(f"1 3 {-(P61 + 2)}\n")
    for p in (P61, P62, P30):
        got, want = tmmio.load_mtx(path, p), jmmio.load_mtx(path, p)
        assert got.x.dtype == np.uint64 == want.x.dtype
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.i, want.i)
        np.testing.assert_array_equal(got.j, want.j)
    assert list(tmmio.load_mtx(path, P61).x) == [
        5, P61 - 1, 7, ((1 << 62) + 9) % P61, (-(P61 + 2)) % P61]
    # the narrow branch keeps the reference's u32 reading
    narrow = tmmio.load_mtx(path, 65537)
    assert narrow.x.dtype == np.uint32
    np.testing.assert_array_equal(narrow.x, jmmio.load_mtx(path, 65537).x)


@pytest.mark.parametrize("p", PRIMES)
def test_fill_mod64_matches_jax(p):
    count = 5003                       # odd: the lanes end mid-row
    t, j = Xoshiro256Plus(), JXoshiro()
    got = t.fill_mod64(count, p)
    want = j.fill_mod64(count, p)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    # both generators continue with the same state
    np.testing.assert_array_equal(t.fill_mod64(17, p), j.fill_mod64(17, p))


def test_fill_mod64_equals_fill_mod_at_a_narrow_prime():
    p = gen.BENCH_PRIME
    a = Xoshiro256Plus().fill_mod(40000, p)
    b = Xoshiro256Plus().fill_mod64(40000, p)
    assert b.dtype == np.uint64
    np.testing.assert_array_equal(a.astype(np.uint64), b)


# ---------------------------------------------------------------------------
# The field context and the plain int64 operations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PRIMES)
def test_field_constants(p):
    f = gw.GFpWide.make(p)
    assert f.mu == (1 << 64) // p
    assert (f.pinv * p + 1) % (1 << 64) == 0
    assert f.r2 == pow(2, 128, p)
    assert f.kernel_args == (p, f.mu, f.pinv, f.r2)
    assert all(0 <= a < 1 << 64 for a in f.kernel_args)
    assert f.invmod(3) * 3 % p == 1


def test_field_refuses_bad_primes():
    for bad in (2, 4, 1 << 62, (1 << 62) + 1):
        with pytest.raises(ValueError):
            gw.GFpWide.make(bad)


@pytest.mark.parametrize("p", PRIMES)
def test_plain_ops_match_python_ints(p):
    vals = edge_values(p)
    rng = np.random.default_rng(p % 1000)
    vals += [int(v) % p for v in rng.integers(0, 1 << 62, 40)]
    a = torch.tensor([x for x in vals for _ in vals], dtype=torch.int64)
    b = torch.tensor([y for _ in vals for y in vals], dtype=torch.int64)
    A, B = a.tolist(), b.tolist()
    assert gw.mulmod(p, a, b).tolist() == [x * y % p for x, y in zip(A, B)]
    assert gw.modadd(p, a, b).tolist() == [(x + y) % p for x, y in zip(A, B)]
    assert gw.modsub(p, a, b).tolist() == [(x - y) % p for x, y in zip(A, B)]
    assert gw.modneg(p, a).tolist() == [(-x) % p for x in A]
    assert gw.shl_mod(p, a, 31).tolist() == [(x << 31) % p for x in A]
    nz = torch.tensor([v for v in vals if v], dtype=torch.int64)
    assert gw.modinv(p, nz).tolist() == [pow(x, -1, p) for x in nz.tolist()]
    assert gw.modpow(p, nz, 12345).tolist() == \
        [pow(x, 12345, p) for x in nz.tolist()]


@pytest.mark.parametrize("p", [P61, P62])
def test_plain_sums_and_products_match_python_ints(p):
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.integers(0, 1 << 62, (300, 5)) % p)
    X[:50] = p - 1                                   # the worst case
    B = torch.from_numpy(rng.integers(0, 1 << 62, (5, 3)) % p)
    Xo, Bo = X.numpy().astype(object), B.numpy().astype(object)
    assert gw.sum_mod(p, X, 0).tolist() == list(Xo.sum(0) % p)
    np.testing.assert_array_equal(gw.matmul_mod(p, X, B).numpy(),
                                  ((Xo @ Bo) % p).astype(np.int64))
    idx = torch.from_numpy(rng.integers(0, 7, 300))
    got = gw.index_add_mod(p, 7, idx, X)
    want = np.zeros((7, 5), object)
    for r, row in zip(idx.tolist(), Xo):
        want[r] = (want[r] + row) % p
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# NumPy mirrors of csrc/modp64.cuh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PRIMES)
def test_mirrors_of_the_kernel_reductions(p):
    f = gw.GFpWide.make(p)
    vals = edge_values(p)
    a = np.array([x for x in vals for _ in vals], np.uint64)
    b = np.array([y for _ in vals for y in vals], np.uint64)
    lo, hi = gw.mul128_np(a, b)
    prods = [int(x) * int(y) for x, y in zip(a, b)]
    assert [(int(h) << 64) | int(l) for h, l in zip(hi, lo)] == prods
    R = 1 << 64
    rinv = pow(R, -1, p)
    assert gw.mont_mul_np(f, a, b).tolist() == \
        [t * rinv % p for t in prods]
    # reduce128 and the fold over the whole 128-bit range
    big = [0, 1, p, p * p - 1, (1 << 128) - 1, (1 << 127) + 3,
           (p - 1) << 64, ((1 << 64) - 1) << 64] + prods
    his = np.array([t >> 64 for t in big], np.uint64)
    los = np.array([t & (R - 1) for t in big], np.uint64)
    assert gw.reduce128_np(f, his, los).tolist() == [t % p for t in big]
    folded = gw.fold_np(f, his)
    assert (folded < p).all()
    assert all(((int(h) << 64) + int(l)) % p == t % p
               for h, l, t in zip(folded, los, big))
    assert gw.redc_np(f, folded, los).tolist() == \
        [t * rinv % p for t in big]
    # REDC refuses an input at or above p * 2^64
    with pytest.raises(AssertionError):
        gw.redc_np(f, np.uint64(p), np.uint64(0))
    # the Montgomery forms and the binary inverse
    nz = np.array([v for v in vals if v], np.uint64)
    am = gw.to_mont_np(f, nz)
    assert am.tolist() == [int(x) * R % p for x in nz]
    assert [gw.mont_inverse_np(f, int(x))[0] for x in am] == \
        [pow(int(x), -1, p) * R % p for x in nz]


@pytest.mark.parametrize("p", PRIMES)
def test_lazy_sum_budget_at_its_worst_case(p):
    """Every product (p - 1)^2 from a base of p - 1, over sums longer than
    the fold (a full ELL row, a long spill segment, a Gram over bench
    rows): the 128-bit accumulator never wraps (asserted inside) and the
    result is the residue of the sum."""
    f = gw.GFpWide.make(p)
    assert (p << 64) + gw.WIDE_FOLD * (p - 1) ** 2 + p < 1 << 128
    # csrc/modp64.cuh: 11 products are safe for every p < 2^62, 12 are not
    # at the bound itself
    cap = 1 << 62
    assert (cap << 64) + 11 * cap ** 2 + cap < 1 << 128 \
        <= (cap << 64) + 12 * cap ** 2
    for k in (1, 7, 8, 9, 23, 600):
        a = [p - 1] * k
        assert gw.lazy_dot_wide(f, a, a, p - 1) == \
            (p - 1 + k * (p - 1) ** 2) % p
    # a Gram column over the bench's 300,000 rows, in one long sum
    k = 300_000
    a = [p - 1] * k
    assert gw.lazy_dot_wide(f, a, a) == k * (p - 1) ** 2 % p
    rng = np.random.default_rng(3)
    a = [int(v) % p for v in rng.integers(0, 1 << 62, 1000)]
    b = [int(v) % p for v in rng.integers(0, 1 << 62, 1000)]
    assert gw.lazy_dot_wide(f, a, b, 5) == \
        (5 + sum(x * y for x, y in zip(a, b))) % p


# ---------------------------------------------------------------------------
# The checker's wide branch against the JAX checker
# ---------------------------------------------------------------------------

def _write_mtx(path, nrows, ncols, i, j, x):
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{nrows} {ncols} {len(x)}\n")
        for a, b, c in zip(i, j, x):
            fh.write(f"{a + 1} {b + 1} {c}\n")


def _kernel_of(p, nrows, ncols, i, j, x, n=3):
    """n left-kernel vectors of a matrix with nrows > ncols, on the host
    with Python ints: a nullspace basis of M^T by Gauss-Jordan."""
    A = np.zeros((ncols, nrows), object)
    for a, b, c in zip(i, j, x):
        A[b, a] = (A[b, a] + int(c)) % p
    R, piv, row = A.copy(), [], 0
    for col in range(nrows):
        nz = [r for r in range(row, ncols) if R[r, col] % p]
        if not nz:
            continue
        R[[row, nz[0]]] = R[[nz[0], row]]
        R[row] = R[row] * pow(int(R[row, col]), -1, p) % p
        for r in range(ncols):
            if r != row and R[r, col]:
                R[r] = (R[r] - R[r, col] * R[row]) % p
        piv.append(col)
        row += 1
    free = [c for c in range(nrows) if c not in piv][:n]
    K = np.zeros((nrows, len(free)), object)
    for k, fc in enumerate(free):
        K[fc, k] = 1
        for r, c in enumerate(piv):
            K[c, k] = (-R[r, fc]) % p
    return K.astype(np.uint64)


@pytest.mark.parametrize("p,right", [(P61, False), (P62, False),
                                     (P55, True)])
def test_wide_checker_matches_jax(tmp_path, p, right):
    """Accept a true kernel block, reject a perturbed one and entries >= p,
    exactly as the JAX checker does (raw values include negatives and
    values above p)."""
    rng = np.random.default_rng(p % 977)
    nrows, ncols = 40, 28
    i, j, _ = gen.random_sparse(nrows, ncols, 4, seed=9)
    x = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, len(i))]
    x[0], x[1] = -1, p + 5
    path = str(tmp_path / "m.mtx")
    _write_mtx(path, *((ncols, nrows, j, i) if right else
                       (nrows, ncols, i, j)), x)
    K = _kernel_of(p, nrows, ncols, i, j, [v % p for v in x])
    for mod in (tchecker, jchecker):
        assert mod.check_kernel_block(path, K, p, right=right) is True
    bad = K.copy()
    bad[3, 0] = (int(bad[3, 0]) + 1) % p
    over = K.copy()
    over[0, 0] = p
    for block, msg in ((bad, "KO: y"), (over, "out of bound")):
        for mod in (tchecker, jchecker):
            with pytest.raises(mod.CheckFailure, match=msg):
                mod.check_kernel_block(path, block, p, right=right)
    kpath = str(tmp_path / "k.mtx")
    tmmio.write_kernel_mtx(kpath, K, nrows, K.shape[1])
    assert tchecker.main(["--matrix", path, "--kernel", kpath, "--prime",
                          str(p)] + (["--right"] if right else [])) == 0
    with pytest.raises(ValueError, match="2 <= p < 2"):
        tchecker.check_kernel_block(path, K, 1 << 62)


# ---------------------------------------------------------------------------
# The Python side's constants against the CUDA sources
# ---------------------------------------------------------------------------

def test_constants_match_the_wide_kernels():
    import re

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import wide_ops
    from block_lanczos_tpu_torch.utils import kernel_sweeps as ks

    def define(name, macro):
        src = (kernels.CSRC / name).read_text()
        return int(re.search(rf"#define {macro} \(?(\d+)", src).group(1))

    assert define("modp64.cuh", "WIDE_FOLD") == gw.WIDE_FOLD
    assert define("semi_inverse_wide.cu", "SIW_MAXN") == wide_ops.MAX_N
    assert define("orthogonalize_wide.cu", "OW_MAX_N") == wide_ops.MAX_N
    src = (kernels.CSRC / "gram_wide.cu").read_text()
    # the scratch: two 31-bit halves an entry of the largest G, the ticket
    assert define("gram_wide.cu", "GW_MAX_N") == wide_ops.MAX_N
    for line in ("#define GW_MAX_OUT (2 * GW_MAX_N * GW_MAX_N)",
                 "#define GW_HALVES (2 * GW_MAX_OUT)",
                 "#define GW_SCRATCH (GW_HALVES + 1)"):
        assert line in src, line
    assert wide_ops._GRAM_SCRATCH == 2 * 2 * wide_ops.MAX_N ** 2 + 1
    for name in ks.WIDE_KERNELS:
        assert (kernels.CSRC / f"{name}.cu").exists()
        assert kernels.SIGNATURES[name][0] == name
        # the wide wrappers pass (p, mu, pinv, r2) as four u64 arguments
        assert kernels.SIGNATURES[name][1].count(kernels._U) == 4
    # every macro the design sweeps vary is a knob of its kernel
    for name, defines in ks._variants(list(ks.WIDE_KERNELS)):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        for macro in defines:   # read by a preprocessor conditional
            assert re.search(rf"^#if.*\b{macro}\b", src, re.M), \
                (name, macro)


def test_kernel_sweeps_wide_timeline_slots_match_the_kernel():
    import re

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import wide_ops
    from block_lanczos_tpu_torch.utils import kernel_sweeps as ks
    src = (kernels.CSRC / "semi_inverse_wide.cu").read_text()
    names = re.search(r"enum \{(.*?)SIW_T_STEP1", src, re.S).group(1)
    names = [w.strip().removeprefix("SIW_T_").lower()
             for w in names.split(",") if w.strip()]
    stamped = {"sig": "inverse_sig", "end": "rhs_end"}
    assert [stamped.get(k, k) for k in names] == [
        "start", *ks.PHASES_W, "ns_start", "ns_end", "inv_start", "inv_end",
        "inv_steps"]
    assert [ks.TW_START, ks.TW_END, ks.TW_NS_START, ks.TW_NS_END,
            ks.TW_INV_START, ks.TW_INV_END, ks.TW_INV_STEPS] == [
        names.index(k) for k in ("start", "end", "ns_start", "ns_end",
                                 "inv_start", "inv_end", "inv_steps")]
    assert int(re.search(r"SIW_T_STEP1 = (\d+)", src).group(1)) \
        == ks.TW_STEP1
    assert int(re.search(r"SIW_T_NSUB = (\d+)", src).group(1)) \
        == ks.TW_NSUB
    assert ks.TW_MAXN == wide_ops.MAX_N
    assert "SIW_T_STEP2 = SIW_T_STEP1 + SIW_MAXN" in src
    assert "SIW_T_SUB = SIW_T_STEP2 + SIW_MAXN" in src
    assert "SIW_T_SLOTS = SIW_T_SUB + 4 * SIW_T_NSUB" in src
    for k in names[:9] + names[11:13]:    # every phase and the inverse
        assert f"SIW_STAMP(SIW_T_{k.upper()})" in src, k
    assert "siw_stamps[SIW_T_INV_STEPS] = steps" in src
    # both eliminations stamp the four parts of a step
    for k in range(4):
        assert src.count(f"SIW_STAMP_PART(j, {k})") == 2, k
    # the stamps' arithmetic: 44 steps of the inverse at 50 cycles
    st = [0] * ks.TW_SLOTS
    st[ks.TW_START:ks.TW_END + 1] = [100 * k for k in range(9)]
    st[ks.TW_NS_START], st[ks.TW_NS_END] = 0, 400
    st[ks.TW_INV_START], st[ks.TW_INV_END] = 1000, 1000 + 44 * 50
    st[ks.TW_INV_STEPS] = 44
    st[ks.TW_STEP1:ks.TW_STEP1 + 2] = [100, 150]
    st[ks.TW_SUB:ks.TW_SUB + 8] = [110, 115, 130, 140, 160, 161, 180, 190]
    t = ks._timeline_wide(st, 2)
    assert t["cycles"] == 800 and t["ghz"] == 2.0
    assert t["phases"] == dict.fromkeys(ks.PHASES_W, 100)
    assert t["cycles_per_step"] == 50
    assert t["step_parts"] == [
        {"search": 10, "swap": 5, "update": 15, "barrier": 10},
        {"search": 10, "swap": 1, "update": 19, "barrier": 10}]
    assert t["inverse_cycles"] == 44 * 50 and t["inverse_steps"] == 44
    assert t["cycles_per_inverse_step"] == 50
