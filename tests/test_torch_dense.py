"""The port's Gram product against the JAX package's, bit for bit.

`gram_mod` (CPU tensors: the plain version of the gram_mod kernel) is held
against the XLA path `dense.gram_mod` and against the Pallas TPU kernel
`pallas_gram.gram_mod_pallas`, run as a Pallas kernel on the CPU under
`force_tpu_interpret_mode()`, at the size classes of the JAX package's own
Pallas test (single block, multi-block, fold boundary, large a*b).
Tolerance zero.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from block_lanczos_tpu.ops import dense as jdense
from block_lanczos_tpu.ops.gfp import GFp as JGFp
from block_lanczos_tpu.ops.pallas_gram import gram_mod_pallas
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops import dense as tdense
from block_lanczos_tpu_torch.ops import gfp as tgfp

P = 1073741789
SIZES = [(100, 4, 4), (5000, 8, 4), (70_000, 8, 8), (9_000, 40, 32)]


def _blocks(N, a, b, p, seed):
    rng = np.random.default_rng(seed)
    V = rng.integers(0, p, size=(N, a), dtype=np.int64)
    W = rng.integers(0, p, size=(N, b), dtype=np.int64)
    V[0], W[0] = p - 1, p - 1       # the largest residues
    return V, W


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


@pytest.mark.parametrize("N,a,b", SIZES)
def test_gram_matches_xla_and_pallas(N, a, b):
    V, W = _blocks(N, a, b, P, N + a + b)
    f = JGFp.make(P)
    Vj, Wj = jnp.asarray(V.astype(np.uint32)), jnp.asarray(W.astype(np.uint32))
    xla = np.asarray(jdense.gram_mod(f, Vj, Wj))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(gram_mod_pallas(f, Vj, Wj))
    np.testing.assert_array_equal(pallas, xla)
    # the port, with [V1 | V2] split as the solver's [v | Av] is
    h = a // 2
    got = tdense.gram_mod(_t(V[:, :h]), _t(V[:, h:]), _t(W), P)
    assert got.dtype == torch.int32 and got.shape == (a, b)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), xla)
    whole = tdense.gram_mod(_t(V), None, _t(W), P)
    np.testing.assert_array_equal(whole.numpy(), got.numpy())


@pytest.mark.parametrize("p", [2, 3, 65537])
def test_gram_small_primes_match_xla(p):
    V, W = _blocks(777, 8, 4, p, p)
    f = JGFp.make(p)
    want = np.asarray(jdense.gram_mod(f, jnp.asarray(V.astype(np.uint32)),
                                      jnp.asarray(W.astype(np.uint32))))
    got = tdense.gram_mod(_t(V[:, :4]), _t(V[:, 4:]), _t(W), p)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("p", [2, P])
def test_matmul_mod_matches_xla(p):
    rng = np.random.default_rng(p)
    X = rng.integers(0, p, size=(300, 8), dtype=np.int64)
    B = rng.integers(0, p, size=(8, 8), dtype=np.int64)
    want = np.asarray(jdense.matmul_mod(JGFp.make(p),
                                        jnp.asarray(X.astype(np.uint32)),
                                        jnp.asarray(B.astype(np.uint32))))
    got = tdense.matmul_mod(_t(X), _t(B), p)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_gram_rejects_ragged_blocks():
    with pytest.raises(ValueError):
        tdense.gram_mod(_t(np.zeros((5, 2))), None, _t(np.zeros((4, 2))), P)


# The kernels' arithmetic, through its NumPy mirrors (ops/gfp.py), against
# the JAX package's Gram: the tensor-core path (u8-limb shift classes,
# recombined every fold; a short fold here so that N spans several) and the
# row path (lazy u64 sums folded every LAZY_FOLD rows).
MIRROR_CASES = ([(P, n) for n in (1, 3, 4, 16, 31, 32, 33, 64)]
                + [(p, n) for p in (2, 3, 65537)
                   for n in (4, 32)])


@pytest.mark.parametrize("p,n", MIRROR_CASES)
def test_gram_kernel_mirrors_match_jax(p, n):
    N = 150
    rng = np.random.default_rng(p % 1013 + n)
    v = rng.integers(0, p, size=(N, n), dtype=np.int64)
    av = rng.integers(0, p, size=(N, n), dtype=np.int64)
    v[-1], av[-1] = p - 1, p - 1
    X = np.concatenate([v, av], axis=1)
    want = np.asarray(jdense.gram_mod(JGFp.make(p),
                                      jnp.asarray(X.astype(np.uint32)),
                                      jnp.asarray(av.astype(np.uint32))))
    mma = tgfp.mma_gram_np(X, av, p, fold_rows=64)
    np.testing.assert_array_equal(mma, want.astype(np.uint64))
    got = tdense.gram_mod(_t(v), _t(av), _t(av), p)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    if n <= 4:   # the row path's per-thread lazy sums, one per output
        row = np.array([[tgfp.lazy_dot_int(p, X[:, i], av[:, j])
                         for j in range(n)] for i in range(2 * n)])
        np.testing.assert_array_equal(row, want.astype(np.int64))


def test_gram_worst_case_mirror_across_folds():
    """Every residue p - 1 over more rows than one tensor-core fold."""
    p, N = (1 << 30) - 35, tgfp.MMA_FOLD_ROWS + 77
    X = np.full((N, 2), p - 1, np.int64)
    got = tgfp.mma_gram_np(X, X[:, :1], p)
    assert (got == N * (p - 1) ** 2 % p).all()


def test_gram_kernel_constants_match_the_source():
    src = (kernels.CSRC / "gram_mod.cu").read_text()
    for name in ("GRAM_MAX_A", "GRAM_MAX_B", "GRAM_MMA_MIN_N"):
        m = re.search(rf"#define {name} (\d+)", src)
        assert m and int(m.group(1)) == getattr(tdense, name), name
