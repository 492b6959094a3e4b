"""The PyTorch port's field arithmetic against the JAX package's, bit for bit.

Inputs are made with NumPy from a seed and go through both packages; the
tolerance is zero (the arithmetic is exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.ops import gfp as jgfp
from block_lanczos_tpu_torch.ops import gfp as tgfp

PRIMES = [2, 3, 65537, 1073741789]


def _operands(p, size=512, seed=0):
    rng = np.random.default_rng(seed + p)
    a = rng.integers(0, p, size=size, dtype=np.int64)
    b = rng.integers(0, p, size=size, dtype=np.int64)
    # the edges 0 and p-1 against each other and everything
    edges = np.array([0, p - 1, 0, p - 1, 1 % p, p - 1], np.int64)
    a = np.concatenate([a, edges, np.full(size, p - 1)])
    b = np.concatenate([b, edges[::-1], b])
    return a, b


def _jax(x):
    return jnp.asarray(x.astype(np.uint32))


def _torch(x):
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("op", ["modadd", "modsub", "modmul"])
def test_binary_ops_match_jax(p, op):
    a, b = _operands(p)
    jf, tf = jgfp.GFp.make(p), tgfp.GFp.make(p)
    want = np.asarray(getattr(jgfp, op)(jf, _jax(a), _jax(b)))
    got = getattr(tgfp, op)(tf, _torch(a), _torch(b)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("p", PRIMES)
def test_modneg_matches_jax(p):
    a, _ = _operands(p)
    jf, tf = jgfp.GFp.make(p), tgfp.GFp.make(p)
    want = np.asarray(jgfp.modneg(jf, _jax(a)))
    np.testing.assert_array_equal(tgfp.modneg(tf, _torch(a)).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("p", PRIMES)
def test_modinv_matches_jax(p):
    a, _ = _operands(p, size=64)
    a = a[a != 0]
    jf, tf = jgfp.GFp.make(p), tgfp.GFp.make(p)
    want = np.asarray(jgfp.modinv_device(jf, _jax(a)))
    got = tgfp.modinv(tf, _torch(a)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got * a % p, np.ones_like(a))


@pytest.mark.parametrize("p", PRIMES)
def test_np_matmul_mod_matches_jax(p):
    rng = np.random.default_rng(p)
    A = rng.integers(0, p, size=(7, 9), dtype=np.int64).astype(np.uint32)
    B = rng.integers(0, p, size=(9, 5), dtype=np.int64).astype(np.uint32)
    A[0] = p - 1
    np.testing.assert_array_equal(tgfp.np_matmul_mod(p, A, B),
                                  jgfp.np_matmul_mod(p, A, B))


def test_prime_cap_and_p2():
    assert tgfp.PRIME_CAP == jgfp.PRIME_CAP
    assert tgfp.GFp.make(2).p == 2
    assert tgfp.GFp.make(tgfp.PRIME_CAP).p == tgfp.PRIME_CAP
    for bad in (0, 1, 4, tgfp.PRIME_CAP + 2):
        with pytest.raises(ValueError):
            tgfp.GFp.make(bad)
    assert tgfp.GFp.make(65537).invmod(3) * 3 % 65537 == 1
