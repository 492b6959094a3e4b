"""The port's semi-inverse against the JAX package's, bit for bit.

`semi_inverse` (CPU tensors: the plain version of the semi_inverse kernel)
is held against `semi_inverse_device` and the host oracle
`semi_inverse_np`, for full-rank, rank-deficient and zero Grams; its fused
invariant flag against `check_invariants_device`; and its right-hand side
against the values `orthogonalize_device` builds.  Tolerance zero.

The semi_inverse kernel's own algorithm, a row-scaled elimination that a
CPU cannot run from the CUDA source, is mirrored here in NumPy
(`semi_inverse_scaled_np`) and held against the JAX package's oracle: a
change to the kernel's elimination (csrc/semi_inverse.cu) is made in the
mirror too.  On the card, chip_smoke.py holds the kernel itself against
`semi_inverse_plain`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos as jl
from block_lanczos_tpu.ops import dense as jdense
from block_lanczos_tpu.ops import gfp as jgfp
from block_lanczos_tpu.ops.semi_inverse import (semi_inverse_device,
                                                semi_inverse_np)
from block_lanczos_tpu_torch.ops import semi_inverse as tsi
from block_lanczos_tpu_torch.ops.gfp import inv_fermat_np, reduce_short_np

P = 1073741789


def _sym(rng, n, rank, p):
    """Symmetric n x n residues of rank <= rank (reduced outer products)."""
    U = np.zeros((n, n), np.int64)
    for _ in range(rank):
        b = rng.integers(0, p, n, dtype=np.int64)
        U = (U + np.outer(b, b) % p) % p
    return U


def _jax_reference(p, U, UA):
    """(winv, d, npiv, inv_ok, rhs) as the JAX package computes them."""
    f = jgfp.GFp.make(p)
    vtAv, vtAAv = jnp.asarray(U.astype(np.uint32)), \
        jnp.asarray(UA.astype(np.uint32))
    winv, d, npiv = jax.jit(semi_inverse_device, static_argnums=0)(f, vtAv)
    ok = jl.check_invariants_device(f, vtAv, vtAAv, winv, d)
    # the right-hand side orthogonalize_device builds
    # (block_lanczos_tpu/models/lanczos.py:104-112)
    n = U.shape[0]
    dmask = d.astype(bool)[None, :]
    spliced = jnp.where(dmask, vtAAv, vtAv)
    c = jgfp.modneg(f, jdense.matmul_nn_mod(f, winv, spliced))
    vtAvd = jnp.where(dmask, jgfp.modneg(f, vtAv), jnp.uint32(0))
    rhs = jnp.block([[c, winv], [vtAvd, jnp.zeros((n, n), jnp.uint32)]])
    return (np.asarray(winv), np.asarray(d), int(npiv), bool(ok),
            np.asarray(rhs))


def _port(p, U, UA, check=True):
    grams = torch.from_numpy(np.concatenate([U, UA]).astype(np.int32))
    state = tsi.new_state("cpu")
    out = tsi.semi_inverse(grams, p, state, check)
    return out, state


# Each (p, n) compiles semi_inverse_device once (~1 s at p = 2, 3-6 s at
# the larger primes, whose Fermat chain is unrolled): p = 2 at every n,
# the larger primes spread over the n.
CASES = [(p, n, kind)
         for p, n in ((2, 1), (2, 2), (2, 4), (2, 8), (2, 32), (P, 1),
                      (65537, 2), (P, 4), (65537, 8), (P, 32))
         for kind in ("full", "deficient", "zero")]


@pytest.mark.parametrize("p,n,kind", CASES)
def test_semi_inverse_matches_jax(p, n, kind):
    rng = np.random.default_rng(1000 * n + len(kind) + p % 97)
    rank = {"full": n + 2, "deficient": max(n // 2, 1) if n > 1 else 0,
            "zero": 0}[kind]
    U = _sym(rng, n, rank, p)
    UA = _sym(rng, n, n + 1, p)
    winv, d, npiv, ok, rhs = _jax_reference(p, U, UA)
    ow, od, on = semi_inverse_np(p, U.astype(np.uint32))
    np.testing.assert_array_equal(ow, winv)
    np.testing.assert_array_equal(od, d)
    assert on == npiv
    out, state = _port(p, U, UA)
    np.testing.assert_array_equal(out.winv.numpy().astype(np.uint32), winv)
    np.testing.assert_array_equal(out.d.numpy().astype(np.uint32), d)
    assert int(out.npiv[0]) == npiv
    np.testing.assert_array_equal(out.rhs.numpy().astype(np.uint32), rhs)
    assert state.tolist() == [int(npiv == 0), int(ok), 0, 0]
    if kind == "zero":
        assert npiv == 0 and state[tsi.STOP] == 1
    if kind == "deficient" and n > 2:
        assert 0 < npiv < n


def test_semi_inverse_np_matches_jax_oracle():
    from block_lanczos_tpu.ops import semi_inverse as jsi
    rng = np.random.default_rng(5)
    for p in (2, 3, 65537, P):
        for n in (3, 6):
            U = _sym(rng, n, n - 1, p).astype(np.uint32)
            for a, b in zip(tsi.semi_inverse_np(p, U),
                            jsi.semi_inverse_np(p, U)):
                np.testing.assert_array_equal(a, b)


def _eliminate_scaled_np(p: int, M: np.ndarray, W: np.ndarray | None):
    """The kernel's sweep (csrc/semi_inverse.cu::eliminate): rows stay in
    place behind a logical -> physical `perm`, and no row is normalised:
    R_q <- a * R_q - M[q, j] * R_P for every physical row q != P, with a the
    pivot.  Only M's columns > j are written (column j is dead after step
    j).  Returns (perm, d, npiv, pref) with pref[j] the product of the
    pivots of the steps before j."""
    n = M.shape[0]
    perm = np.arange(n)
    d = np.zeros(n, np.uint32)
    pref = [1]
    for j in range(n):
        nz = np.nonzero(M[perm[j:], j])[0]
        if len(nz) == 0:
            pref.append(pref[-1])
            continue
        piv = j + int(nz[0])
        P = int(perm[piv])
        a = np.uint64(M[P, j])
        rows = np.arange(n) != P
        nb = (np.uint64(p) - M[rows, j].astype(np.uint64))[:, None]
        M[rows, j + 1:] = reduce_short_np(
            a * M[rows, j + 1:] + nb * M[P, j + 1:], p)
        if W is not None:
            W[rows] = reduce_short_np(a * W[rows] + nb * W[P], p)
        perm[[j, piv]] = perm[[piv, j]]
        pref.append(int(reduce_short_np(pref[-1] * int(a), p)))
        d[j] = 1
    return perm, d, int(d.sum()), pref


def semi_inverse_scaled_np(p: int, U: np.ndarray):
    """(winv, d, npiv) as the semi_inverse kernel computes them, on the
    host: both phases on the row-scaled representation, then one inverse
    (inv_fermat_np of the product A of phase 2's pivots) undoes the row
    scales: the row at a pivot position i carries A / pref[i], every other
    row A."""
    n = U.shape[0]
    U = U.astype(np.uint64)
    _, d1, _, _ = _eliminate_scaled_np(p, U.copy(), None)
    M = np.where(d1[:, None] & d1[None, :] != 0, U, np.uint64(0))
    W = np.diag(d1).astype(np.uint64)
    perm, d, npiv, pref = _eliminate_scaled_np(p, M, W)
    inv_a = inv_fermat_np(pref[n], p)
    sig = np.where(d != 0, reduce_short_np(
        np.array(pref[:n], np.uint64) * inv_a, p), inv_a)
    winv = reduce_short_np(W[perm] * sig[:, None], p)
    return winv.astype(np.uint32), d, npiv


MIRROR_CASES = [(p, n, kind) for p in (2, 3, 65537, P)
                for n in (1, 4, 31, 33, 64)
                for kind in ("full", "deficient", "zero")]


@pytest.mark.parametrize("p,n,kind", MIRROR_CASES)
def test_kernel_algorithm_mirror_matches_jax_oracle(p, n, kind):
    """The semi_inverse kernel's own algorithm (row-scaled, row-permuted
    elimination, one Fermat inverse on Barrett products at the end), as
    its mirror above runs it, against the JAX package's oracle."""
    from block_lanczos_tpu.ops import semi_inverse as jsi
    rng = np.random.default_rng(10 * n + len(kind) + p % 89)
    rank = {"full": n + 2, "deficient": max(n // 2, 1) if n > 1 else 0,
            "zero": 0}[kind]
    U = _sym(rng, n, rank, p).astype(np.uint32)
    want = jsi.semi_inverse_np(p, U)
    got = semi_inverse_scaled_np(p, U)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if kind == "zero":
        assert got[2] == 0


def test_preallocated_outputs_shape_checked():
    out = tsi.empty_outputs(4, "cpu")
    assert [tuple(t.shape) for t in out] == [(4, 4), (4,), (1,), (8, 8)]
    assert all(t.dtype == torch.int32 for t in out)
    grams = torch.zeros((6, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="out must be"):
        tsi.semi_inverse(grams, P, tsi.new_state("cpu"), out=out)


def test_invariant_flag_catches_asymmetry():
    rng = np.random.default_rng(9)
    n = 4
    U = _sym(rng, n, n, P)
    UA = rng.integers(0, P, size=(n, n), dtype=np.int64)   # not symmetric
    *_, ok, _ = _jax_reference(P, U, UA)
    assert not ok
    _, state = _port(P, U, UA)
    assert state[tsi.INV_OK] == 0
    _, state = _port(P, U, UA, check=False)
    assert state[tsi.INV_OK] == 1


def test_frozen_state_is_not_overwritten():
    rng = np.random.default_rng(11)
    U = _sym(rng, 4, 0, P)                      # zero Gram: would stop
    grams = torch.from_numpy(np.concatenate([U, U]).astype(np.int32))
    state = torch.tensor([0, 1, 7, 1], dtype=torch.int32)
    tsi.semi_inverse(grams, P, state)
    assert state.tolist() == [0, 1, 7, 1]
