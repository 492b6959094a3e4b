"""Exact GF(p) arithmetic for the narrow field, on int64 tensor math.

Residues are stored as int32 tensors with 0 <= r < p < 2^30.  A product of
two residues is below 2^60, so every operation here widens to int64, forms
the exact product and reduces it with `%` — the reference's own "multiply
in u64, reduce % p" idiom.  The JAX package's 15-bit limb splits and
16-bit-limb Montgomery multiply exist only because the TPU has no 64-bit
integer datapath; they are not reproduced.  Only the canonical residues
have to match, and they do bit for bit.

The prime is capped at 2^30 - 35 like the reference; p = 2 is a valid
narrow field (the GF(2) bitsliced path needs n % 32 == 0 and is a later
slice of the port).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRIME_CAP = 0x3FFFFFDD  # 2^30 - 35, same cap as the reference


def _invmod_int(a: int, m: int) -> int:
    """Host modular inverse (extended Euclid) over Python ints."""
    t, nt, r, nr = 0, 1, m, a % m
    while nr != 0:
        q = r // nr
        t, nt = nt, t - q * nt
        r, nr = nr, r - q * nr
    if r != 1:
        raise ValueError(f"{a} is not invertible mod {m}")
    return t % m


@dataclasses.dataclass(frozen=True)
class GFp:
    """The narrow field GF(p), 2 <= p <= 2^30 - 35."""

    p: int

    @staticmethod
    def make(p: int) -> "GFp":
        p = int(p)
        if p < 2:
            raise ValueError("p must be >= 2")
        if p > PRIME_CAP:
            raise ValueError(f"p is capped at 2**30 - 35 (got {p})")
        if p % 2 == 0 and p != 2:
            raise ValueError("p must be prime; the only even prime is 2")
        return GFp(p=p)

    def invmod(self, a: int) -> int:
        return _invmod_int(int(a), self.p)


# ---------------------------------------------------------------------------
# Elementwise field ops on tensors of residues (any integer dtype in, the
# wider of int64 out).  Inputs must already lie in [0, p).
# ---------------------------------------------------------------------------

def _i64(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64)


def modadd(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) + _i64(b)) % f.p


def modsub(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) - _i64(b)) % f.p


def modneg(f: GFp, a) -> torch.Tensor:
    return (-_i64(a)) % f.p


def modmul(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) * _i64(b)) % f.p


def modpow(f: GFp, a, e: int) -> torch.Tensor:
    """a^e mod p elementwise, e a Python int >= 0 (square-and-multiply)."""
    base = _i64(a) % f.p
    acc = torch.ones_like(base)
    for bit in bin(int(e))[2:]:
        acc = acc * acc % f.p
        if bit == "1":
            acc = acc * base % f.p
    return acc


def modinv(f: GFp, a) -> torch.Tensor:
    """a^-1 mod p via Fermat (a^(p-2)); 0 maps to 0 for p > 2 and to 1 for
    p = 2, matching the JAX package's contract to only invert pivots that
    were tested nonzero."""
    return modpow(f, a, f.p - 2)


# ---------------------------------------------------------------------------
# NumPy oracle (host, exact via uint64) — used by the checker and tests
# ---------------------------------------------------------------------------

def np_matmul_mod(p: int, A, B):
    """Exact (A @ B) mod p on host for residue inputs; reduces per k-step."""
    A = A.astype(np.uint64)
    B = B.astype(np.uint64)
    K = A.shape[-1]
    C = np.zeros(A.shape[:-1] + B.shape[1:], np.uint64)
    for k in range(K):  # products < 2^60; one addition then reduce: exact
        C = (C + A[..., k:k + 1] * B[k]) % np.uint64(p)
    return C.astype(np.uint32)
