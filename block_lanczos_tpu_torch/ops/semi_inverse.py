"""The mod-p "semi-inverse": maximal-invertible-submatrix Gauss-Jordan.

Given the n x n Gram matrix U = vtAv, compute a partial inverse W and a 0/1
mask d with d*W == W*d == W and d == W*U*d, and the number of pivots (0
pivots ends the Lanczos loop).  Two-phase elimination exactly as the
reference (sequential/lanczos_modp.c:342-438): phase 1 finds the pivotable
column set, phase 2 re-eliminates the masked matrix while accumulating W.

Three implementations:
  * `semi_inverse_np`: host NumPy oracle (a copy of the JAX package's);
  * `semi_inverse`: wraps the single-CTA `semi_inverse` CUDA kernel
    (csrc/semi_inverse.cu), which also evaluates the per-iteration
    invariants and builds the orthogonalize right-hand side;
  * `semi_inverse_plain`: its plain PyTorch version (the masked,
    branch-free formulation of the JAX package's `_eliminate_device`),
    which the wrapper takes for CPU tensors only.

The solver state is a 4-element int32 tensor [stop, inv_ok, k_done,
frozen] on the device; `new_state` makes one.  stop and inv_ok are written
unless the state is frozen (an earlier iteration halted).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops.dense import matmul_mod
from block_lanczos_tpu_torch.ops.gfp import GFp, barrett_mu, modinv

MAX_N = 64  # csrc/semi_inverse.cu SI_MAXN

STOP, INV_OK, K_DONE, FROZEN = range(4)


def new_state(device) -> torch.Tensor:
    """[stop, inv_ok, k_done, frozen] = [0, 1, 0, 0]."""
    return torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=device)


class SemiInverse(NamedTuple):
    winv: torch.Tensor  # (n, n) int32
    d: torch.Tensor     # (n,) int32, 0/1
    npiv: torch.Tensor  # (1,) int32
    rhs: torch.Tensor   # (2n, 2n) int32: [[c, winv], [vtAvd, 0]]


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def _eliminate_np(p: int, M: np.ndarray, W: np.ndarray | None):
    """One Gauss-Jordan sweep; updates M (and W) in place, returns (d, npiv)."""
    n = M.shape[0]
    d = np.zeros(n, np.uint32)
    npiv = 0
    for j in range(n):
        pivots = np.nonzero(M[j:, j])[0]
        if len(pivots) == 0:
            continue
        pivot = j + int(pivots[0])
        d[j] = 1
        npiv += 1
        pinv = np.uint64(pow(int(M[pivot, j]), p - 2, p))
        M[pivot] = (M[pivot].astype(np.uint64) * pinv % p).astype(np.uint32)
        M[[j, pivot]] = M[[pivot, j]]
        if W is not None:
            W[pivot] = (W[pivot].astype(np.uint64) * pinv % p).astype(np.uint32)
            W[[j, pivot]] = W[[pivot, j]]
        mult = (np.uint64(p) - M[:, j].astype(np.uint64)) % p  # -M[i,j]
        mult[j] = 0
        M[:] = ((M.astype(np.uint64) + mult[:, None] * M[j].astype(np.uint64))
                % p).astype(np.uint32)
        if W is not None:
            W[:] = ((W.astype(np.uint64) + mult[:, None] * W[j].astype(np.uint64))
                    % p).astype(np.uint32)
    return d, npiv


def semi_inverse_np(p: int, U: np.ndarray):
    """Return (winv, d, npiv) for the n x n residue matrix U mod p."""
    n = U.shape[0]
    M = U.astype(np.uint32).copy()
    d1, _ = _eliminate_np(p, M, None)                      # phase 1: find d
    mask = (d1[:, None] & d1[None, :]).astype(bool)
    M2 = np.where(mask, U, 0).astype(np.uint32)            # phase 2 input
    W = (np.eye(n, dtype=np.uint32) * d1)                  # masked identity
    d, npiv = _eliminate_np(p, M2, W)
    return W, d, npiv


# ---------------------------------------------------------------------------
# Plain PyTorch version (masked, no host sync)
# ---------------------------------------------------------------------------

def _eliminate_plain(p: int, M: torch.Tensor, W: torch.Tensor):
    """Masked Gauss-Jordan sweep over the columns on int64 residues;
    returns (M, W, d, npiv) with d int64 0/1 and npiv a 0-dim int64."""
    n = M.shape[0]
    rows = torch.arange(n, device=M.device)
    d = torch.zeros(n, dtype=torch.int64, device=M.device)
    npiv = torch.zeros((), dtype=torch.int64, device=M.device)
    for j in range(n):
        cand = (M[:, j] != 0) & (rows >= j)
        found = cand.any()
        pivot = torch.argmax(cand.to(torch.int64))  # first True
        pinv = modinv(GFp(p), torch.clamp(M[pivot, j], min=1))
        perm = torch.where(rows == j, pivot, torch.where(rows == pivot, j, rows))
        M2, W2 = M[perm], W[perm]
        M2[j] = M2[j] * pinv % p
        W2[j] = W2[j] * pinv % p
        # W's multiplier comes from M's column after the swap
        mult = (-M2[:, j]) % p
        mult[j] = 0
        M3 = (M2 + mult[:, None] * M2[j][None, :] % p) % p
        W3 = (W2 + mult[:, None] * W2[j][None, :] % p) % p
        M = torch.where(found, M3, M)
        W = torch.where(found, W3, W)
        d[j] = found.to(torch.int64)
        npiv = npiv + found.to(torch.int64)
    return M, W, d, npiv


def invariants_ok(p: int, vtAv, vtAAv, winv, d) -> torch.Tensor:
    """0-dim bool: the reference's per-iteration checks (symmetry of vtAv,
    vtAAv, winv; winv support within d; winv * (vtAv*d) == diag(d))."""
    ok = (vtAv == vtAv.T).all() & (vtAAv == vtAAv.T).all() \
        & (winv == winv.T).all()
    db = d.to(torch.bool)
    ok &= ((winv == 0) | db[:, None] | db[None, :]).all()
    vtAvd = torch.where(db[None, :], vtAv, torch.zeros_like(vtAv))
    check = matmul_mod(winv, vtAvd, p).to(torch.int64)
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    ok &= torch.where(eye, check == d[None, :].to(torch.int64),
                      check == 0).all()
    return ok


def orthogonalize_rhs(p: int, vtAv, vtAAv, winv, d) -> torch.Tensor:
    """[[c, winv], [vtAvd, 0]] with c = -winv*where(d, vtAAv, vtAv) and
    vtAvd = where(d, -vtAv, 0), as (2n, 2n) int32."""
    n = d.shape[0]
    dmask = d.to(torch.bool)[None, :]
    spliced = torch.where(dmask, vtAAv, vtAv)
    c = (-matmul_mod(winv, spliced, p).to(torch.int64)) % p
    vtAvd = torch.where(dmask, (-vtAv.to(torch.int64)) % p,
                        torch.zeros_like(vtAv, dtype=torch.int64))
    zero = torch.zeros((n, n), dtype=torch.int64, device=d.device)
    top = torch.cat([c, winv.to(torch.int64)], dim=1)
    bottom = torch.cat([vtAvd, zero], dim=1)
    return torch.cat([top, bottom]).to(torch.int32)


def semi_inverse_plain(grams: torch.Tensor, p: int, state: torch.Tensor,
                       check: bool = True) -> SemiInverse:
    """Plain PyTorch version of the semi_inverse kernel (same outputs and
    the same state update)."""
    n = grams.shape[1]
    U = grams[:n].to(torch.int64)
    UA = grams[n:2 * n].to(torch.int64)
    _, _, d1, _ = _eliminate_plain(p, U, torch.zeros_like(U))
    mask = (d1[:, None] * d1[None, :]).to(torch.bool)
    M2 = torch.where(mask, U, torch.zeros_like(U))
    W0 = torch.eye(n, dtype=torch.int64, device=U.device) * d1[None, :]
    _, W, d, npiv = _eliminate_plain(p, M2, W0)
    ok = invariants_ok(p, U, UA, W, d) if check else \
        torch.ones((), dtype=torch.bool, device=U.device)
    rhs = orthogonalize_rhs(p, U, UA, W, d)
    frozen = state[FROZEN] != 0
    new = torch.stack([(npiv == 0).to(torch.int32), ok.to(torch.int32)])
    state[:2] = torch.where(frozen, state[:2], new)
    return SemiInverse(W.to(torch.int32), d.to(torch.int32),
                       npiv.reshape(1).to(torch.int32), rhs)


def empty_outputs(n: int, device) -> SemiInverse:
    """Output buffers for `semi_inverse(..., out=)`."""
    return SemiInverse(
        torch.empty((n, n), dtype=torch.int32, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(1, dtype=torch.int32, device=device),
        torch.empty((2 * n, 2 * n), dtype=torch.int32, device=device))


def semi_inverse(grams: torch.Tensor, p: int, state: torch.Tensor,
                 check: bool = True, out: SemiInverse | None = None
                 ) -> SemiInverse:
    """(winv, d, npiv, rhs) of grams = [vtAv ; vtAAv] (2n, n), updating
    the solver state in place.  CUDA tensors launch the semi_inverse
    kernel; CPU tensors take semi_inverse_plain.  `out` (CUDA only) is an
    optional preallocated result (`empty_outputs`)."""
    n = grams.shape[1]
    if grams.shape[0] != 2 * n or state.shape != (4,):
        raise ValueError("semi_inverse needs (2n, n) grams and a 4-state")
    if out is not None and [tuple(t.shape) for t in out] != \
            [(n, n), (n,), (1,), (2 * n, 2 * n)]:
        raise ValueError(f"out must be semi_inverse outputs for n = {n}")
    if grams.device.type == "cpu":
        return semi_inverse_plain(grams, p, state, check)
    if n > MAX_N:
        raise ValueError(f"the semi_inverse kernel supports n <= {MAX_N} "
                         f"(got {n})")
    if out is None:
        out = empty_outputs(n, grams.device)
    kernels.check_operands("semi_inverse", grams, state, *out)
    kernels.launch("semi_inverse", grams.data_ptr(), n, p, barrett_mu(p),
                   int(bool(check)), out.winv.data_ptr(), out.d.data_ptr(),
                   out.npiv.data_ptr(), out.rhs.data_ptr(), state.data_ptr())
    semi_inverse.launches += 1
    return out


semi_inverse.launches = 0
