"""Sparse and dense mod-p kernels for the wide field (2^30 - 35 < p < 2^62).

The port of the JAX package's ops/wide_ops.py on int64 residues (u64 in the
kernels, csrc/modp64.cuh), three kernels with their plain versions:

  * `spmv_wide` (csrc/spmv_wide.cu): y = op * x mod p over the narrow
    field's hybrid ELL + CSR-spill layout (ops/spmm.py), built here with
    one of two slabs: int32 signed coefficients (each entry's
    representative in (-p/2, p/2)) when every coefficient of the operator
    fits in 31 bits, else int64 residues in standard form.  JAX's
    Montgomery-form pair slab, its limb prefix sums and its input bands
    only change the layout; mod-p sums are associative, so the residues
    are the same;
  * `gram_wide` (csrc/gram_wide.cu): [v | Av]^T Av mod p in one launch, on
    the u8-limb tensor cores;
  * `semi_inverse_wide` (csrc/semi_inverse_wide.cu): the two-phase masked
    Gauss-Jordan on the n x n Gram, the invariant checks and the update's
    right-hand side, with the narrow solver's state ([stop, inv_ok,
    k_done, frozen], ops/semi_inverse.py).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (ops/gfp_wide.py's int64 arithmetic) for CPU tensors only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
from block_lanczos_tpu_torch.ops.semi_inverse import FROZEN, SemiInverse
from block_lanczos_tpu_torch.utils import profiling

MAX_N = 64  # csrc/semi_inverse_wide.cu SIW_MAXN, orthogonalize_wide OW_MAX_N
# csrc/gram_wide.cu GW_SCRATCH: two 31-bit halves an entry of G, the ticket
_GRAM_SCRATCH = 2 * 2 * MAX_N * MAX_N + 1
# the narrow slab's coefficients: |c| <= 2^31 - 1 (csrc/spmv_wide.cu)
NARROW_COEF_MAX = (1 << 31) - 1
_scratch: dict = {}


# ---------------------------------------------------------------------------
# Layout (host, NumPy): the narrow field's hybrid layout with int64 values
# ---------------------------------------------------------------------------

def signed_coefficients(p: int, residues) -> np.ndarray:
    """Each residue's representative in (-p/2, p/2), int64."""
    r = np.asarray(residues).astype(np.int64)
    return np.where(r > p // 2, r - p, r)


def narrow_fits(p: int, *residues) -> bool:
    """Whether every residue's signed representative fits the narrow
    slab's int32 coefficient (|c| <= 2^31 - 1)."""
    return all(not a.size or
               int(np.abs(signed_coefficients(p, a)).max()) <= NARROW_COEF_MAX
               for a in map(np.asarray, residues))


def slab_values(p: int, residues, narrow: bool) -> np.ndarray:
    """The values as the chosen slab stores them: int32 signed
    coefficients (narrow) or int64 residues."""
    if narrow:
        return signed_coefficients(p, residues).astype(np.int32)
    return np.asarray(residues).astype(np.int64)


def u64_slab(op: spmm.HybridOp) -> spmm.HybridOp:
    """The same operator on the u64 slab (its coefficients taken mod p;
    an operator on the u64 slab comes back as it is)."""
    if op.vals.dtype == torch.int64:
        return op
    return dataclasses.replace(
        op, vals=torch.remainder(op.vals.to(torch.int64), op.p),
        sp_vals=torch.remainder(op.sp_vals.to(torch.int64), op.p))


def make_wide_op(f: GFpWide, out_idx, in_idx, vals, out_dim: int,
                 in_dim: int, ell: int | None = None) -> spmm.HybridOp:
    """A CPU HybridOp from COO arrays (values are reduced mod p here);
    `.to(device)` moves it.  Its slab holds int32 signed coefficients when
    every coefficient fits (narrow_fits), else int64 residues (counted in
    wide_slab_int32_ops / wide_slab_int64_ops); u64_slab gives the same
    operator on the u64 slab."""
    v = np.asarray(vals)
    if v.dtype.kind == "i":
        v = (v % np.int64(f.p)).astype(np.uint64)
    elif v.dtype.kind == "u":
        v = v.astype(np.uint64) % np.uint64(f.p)
    else:
        v = (v.astype(object) % f.p).astype(np.uint64)
    narrow = narrow_fits(f.p, v)
    profiling.count("wide_slab_int32_ops" if narrow else "wide_slab_int64_ops")
    arrays = spmm.build_hybrid_arrays(
        out_idx, in_idx, slab_values(f.p, v, narrow), out_dim, ell,
        dtype=np.int32 if narrow else np.int64)
    return spmm.hybrid_op_from_arrays(f.p, arrays, out_dim, in_dim)


def slab(*ops) -> str:
    """The slab of wide operators: "int32" when each holds int32 signed
    coefficients, else "int64"."""
    return "int32" if all(op.vals.dtype == torch.int32 for op in ops) \
        else "int64"


def slab_attrs(first, second) -> dict:
    """layout.build's attribute `slab`: the slab of each direction (the
    operators of the first product, then of the second)."""
    return {"slab": (slab(*first), slab(*second))}


def wide_matrix_from_coo(f: GFpWide, M) -> spmm.SpMatrix:
    """Both directions of a COO matrix (values in [0, p)) as wide ops."""
    return spmm.SpMatrix(
        M.nrows, M.ncols, M.nnz,
        make_wide_op(f, M.i, M.j, M.x, M.nrows, M.ncols),
        make_wide_op(f, M.j, M.i, M.x, M.ncols, M.nrows))


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def spmv_wide_plain(op: spmm.HybridOp, x: torch.Tensor,
                    out_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the spmv_wide kernel: per slab slot a
    reduced product added mod p, then the spill's reduced products summed
    by row (index_add_mod); (out_rows, n) int64, zero rows past out_dim.
    Either slab: signed coefficients are taken mod p first."""
    out_rows = op.out_dim if out_rows is None else int(out_rows)
    spmm._check_args(op, x, out_rows)
    p = op.p
    n = x.shape[1]
    xl = x.to(torch.int64)
    op = u64_slab(op)
    y = torch.zeros((op.out_dim, n), dtype=torch.int64, device=x.device)
    for k in range(op.ell):
        y = gw.modadd(p, y, gw.mulmod(p, op.vals[k][:, None],
                                      xl[op.cols[k].long()]))
    if op.spill_nnz:
        rows = torch.repeat_interleave(
            torch.arange(op.out_dim, device=x.device),
            (op.rowptr[1:] - op.rowptr[:-1]).long())
        prod = gw.mulmod(p, op.sp_vals[:, None], xl[op.sp_cols.long()])
        y = gw.modadd(p, y, gw.index_add_mod(p, op.out_dim, rows, prod))
    out = torch.zeros((out_rows, n), dtype=torch.int64, device=x.device)
    out[:op.out_dim] = y
    return out


def spmv_wide(f: GFpWide, op: spmm.HybridOp, x: torch.Tensor,
              out_rows: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """y = op * x exactly mod p; (out_rows, n) int64, zero past out_dim.

    CUDA tensors launch the spmv_wide kernel; CPU tensors take
    spmv_wide_plain.  `out` (CUDA only) is an optional result buffer."""
    out_rows = op.out_dim if out_rows is None else int(out_rows)
    if op.p != f.p:
        raise ValueError(f"operator mod {op.p}, field mod {f.p}")
    if x.device.type == "cpu":
        return spmv_wide_plain(op, x, out_rows)
    spmm._check_args(op, x, out_rows)
    n = x.shape[1]
    if out is None:
        out = torch.empty((out_rows, n), dtype=torch.int64, device=x.device)
    elif out.shape != (out_rows, n):
        raise ValueError(f"out must be ({out_rows}, {n})")
    narrow = op.vals.dtype == torch.int32
    kernels.check_operands("spmv_wide", x, out, dtype=torch.int64)
    kernels.check_operands("spmv_wide", op.vals, op.sp_vals,
                           dtype=torch.int32 if narrow else torch.int64)
    kernels.check_operands("spmv_wide", op.cols, op.rowptr, op.sp_cols)
    kernels.launch("spmv_wide", op.cols.data_ptr(), op.vals.data_ptr(),
                   op.ell, op.out_dim, op.rowptr.data_ptr(),
                   op.sp_cols.data_ptr(), op.sp_vals.data_ptr(), int(narrow),
                   x.data_ptr(), out.data_ptr(), op.out_dim, out_rows, n,
                   *f.kernel_args)
    spmv_wide.launches += 1
    return out


spmv_wide.launches = 0


# ---------------------------------------------------------------------------
# Gram
# ---------------------------------------------------------------------------

def gram_wide_plain(v: torch.Tensor, av: torch.Tensor, p: int
                    ) -> torch.Tensor:
    """Plain PyTorch version of the gram_wide kernel: [v | Av]^T Av mod p,
    (2n, n) int64, one column of [v | Av] at a time."""
    X = torch.cat([v, av], dim=1).to(torch.int64)
    avl = av.to(torch.int64)
    rows = [gw.sum_mod(p, gw.mulmod(p, X[:, i:i + 1], avl), 0)
            for i in range(X.shape[1])]
    return torch.stack(rows)


def gram_wide(v: torch.Tensor, av: torch.Tensor, f: GFpWide,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """[v | Av]^T Av mod p for (N, n) int64 blocks, (2n, n) int64.  CUDA
    tensors launch the gram_wide kernel; CPU tensors take
    gram_wide_plain.  `out` (CUDA only) is an optional (2n, n) buffer.
    Calls that share a device must run on one stream (they share the
    kernel's scratch)."""
    if v.dim() != 2 or v.shape != av.shape:
        raise ValueError("gram_wide needs two (N, n) blocks")
    if v.device.type == "cpu":
        return gram_wide_plain(v, av, f.p)
    N, n = v.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"gram_wide supports 1 <= n <= {MAX_N} (got {n})")
    if out is None:
        out = torch.empty((2 * n, n), dtype=torch.int64, device=v.device)
    elif out.shape != (2 * n, n):
        raise ValueError(f"out must be ({2 * n}, {n})")
    scratch = _scratch.get(v.device)
    if scratch is None:
        scratch = _scratch[v.device] = torch.zeros(
            _GRAM_SCRATCH, dtype=torch.int64, device=v.device)
    kernels.check_operands("gram_wide", v, av, out, scratch,
                           dtype=torch.int64)
    kernels.launch("gram_wide", v.data_ptr(), av.data_ptr(), n, N,
                   *f.kernel_args, scratch.data_ptr(), out.data_ptr())
    gram_wide.launches += 1
    return out


gram_wide.launches = 0


# ---------------------------------------------------------------------------
# Semi-inverse
# ---------------------------------------------------------------------------

def _eliminate_plain(p: int, M: torch.Tensor, W: torch.Tensor | None):
    """One Gauss-Jordan sweep as the reference takes it (the JAX package's
    semi_inverse_py / _eliminate_device): per column the first row i >= j
    with M[i, j] != 0 is the pivot, its row is normalised and swapped to j,
    and every other row subtracts M[i, j] times row j, in M and W.  The
    pivot's inverse is taken on the host (pow, one read of the pivot a
    step): this version is a reference, not a fast path.  Returns
    (M, W, d, npiv), d int64 0/1."""
    n = M.shape[0]
    d = torch.zeros(n, dtype=torch.int64, device=M.device)
    npiv = 0
    for j in range(n):
        nz = torch.nonzero(M[j:, j]).flatten()
        if nz.numel() == 0:
            continue
        piv = j + int(nz[0])
        d[j] = 1
        npiv += 1
        pinv = pow(int(M[piv, j]), p - 2, p)
        perm = torch.arange(n, device=M.device)
        perm[j], perm[piv] = piv, j
        M = M[perm]
        M[j] = gw.mulmod(p, M[j], pinv)
        mult = gw.modneg(p, M[:, j])
        mult[j] = 0
        M = gw.modadd(p, M, gw.mulmod(p, mult[:, None], M[j][None, :]))
        if W is not None:
            W = W[perm]
            W[j] = gw.mulmod(p, W[j], pinv)
            W = gw.modadd(p, W, gw.mulmod(p, mult[:, None], W[j][None, :]))
    return M, W, d, npiv


def invariants_ok(p: int, vtAv, vtAAv, winv, d) -> torch.Tensor:
    """0-dim bool: the per-iteration checks of the JAX package's
    models/lanczos_wide.py::check_invariants_device (symmetry of vtAv,
    vtAAv, winv; winv's support within d; winv * (vtAv*d) == diag(d))."""
    ok = (vtAv == vtAv.T).all() & (vtAAv == vtAAv.T).all() \
        & (winv == winv.T).all()
    db = d.to(torch.bool)
    ok &= ((winv == 0) | db[:, None] | db[None, :]).all()
    vtAvd = torch.where(db[None, :], vtAv, torch.zeros_like(vtAv))
    check = gw.matmul_mod(p, winv, vtAvd)
    eye = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    ok &= torch.where(eye, check == d[None, :].to(torch.int64),
                      check == 0).all()
    return ok


def orthogonalize_rhs(p: int, vtAv, vtAAv, winv, d) -> torch.Tensor:
    """[[c, winv], [vtAvd, 0]] with c = -winv*where(d, vtAAv, vtAv) and
    vtAvd = where(d, -vtAv, 0), as (2n, 2n) int64."""
    n = d.shape[0]
    dmask = d.to(torch.bool)[None, :]
    c = gw.modneg(p, gw.matmul_mod(p, winv, torch.where(dmask, vtAAv, vtAv)))
    vtAvd = torch.where(dmask, gw.modneg(p, vtAv), torch.zeros_like(vtAv))
    zero = torch.zeros((n, n), dtype=torch.int64, device=d.device)
    return torch.cat([torch.cat([c, winv], dim=1),
                      torch.cat([vtAvd, zero], dim=1)])


def semi_inverse_wide_plain(grams: torch.Tensor, p: int,
                            state: torch.Tensor,
                            check: bool = True) -> SemiInverse:
    """Plain PyTorch version of the semi_inverse_wide kernel (the same
    outputs and the same state update)."""
    n = grams.shape[1]
    U = grams[:n].to(torch.int64)
    UA = grams[n:2 * n].to(torch.int64)
    _, _, d1, _ = _eliminate_plain(p, U.clone(), None)
    mask = (d1[:, None] * d1[None, :]).to(torch.bool)
    M2 = torch.where(mask, U, torch.zeros_like(U))
    W0 = torch.eye(n, dtype=torch.int64, device=U.device) * d1[None, :]
    _, W, d, npiv = _eliminate_plain(p, M2, W0)
    ok = invariants_ok(p, U, UA, W, d) if check else \
        torch.ones((), dtype=torch.bool, device=U.device)
    rhs = orthogonalize_rhs(p, U, UA, W, d)
    frozen = state[FROZEN] != 0
    new = torch.stack([torch.tensor(int(npiv == 0), device=state.device),
                       ok.to(state.device)]).to(torch.int32)
    state[:2] = torch.where(frozen, state[:2], new)
    return SemiInverse(W, d.to(torch.int32),
                       torch.tensor([npiv], dtype=torch.int32,
                                    device=U.device), rhs)


def empty_outputs(n: int, device) -> SemiInverse:
    """Output buffers for `semi_inverse_wide(..., out=)`."""
    return SemiInverse(
        torch.empty((n, n), dtype=torch.int64, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(1, dtype=torch.int32, device=device),
        torch.empty((2 * n, 2 * n), dtype=torch.int64, device=device))


def semi_inverse_wide(grams: torch.Tensor, f: GFpWide, state: torch.Tensor,
                      check: bool = True, out: SemiInverse | None = None
                      ) -> SemiInverse:
    """(winv, d, npiv, rhs) of grams = [vtAv ; vtAAv] (2n, n) int64,
    updating the solver state in place.  CUDA tensors launch the
    semi_inverse_wide kernel; CPU tensors take semi_inverse_wide_plain.
    `out` (CUDA only) is an optional preallocated result (`empty_outputs`)."""
    n = grams.shape[1]
    if grams.shape[0] != 2 * n or state.shape != (4,):
        raise ValueError("semi_inverse_wide needs (2n, n) grams and a "
                         "4-state")
    if out is not None and [tuple(t.shape) for t in out] != \
            [(n, n), (n,), (1,), (2 * n, 2 * n)]:
        raise ValueError(f"out must be semi_inverse_wide outputs for n = {n}")
    if grams.device.type == "cpu":
        return semi_inverse_wide_plain(grams, f.p, state, check)
    if n > MAX_N:
        raise ValueError(f"the semi_inverse_wide kernel supports n <= "
                         f"{MAX_N} (got {n})")
    if out is None:
        out = empty_outputs(n, grams.device)
    kernels.check_operands("semi_inverse_wide", grams, out.winv, out.rhs,
                           dtype=torch.int64)
    kernels.check_operands("semi_inverse_wide", state, out.d, out.npiv)
    kernels.launch("semi_inverse_wide", grams.data_ptr(), n, *f.kernel_args,
                   int(bool(check)), out.winv.data_ptr(), out.d.data_ptr(),
                   out.npiv.data_ptr(), out.rhs.data_ptr(), state.data_ptr())
    semi_inverse_wide.launches += 1
    return out


semi_inverse_wide.launches = 0
