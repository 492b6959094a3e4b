"""Exact mod-p sparse products over the hybrid ELL + CSR-spill layout.

The port's own copy of the JAX package's hybrid layout (ops/spmm.py:
choose_ell_width, build_hybrid_arrays): each output row keeps up to L
entries in a dense slab and spills the rest to a CSR sidecar, with L chosen
to minimise rows*L + 3*spill.  Unlike the TPU layout, columns are absolute
int32 and values are standard-form residues (no Montgomery form, no u16
delta columns, no input bands: those only change the layout, and mod-p
sums are associative).  The slab is stored column-major, (L, out_dim), so
that neighbouring rows read neighbouring addresses.

`spmv` wraps the `spmv_ell` CUDA kernel (csrc/spmv_ell.cu); `spmv_plain` is
its plain PyTorch version, which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops.gfp import GFp, barrett_mu


@dataclasses.dataclass(frozen=True)
class HybridOp:
    """One direction of a sparse operator: y (out_dim) = op * x (in_dim).

    y[r] = sum_k vals[k, r] * x[cols[k, r]]
         + sum_{e in rowptr[r]..rowptr[r+1]} sp_vals[e] * x[sp_cols[e]]
    exactly mod p.  Empty slab slots hold column 0 and value 0.
    """
    p: int
    out_dim: int
    in_dim: int
    nnz: int
    ell: int
    cols: torch.Tensor     # (ell, out_dim) int32
    vals: torch.Tensor     # (ell, out_dim) int32 residues in [0, p); for a
                           # wide prime int64 residues or int32 signed
                           # coefficients (ops/wide_ops.py)
    rowptr: torch.Tensor   # (out_dim + 1,) int32, spill row boundaries
    sp_cols: torch.Tensor  # (spill_nnz,) int32
    sp_vals: torch.Tensor  # (spill_nnz,) of the slab's kind

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def spill_nnz(self) -> int:
        return int(self.sp_vals.shape[0])

    def to(self, device) -> "HybridOp":
        move = {k: getattr(self, k).to(device) for k in
                ("cols", "vals", "rowptr", "sp_cols", "sp_vals")}
        return dataclasses.replace(self, **move)


@dataclasses.dataclass(frozen=True)
class SpMatrix:
    """A sparse matrix with both application directions."""
    nrows: int
    ncols: int
    nnz: int
    fwd: HybridOp  # y (nrows) = M  * x (ncols)
    bwd: HybridOp  # y (ncols) = M^T * x (nrows)

    @staticmethod
    def from_coo(f: GFp, M) -> "SpMatrix":
        return SpMatrix(M.nrows, M.ncols, M.nnz,
                        make_hybrid_op(f, M.i, M.j, M.x, M.nrows, M.ncols),
                        make_hybrid_op(f, M.j, M.i, M.x, M.ncols, M.nrows))

    def to(self, device) -> "SpMatrix":
        return dataclasses.replace(self, fwd=self.fwd.to(device),
                                   bwd=self.bwd.to(device))


# ---------------------------------------------------------------------------
# Layout builder (host, NumPy)
# ---------------------------------------------------------------------------

def _ell_candidates(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts)
    if counts.size == 0 or counts.max() == 0:
        return np.array([1], np.int64)
    cands = np.unique(np.concatenate([
        np.percentile(counts[counts > 0], [50, 75, 90, 95, 99, 100])
        .astype(np.int64),
        [1, int(counts.mean() + 1)]]))
    return cands[cands >= 1]


def choose_ell_width(counts: np.ndarray, spill_cost: float = 3.0) -> int:
    """Pick the slab width L minimising rows*L + spill_cost*spill_nnz(L)."""
    counts = np.asarray(counts)
    best, best_cost = 1, None
    for L in sorted({int(c) for c in _ell_candidates(counts)}):
        spill = int(np.maximum(counts - L, 0).sum()) if counts.size else 0
        cost = float(counts.size * L + spill_cost * spill)
        if best_cost is None or cost < best_cost:
            best, best_cost = L, cost
    return best


def build_hybrid_arrays(out_idx, in_idx, vals, out_dim: int,
                        ell: int | None = None, dtype=np.int32):
    """Host construction of the column-major slab and the CSR spill.

    vals are residues in [0, p), stored as `dtype` (int32 for the narrow
    field, int64 for the wide one), or signed coefficients (a signed
    integer array: the wide field's narrow slab, int32).  Returns a dict of
    NumPy arrays (cols, vals, rowptr, sp_cols, sp_vals) plus ell and nnz.
    Within a row the entries keep their input order; the first `ell` go to
    the slab.
    """
    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int32)
    vals = np.asarray(vals)
    if vals.dtype.kind != "i":
        vals = vals.astype(np.uint64 if dtype == np.int64 else np.uint32)
    nnz = len(vals)
    order = np.argsort(out_idx, kind="stable")
    out_idx, in_idx, vals = out_idx[order], in_idx[order], vals[order]
    counts = np.bincount(out_idx, minlength=out_dim) if nnz else \
        np.zeros(out_dim, np.int64)
    if ell is None:
        ell = choose_ell_width(counts)
    starts = np.zeros(out_dim + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(nnz, dtype=np.int64) - starts[out_idx]
    in_slab = pos < ell
    flat = (pos * out_dim + out_idx)[in_slab]   # column-major (ell, out_dim)
    cols = np.zeros(ell * out_dim, np.int32)
    svals = np.zeros(ell * out_dim, dtype)
    cols[flat] = in_idx[in_slab]
    svals[flat] = vals[in_slab]
    sp = ~in_slab
    spill_counts = np.maximum(counts - ell, 0)
    rowptr = np.zeros(out_dim + 1, np.int64)
    np.cumsum(spill_counts, out=rowptr[1:])
    if rowptr[-1] >= 1 << 31:
        raise ValueError("spill sidecar exceeds 2^31 entries")
    return dict(ell=int(ell), nnz=nnz,
                cols=cols.reshape(ell, out_dim),
                vals=svals.reshape(ell, out_dim),
                rowptr=rowptr.astype(np.int32),
                sp_cols=in_idx[sp].astype(np.int32),
                sp_vals=vals[sp].astype(dtype))


def hybrid_op_from_arrays(p: int, arrays: dict, out_dim: int,
                          in_dim: int) -> HybridOp:
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in ("cols", "vals", "rowptr", "sp_cols", "sp_vals")}
    return HybridOp(p=int(p), out_dim=int(out_dim), in_dim=int(in_dim),
                    nnz=int(arrays["nnz"]), ell=int(arrays["ell"]), **t)


def make_hybrid_op(f: GFp, out_idx, in_idx, vals, out_dim: int, in_dim: int,
                   ell: int | None = None) -> HybridOp:
    """A CPU HybridOp from COO arrays (values in [0, p)); `.to(device)`
    moves it."""
    arrays = build_hybrid_arrays(out_idx, in_idx, vals, out_dim, ell)
    return hybrid_op_from_arrays(f.p, arrays, out_dim, in_dim)


# ---------------------------------------------------------------------------
# The product
# ---------------------------------------------------------------------------

def _check_args(op: HybridOp, x: torch.Tensor, out_rows: int):
    if x.dim() != 2 or x.shape[0] < op.in_dim:
        raise ValueError(f"x must be (>= {op.in_dim}, n), got {tuple(x.shape)}")
    if out_rows < op.out_dim:
        raise ValueError(f"out_rows {out_rows} < out_dim {op.out_dim}")
    if x.device != op.device:
        raise ValueError(f"x on {x.device}, operator on {op.device}")


def spmv_plain(op: HybridOp, x: torch.Tensor,
               out_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the spmv_ell kernel: per slot an int64
    product reduced % p before any summing, then index_add_ over the
    spill; (out_rows, n) int32 with zero rows past out_dim."""
    out_rows = op.out_dim if out_rows is None else int(out_rows)
    _check_args(op, x, out_rows)
    p = op.p
    n = x.shape[1]
    xl = x.to(torch.int64)
    y = torch.zeros((op.out_dim, n), dtype=torch.int64, device=x.device)
    for k in range(op.ell):
        y += op.vals[k].to(torch.int64)[:, None] * xl[op.cols[k].long()] % p
    if op.spill_nnz:
        rows = torch.repeat_interleave(
            torch.arange(op.out_dim, device=x.device),
            (op.rowptr[1:] - op.rowptr[:-1]).long())
        prod = op.sp_vals.to(torch.int64)[:, None] * xl[op.sp_cols.long()] % p
        y.index_add_(0, rows, prod)
    out = torch.zeros((out_rows, n), dtype=torch.int32, device=x.device)
    out[:op.out_dim] = (y % p).to(torch.int32)
    return out


def spmv(op: HybridOp, x: torch.Tensor, out_rows: int | None = None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """y = op * x exactly mod p; (out_rows, n) int32, zero past out_dim.

    CUDA tensors launch the spmv_ell kernel; CPU tensors take spmv_plain.
    `out` (CUDA only) is an optional preallocated result buffer.
    """
    out_rows = op.out_dim if out_rows is None else int(out_rows)
    if x.device.type == "cpu":
        return spmv_plain(op, x, out_rows)
    _check_args(op, x, out_rows)
    n = x.shape[1]
    if out is None:
        out = torch.empty((out_rows, n), dtype=torch.int32, device=x.device)
    elif out.shape != (out_rows, n):
        raise ValueError(f"out must be ({out_rows}, {n})")
    kernels.check_operands("spmv_ell", x, out, op.cols, op.vals, op.rowptr,
                           op.sp_cols, op.sp_vals)
    kernels.launch("spmv_ell", op.cols.data_ptr(), op.vals.data_ptr(),
                   op.ell, op.out_dim, op.rowptr.data_ptr(),
                   op.sp_cols.data_ptr(), op.sp_vals.data_ptr(),
                   x.data_ptr(), out.data_ptr(), op.out_dim, out_rows, n,
                   op.p, barrett_mu(op.p))
    spmv.launches += 1
    return out


spmv.launches = 0
