"""Bitsliced block Lanczos over GF(2), one device: the integer-factorization
case.

The port's counterpart of the JAX package's models/lanczos_gf2.py.  A block
of n vectors (n % 32 == 0) is (N, n/32) words (int32 bit patterns; see
ops/gf2.py); the SpMV streams only column indices and every reduction is
XOR.  Same recurrence, stop probe and xoshiro v0 stream as the narrow
solver (models/lanczos.py), so iterates are bit-identical to the JAX
package's BlockLanczosGF2 and, with dedup=False, to the generic solver at
p = 2.

One iteration is five kernel launches on the CUDA device: two `spmv_gf2`
(one launch per column band where the operator is banded: an x that the
card's L2 cannot hold is split by column at layout time, choose_bands),
one `gram_gf2`, one `semi_inverse_gf2` (with the invariant checks and the
update's right-hand side) and one `orthogonalize_gf2`, which updates v and
p in place.  The device keeps the latched [stop, inv_ok, k_done, frozen]
state of ops/semi_inverse.py, so the host runs up to K iterations per sync
(models/lanczos.py::blocked_solve_loop); once a halt is latched v and p
stay as they were (on a stop, the pre-update block) and the rest of the
block recomputes the same values.  Zero padding rows stay zero throughout.
On CUDA the solve ends on the card as well: one `final_unpack` launch
(csrc/gf2_final.cu) unpacks v's bit block and decides the final check,
and only the unpacked block (and, on a failed check, tmp's) is downloaded.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.models.lanczos import (LanczosSolver,
                                                    final_check,
                                                    resolve_device,
                                                    resume_rows)
from block_lanczos_tpu_torch.ops import gf2
from block_lanczos_tpu_torch.ops.gf2 import (WORD, colmask, gram_gf2,
                                             matmul_gf2, semi_inverse_gf2)
from block_lanczos_tpu_torch.ops.semi_inverse import (FROZEN, INV_OK, K_DONE,
                                                      STOP)
from block_lanczos_tpu_torch.ops.spmm import _check_args, build_hybrid_arrays
from block_lanczos_tpu_torch.ops.xoshiro import xoshiro_fill
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix


# ---------------------------------------------------------------------------
# Sparse operator: ELL slab of column indices + CSR spill
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GF2Op:
    """One direction of a GF(2) operator: y (out_dim) = op * x (in_dim).

    y[r] = XOR over k < ell of (bit k % 32 of valid[k // 32, r] ?
           x[cols[k, r]] : 0)  XOR  XOR over e in rowptr[r]..rowptr[r+1]
           of x[sp_cols[e]].
    The slab and the valid bits are column-major ((ell, out_dim) and
    (ceil(ell/32), out_dim)), so that neighbouring rows read neighbouring
    addresses; padding slots hold column 0 and a clear valid bit (column 0
    is a real row of x: only `valid` excludes them).
    """
    out_dim: int
    in_dim: int
    nnz: int
    ell: int
    cols: torch.Tensor     # (ell, out_dim) int32
    valid: torch.Tensor    # (ceil(ell / 32), out_dim) int32 bit words
    rowptr: torch.Tensor   # (out_dim + 1,) int32, spill row boundaries
    sp_cols: torch.Tensor  # (spill_nnz,) int32

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def spill_nnz(self) -> int:
        return int(self.sp_cols.shape[0])

    def to(self, device) -> "GF2Op":
        move = {k: getattr(self, k).to(device) for k in
                ("cols", "valid", "rowptr", "sp_cols")}
        return dataclasses.replace(self, **move)


def build_gf2_arrays(out_idx, in_idx, out_dim: int, ell: int | None = None):
    """Host construction of the slab, its valid bits and the CSR spill.

    The narrow field's layout (spmm.build_hybrid_arrays) with every value 1:
    its slab values mark the filled slots and become the valid bits.  The
    same slab, valid bits and spill as the JAX package's build_gf2_arrays,
    transposed to the column-major layout and without its spill padding.
    Returns a dict of NumPy arrays (cols, valid, rowptr, sp_cols) plus ell
    and nnz.
    """
    a = build_hybrid_arrays(out_idx, in_idx, np.ones(len(out_idx), np.uint32),
                            out_dim, ell)
    ell = a["ell"]
    valid01 = np.zeros((-(-ell // WORD) * WORD, out_dim), np.uint32)
    valid01[:ell] = a["vals"]
    valid = gf2.pack_bits_np(valid01.T).T            # (vwords, out_dim)
    return dict(ell=ell, nnz=a["nnz"], cols=a["cols"],
                valid=np.ascontiguousarray(valid).view(np.int32),
                rowptr=a["rowptr"], sp_cols=a["sp_cols"])


def gf2_op_from_arrays(arrays: dict, out_dim: int, in_dim: int) -> GF2Op:
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in ("cols", "valid", "rowptr", "sp_cols")}
    return GF2Op(out_dim=int(out_dim), in_dim=int(in_dim),
                 nnz=int(arrays["nnz"]), ell=int(arrays["ell"]), **t)


# The share of the card's L2 that one band's slice of x may take; the rest
# holds the index streams and y in flight.  The number of bands follows from
# the card's own L2 size, read at run time (BlockLanczosGF2).
BAND_L2_SHARE = 0.5


def choose_bands(in_dim: int, W: int, l2_bytes: int | None) -> int:
    """The fewest column bands whose slice of x (in_dim rows of W words)
    takes at most BAND_L2_SHARE of an L2 of l2_bytes; 1 without an L2 size
    (the CPU)."""
    if not l2_bytes:
        return 1
    per_band = int(l2_bytes * BAND_L2_SHARE)
    return max(1, -(-(in_dim * W * 4) // per_band))


def make_gf2_op(out_idx, in_idx, out_dim: int, in_dim: int,
                ell: int | None = None) -> GF2Op:
    """A CPU GF2Op from COO indices of the odd entries (all equal to 1 mod
    2); `.to(device)` moves it."""
    return gf2_op_from_arrays(build_gf2_arrays(out_idx, in_idx, out_dim, ell),
                              out_dim, in_dim)


def make_gf2_bands(out_idx, in_idx, out_dim: int, in_dim: int, bands: int,
                   ell: int | None = None) -> tuple:
    """The operator split by column into `bands` CPU GF2Ops: band b holds
    the entries whose column lies in [in_dim * b // bands, in_dim * (b + 1)
    // bands), over the whole of x (absolute columns).  The operator is the
    XOR of its bands; one band is make_gf2_op's layout.  `ell`, when given,
    is every band's slab width."""
    out_idx = np.asarray(out_idx, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    parts = []
    for b in range(bands):
        sel = ((in_idx >= in_dim * b // bands)
               & (in_idx < in_dim * (b + 1) // bands))
        parts.append(make_gf2_op(out_idx[sel], in_idx[sel], out_dim, in_dim,
                                 ell))
    return tuple(parts)


# ---------------------------------------------------------------------------
# The spmv_gf2 kernel and its plain version
# ---------------------------------------------------------------------------

def spmv_gf2_plain(ops: tuple, x: torch.Tensor,
                   out_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the spmv_gf2 kernel over the bands `ops`
    (a tuple of GF2Op): per band the slab as masked XORs slot by slot and
    the spill as bit counts of its rows kept mod 2, the bands XORed
    together; (out_rows, W) words with zero rows past out_dim."""
    out_dim = ops[0].out_dim
    out_rows = out_dim if out_rows is None else int(out_rows)
    W = x.shape[1]
    y = torch.zeros((out_dim, W), dtype=torch.int32, device=x.device)
    for op in ops:
        _check_args(op, x, out_rows)
        for k in range(op.ell):
            mask = -((op.valid[k // WORD] >> (k % WORD)) & 1)
            y ^= mask[:, None] & x[op.cols[k].long()]
        if op.spill_nnz:
            rows = torch.repeat_interleave(
                torch.arange(out_dim, device=x.device),
                (op.rowptr[1:] - op.rowptr[:-1]).long())
            counts = torch.zeros((out_dim, W * WORD), dtype=torch.int32,
                                 device=x.device)
            counts.index_add_(0, rows,
                              gf2.unpack_bits(x[op.sp_cols.long()]))
            y ^= gf2.pack_bits(counts & 1)
    out = torch.zeros((out_rows, W), dtype=torch.int32, device=x.device)
    out[:out_dim] = y
    return out


def spmv_gf2(ops: tuple, x: torch.Tensor, out_rows: int | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """y = op * x over GF(2) for an operator held as a tuple of column
    bands (GF2Ops of one out_dim and in_dim; one band when unbanded); x
    (in_pad >= in_dim, W) words, y (out_rows, W) with zero rows past
    out_dim.  CUDA tensors launch the spmv_gf2 kernel once per band (the
    first writes y, the rest XOR into it); CPU tensors take
    spmv_gf2_plain.  `out` (CUDA only) is an optional preallocated result
    buffer."""
    out_rows = ops[0].out_dim if out_rows is None else int(out_rows)
    if x.device.type == "cpu":
        return spmv_gf2_plain(ops, x, out_rows)
    W = x.shape[1]
    gf2.check_width(W * WORD)
    if out is None:
        out = torch.empty((out_rows, W), dtype=torch.int32, device=x.device)
    elif out.shape != (out_rows, W):
        raise ValueError(f"out must be ({out_rows}, {W})")
    for k, op in enumerate(ops):
        _check_args(op, x, out_rows)
        kernels.check_operands("spmv_gf2", x, out, op.cols, op.valid,
                               op.rowptr, op.sp_cols)
        kernels.launch("spmv_gf2", op.cols.data_ptr(), op.valid.data_ptr(),
                       op.ell, op.out_dim, op.rowptr.data_ptr(),
                       op.sp_cols.data_ptr(), x.data_ptr(), out.data_ptr(),
                       op.out_dim, out_rows, W, int(k > 0))
        spmv_gf2.launches += 1
    return out


spmv_gf2.launches = 0


# ---------------------------------------------------------------------------
# The orthogonalize_gf2 kernel and its plain version
# ---------------------------------------------------------------------------

def orthogonalize_gf2_plain(v, p_blk, Av, rhs, d, state) -> None:
    """Plain PyTorch version of the orthogonalize_gf2 kernel (in place,
    with the same halt and k_done / frozen bookkeeping)."""
    W = v.shape[1]
    halt = (state[STOP] != 0) | (state[INV_OK] == 0)
    frozen = state[FROZEN] != 0
    upd = matmul_gf2(torch.cat([v, p_blk], dim=1), rhs, 2 * W * WORD)
    cm = colmask(d)[None, :]
    v_next = ((Av & cm) | (v & ~cm)) ^ upd[:, :W]
    p_next = (p_blk & ~cm) ^ upd[:, W:]
    v.copy_(torch.where(halt, v, v_next))
    p_blk.copy_(torch.where(halt, p_blk, p_next))
    state[K_DONE] += (~frozen).to(state.dtype)
    state[FROZEN] = (frozen | halt).to(state.dtype)


def orthogonalize_gf2(v, p_blk, Av, rhs, d, state) -> None:
    """v, p <- the recurrence step over GF(2), IN PLACE, unless the state
    holds a halt:  upd = [v | p] * rhs,
        v <- ((Av & cm) | (v & ~cm)) ^ upd[:, :W],  p <- (p & ~cm) ^ upd[:, W:]
    with cm the column mask of d.  Counts the iteration in state[k_done]
    while the state is not frozen and freezes it on a halt.  CUDA tensors
    launch the orthogonalize_gf2 kernel; CPU tensors take
    orthogonalize_gf2_plain."""
    N, W = v.shape
    n = W * WORD
    if p_blk.shape != (N, W) or Av.shape != (N, W) \
            or rhs.shape != (2 * n, 2 * W) or d.shape != (n,):
        raise ValueError("orthogonalize_gf2: inconsistent block shapes")
    if v.device.type == "cpu":
        return orthogonalize_gf2_plain(v, p_blk, Av, rhs, d, state)
    gf2.check_width(n)
    kernels.check_operands("orthogonalize_gf2", v, p_blk, Av, rhs, d, state)
    kernels.launch("orthogonalize_gf2", v.data_ptr(), p_blk.data_ptr(),
                   Av.data_ptr(), rhs.data_ptr(), d.data_ptr(), N, W,
                   state.data_ptr())
    orthogonalize_gf2.launches += 1


orthogonalize_gf2.launches = 0

_WRAPPERS = (spmv_gf2, gram_gf2, semi_inverse_gf2, orthogonalize_gf2,
             xoshiro_fill, gf2.final_unpack)


def launch_counts() -> dict:
    """{kernel name: launches} of the four GF(2) kernel wrappers,
    xoshiro_fill (v0 drawn on the card, once a solve) and final_unpack (the
    final step on the card: once a solve, twice when the check fails)."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------

def iteration_step(n: int, mp_rows: int, np_rows: int, check: bool,
                   first_op: tuple, second_op: tuple, v, p_blk, state,
                   ws=None):
    """One full GF(2) Lanczos iteration on v's device; v and p_blk are
    updated in place (left as they are once the state holds a halt).

    first_op, second_op: the two directions, each a tuple of GF2Op column
    bands (spmv_gf2).  ws: optional dict of reusable buffers ("tmp", "av",
    "grams", "si").  Returns (v, p_blk, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok), the
    JAX package's iteration_step outputs, with stop / inv_ok the latched
    state after this iteration.
    """
    ws = {} if ws is None else ws
    tmp = spmv_gf2(first_op, v, out_rows=mp_rows, out=ws.get("tmp"))
    Av = spmv_gf2(second_op, tmp, out_rows=np_rows, out=ws.get("av"))
    grams = gram_gf2(v, Av, out=ws.get("grams"))
    si = semi_inverse_gf2(grams, state, check, out=ws.get("si"))
    orthogonalize_gf2(v, p_blk, Av, si.rhs, si.d, state)
    ws.update(tmp=tmp, av=Av, grams=grams, si=si)
    return (v, p_blk, tmp, Av, grams[:n], grams[n:], si.winv, si.d,
            state[STOP] != 0, state[INV_OK] != 0)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class BlockLanczosGF2(LanczosSolver):
    """Single-device bitsliced GF(2) solver; the API mirrors BlockLanczos.

    Requires p == 2 and n % 32 == 0 (32 <= n <= 512 on CUDA).  Even entries
    are dropped at construction; the rest all equal 1.  dedup (default on)
    drops duplicate m_eff-side lines, which cancel out of A over GF(2)
    (ops/gf2.py::dedup_lines); dedup=False keeps the reference's operator.
    device=None runs on CUDA and raises when CUDA is absent; device="cpu"
    runs the plain PyTorch versions of the kernels.
    """

    field = "gf2"   # the checkpoint manifest's field
    _launch_counts = staticmethod(launch_counts)

    def __init__(self, M: COOMatrix, n: int = 32, right: bool = False,
                 check_invariants: bool = True,
                 sync_every: int | None = None, dedup: bool = True,
                 device=None):
        self.device = resolve_device(device)
        if int(M.prime) != 2:
            raise ValueError("BlockLanczosGF2 requires p == 2")
        self.n = int(n)
        self.W = (gf2.check_width(self.n) if self.device.type == "cuda"
                  else gf2.words(self.n))
        with profiling.span("layout", field=self.field):
            odd = (np.asarray(M.x) & 1) == 1
            i, j = M.i[odd], M.j[odd]
            if dedup:
                with profiling.span("layout.dedup"):
                    i, j, nrows_eff, ncols_eff, n_dup, n_empty = \
                        gf2.dedup_lines(i, j, M.nrows, M.ncols, right)
            else:
                nrows_eff, ncols_eff, n_dup, n_empty = (M.nrows, M.ncols, 0,
                                                        0)
            l2 = (torch.cuda.get_device_properties(self.device).L2_cache_size
                  if self.device.type == "cuda" else None)
            # each direction as a tuple of column bands (spmv_gf2)
            with profiling.span("layout.build"):
                fwd, bwd = (make_gf2_bands(o, c, out_dim, in_dim,
                                           choose_bands(in_dim, self.W, l2))
                            for o, c, out_dim, in_dim in (
                                (i, j, nrows_eff, ncols_eff),
                                (j, i, ncols_eff, nrows_eff)))
            with profiling.span("layout.upload"):
                fwd, bwd = (tuple(b.to(self.device) for b in bands)
                            for bands in (fwd, bwd))
        self.dedup_dropped = (n_dup, n_empty)
        self.nnz = len(i)
        self._setup(right, check_invariants, sync_every, nrows_eff, ncols_eff,
                    fwd, bwd, functools.partial(iteration_step, self.n), 2,
                    self.W)
        # the final step's unpack and check: on the card on CUDA
        # (csrc/gf2_final.cu), in NumPy otherwise
        self._final_on_card = self.device.type == "cuda"

    def _v0_host(self) -> torch.Tensor:
        with profiling.span("v0.draw", device="cpu"):
            bits = self._rng.fill_mod(self.n_eff * self.n, 2)
        with profiling.span("v0.pack"):
            block = np.zeros((self.np_rows, self.n), np.uint32)
            block[:self.n_eff] = bits.reshape(self.n_eff, self.n)
            v0 = gf2.pack_bits_np(block).view(np.int32)
        with profiling.span("v0.upload"):
            return torch.from_numpy(v0).to(self.device)

    def _resume_block(self, resume_state: dict, name: str) -> torch.Tensor:
        arr = resume_rows(resume_state, name, self.np_rows, self.W)
        words32 = np.ascontiguousarray(arr).astype(np.uint32).view(np.int32)
        return torch.from_numpy(words32).to(self.device)

    def _banner(self) -> list:
        lines = ["Block Lanczos [GF(2) bitsliced]"]
        if any(self.dedup_dropped):
            nd, ne = self.dedup_dropped
            lines.append(f"  - GF(2) dedup: dropped {nd} duplicate + {ne} "
                         "empty lines (operator rank restoration)")
        return lines

    def _workspace(self) -> dict:
        """iteration_step's buffers, and on the card the final step's
        unpacked block and flags."""
        n, W, dev = self.n, self.W, self.device
        ws = {"tmp": torch.zeros((self.mp_rows, W), dtype=torch.int32,
                                 device=dev)}
        if dev.type == "cuda":
            ws["av"] = torch.empty((self.np_rows, W), dtype=torch.int32,
                                   device=dev)
            ws["grams"] = torch.empty((2 * n, W), dtype=torch.int32,
                                      device=dev)
            ws["si"] = gf2.empty_outputs(n, dev)
        if self._final_on_card:
            ws["unpacked"] = torch.empty((self.np_rows, n), dtype=torch.int32,
                                         device=dev)
            ws["flags"] = torch.empty(2, dtype=torch.int32, device=dev)
        return ws

    def _invariant_failure(self, ws, iteration):
        raise AssertionError(f"device invariant check failed (GF2) at "
                             f"iteration ~{iteration}")

    def _final(self, v, tmp, ws, verbose):
        if self._final_on_card:
            return self._final_card(v, tmp, ws, verbose)
        return self._final_host(v, tmp, verbose)

    def _final_host(self, v, tmp, verbose):
        """The final step in NumPy: (kernel, v_nonzero, product_zero, vtM)
        from v's and tmp's words downloaded and unpacked; tmp None (a solve
        stopped by its limit) gives the kernel block alone."""
        n = self.n
        v_nonzero = product_zero = vtM = None
        with profiling.span("final.download"):
            v_words = v.cpu().numpy()
            tmp_words = None if tmp is None else tmp.cpu().numpy()
        with profiling.span("final.unpack", device="cpu"):
            v_bits = gf2.unpack_bits_np(v_words, n)
            tmp_bits = (None if tmp_words is None
                        else gf2.unpack_bits_np(tmp_words, n))
        if tmp_bits is not None:
            v_nonzero, product_zero = final_check(
                v_bits, tmp_bits, self.n_eff, self.m_eff, verbose)
            if not product_zero:
                vtM = tmp_bits[:self.m_eff]
        return v_bits[:self.n_eff], v_nonzero, product_zero, vtM

    def _final_card(self, v, tmp, ws, verbose):
        """The final step on the card, as _final_host returns it: one
        final_unpack launch writes v's bits into ws["unpacked"] and the
        flags of a nonzero v and a nonzero tmp into ws["flags"], one read of
        the flags decides the check, and one download brings the kernel
        block.  tmp's bits (vtM) are unpacked and downloaded only when the
        check fails."""
        n, n_eff, m_eff = self.n, self.n_eff, self.m_eff
        flags = ws["flags"]
        v_nonzero = product_zero = vtM = None
        with profiling.span("final.unpack", device="cuda"):
            gf2.final_unpack(v, tmp, n_eff, m_eff, n, ws["unpacked"], flags)
        profiling.count("final_unpack_device")
        if tmp is not None:
            # flags[0] (flags[1]) is nonzero iff a word of v (of tmp) is:
            # as one-row blocks standing for v and vtM they give final_check
            # its two answers, and its report
            v_nonzero, product_zero = final_check(flags[:1], flags[1:], 1, 1,
                                                  verbose)
        with profiling.span("final.download"):
            kernel = ws["unpacked"][:n_eff].cpu().numpy().view(np.uint32)
            if tmp is not None and not product_zero:
                bits = torch.empty((m_eff, n), dtype=torch.int32,
                                   device=v.device)
                gf2.final_unpack(tmp, None, m_eff, 0, n, bits, flags)
                vtM = bits.cpu().numpy().view(np.uint32)
        return kernel, v_nonzero, product_zero, vtM
