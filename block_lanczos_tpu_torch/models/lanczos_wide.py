"""The block Lanczos solver for wide primes (2^30 - 35 < p < 2^62), one
device.

The port of the JAX package's models/lanczos_wide.py on int64 residues
(u64 in the kernels): the narrow solver's Thome recurrence, its fixed
xoshiro v0 stream (random64() % p, all 62 bits kept), its stop and
final-check semantics and its host loop (models/lanczos.py), with every
per-iteration operation a wide kernel:

    tmp = Mt*v ; Av = M*tmp          two spmv_wide  (ops/wide_ops.py)
    [vtAv ; vtAAv] = [v | Av]^T Av   gram_wide
    winv, d, rhs, state              semi_inverse_wide (checks fused)
    v, p <- [v | p] rhs + selects    orthogonalize_wide (here), in place

Five launches an iteration, as in the narrow solver; the device keeps the
latched state [stop, inv_ok, k_done, frozen] and the host syncs once a
block of K iterations (blocked_solve_loop).  Zero padding rows stay zero
through every kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.models.lanczos import (LanczosSolver,
                                                    resolve_device,
                                                    resume_rows)
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.ops import wide_ops as wo
from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
from block_lanczos_tpu_torch.ops.semi_inverse import (FROZEN, INV_OK, K_DONE,
                                                      STOP)
from block_lanczos_tpu_torch.ops.xoshiro import xoshiro_fill
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix

MAX_N = wo.MAX_N


# ---------------------------------------------------------------------------
# The orthogonalize kernel and its plain version
# ---------------------------------------------------------------------------

def orthogonalize_wide_plain(v, p_blk, Av, rhs, d, p: int, state) -> None:
    """Plain PyTorch version of the orthogonalize_wide kernel (in place,
    with the same halt and k_done/frozen bookkeeping)."""
    n = v.shape[1]
    halt = (state[STOP] != 0) | (state[INV_OK] == 0)
    frozen = state[FROZEN] != 0
    upd = gw.matmul_mod(p, torch.cat([v, p_blk], dim=1), rhs)
    dmask = d.to(torch.bool)[None, :]
    v_next = gw.modadd(p, torch.where(dmask, Av, v), upd[:, :n])
    p_next = gw.modadd(p, torch.where(dmask, torch.zeros_like(p_blk), p_blk),
                       upd[:, n:])
    v.copy_(torch.where(halt, v, v_next))
    p_blk.copy_(torch.where(halt, p_blk, p_next))
    state[K_DONE] += (~frozen).to(state.dtype)
    state[FROZEN] = (frozen | halt).to(state.dtype)


def orthogonalize_wide(v, p_blk, Av, rhs, d, f: GFpWide, state) -> None:
    """v, p <- the Thome recurrence step, IN PLACE, unless the state holds
    a halt (then v and p are left as they are).  Counts the iteration in
    state[k_done] while the state is not frozen and freezes it on a halt.
    CUDA tensors launch the orthogonalize_wide kernel; CPU tensors take
    orthogonalize_wide_plain."""
    N, n = v.shape
    if p_blk.shape != (N, n) or Av.shape != (N, n) \
            or rhs.shape != (2 * n, 2 * n) or d.shape != (n,):
        raise ValueError("orthogonalize_wide: inconsistent block shapes")
    if v.device.type == "cpu":
        return orthogonalize_wide_plain(v, p_blk, Av, rhs, d, f.p, state)
    if n > MAX_N:
        raise ValueError(f"the orthogonalize_wide kernel supports n <= "
                         f"{MAX_N} (got {n})")
    kernels.check_operands("orthogonalize_wide", v, p_blk, Av, rhs,
                           dtype=torch.int64)
    kernels.check_operands("orthogonalize_wide", d, state)
    kernels.launch("orthogonalize_wide", v.data_ptr(), p_blk.data_ptr(),
                   Av.data_ptr(), rhs.data_ptr(), d.data_ptr(), N, n,
                   *f.kernel_args, state.data_ptr())
    orthogonalize_wide.launches += 1


orthogonalize_wide.launches = 0

_WRAPPERS = {"spmv_wide": wo.spmv_wide, "gram_wide": wo.gram_wide,
             "semi_inverse_wide": wo.semi_inverse_wide,
             "orthogonalize_wide": orthogonalize_wide,
             "xoshiro_fill": xoshiro_fill}


def launch_counts() -> dict:
    """{kernel name: launches} of the four wide kernel wrappers and
    xoshiro_fill (v0 drawn on the card, once a solve)."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------

def iteration_step(f: GFpWide, mp_rows: int, np_rows: int, check: bool,
                   first_op, second_op, v, p_blk, state, ws=None):
    """One full Lanczos iteration on v's device; v and p_blk are updated in
    place (left as they are once the state holds a halt).

    first_op:  v (Np) -> tmp (Mp)   [Mt for left kernel, M for right]
    second_op: tmp (Mp) -> Av (Np)
    ws: optional dict of reusable buffers ("tmp", "av", "grams", "si").
    Returns (v, p_blk, tmp, Av, vtAv, vtAAv, winv, d, stop, inv_ok), the
    JAX package's iteration_step outputs, with stop/inv_ok the latched
    state after this iteration.
    """
    ws = {} if ws is None else ws
    n = v.shape[1]
    tmp = wo.spmv_wide(f, first_op, v, out_rows=mp_rows, out=ws.get("tmp"))
    Av = wo.spmv_wide(f, second_op, tmp, out_rows=np_rows, out=ws.get("av"))
    grams = wo.gram_wide(v, Av, f, out=ws.get("grams"))
    si = wo.semi_inverse_wide(grams, f, state, check, out=ws.get("si"))
    orthogonalize_wide(v, p_blk, Av, si.rhs, si.d, f, state)
    ws.update(tmp=tmp, av=Av, grams=grams, si=si)
    return (v, p_blk, tmp, Av, grams[:n], grams[n:], si.winv, si.d,
            state[STOP] != 0, state[INV_OK] != 0)


def check_invariants(p: int, vtAv, vtAAv, winv, d):
    """Per-iteration algebraic asserts on the host (for the message), over
    Python ints."""
    vtAv, vtAAv, winv = (np.asarray(a.cpu().numpy(), dtype=object)
                         for a in (vtAv, vtAAv, winv))
    d = d.cpu().numpy().astype(bool)
    assert (vtAv == vtAv.T).all(), "vtAv not symmetric"
    assert (vtAAv == vtAAv.T).all(), "vtAAv not symmetric"
    assert (winv == winv.T).all(), "winv not symmetric"
    assert ((winv == 0) | d[:, None] | d[None, :]).all(), \
        "winv support does not match d"
    check = (winv @ np.where(d[None, :], vtAv, 0)) % p
    assert (np.diag(check) == d).all() and \
        (check[~np.eye(len(d), dtype=bool)] == 0).all(), \
        "winv * (vtAv*d) != diag(d)"


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

class BlockLanczosWide(LanczosSolver):
    """Single-device wide-field solver (odd primes 3 <= p < 2^62); the API
    mirrors BlockLanczos.

    device=None runs on CUDA and raises when CUDA is absent; device="cpu"
    runs the plain PyTorch versions of the kernels.
    """

    field = "wide"   # the checkpoint manifest's field
    kernel_dtype = np.uint64
    _launch_counts = staticmethod(launch_counts)
    _invariants = staticmethod(check_invariants)
    _residues = torch.int64
    _empty_outputs = staticmethod(wo.empty_outputs)

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 check_invariants: bool = True,
                 sync_every: int | None = None, device=None):
        self.device = resolve_device(device)
        self.f = GFpWide.make(M.prime)
        self.n = int(n)
        if not 1 <= self.n <= MAX_N:
            raise ValueError(f"block width n must be in [1, {MAX_N}]")
        with profiling.span("layout", field=self.field):
            with profiling.span("layout.build") as build:
                sp = wo.wide_matrix_from_coo(self.f, M)
                first, second = (sp.fwd, sp.bwd) if right else (sp.bwd,
                                                                 sp.fwd)
                build.set(**wo.slab_attrs((first,), (second,)))
            with profiling.span("layout.upload"):
                self.sp = sp.to(self.device)
        self.nnz = M.nnz
        self._setup(right, check_invariants, sync_every, M.nrows, M.ncols,
                    self.sp.fwd, self.sp.bwd,
                    functools.partial(iteration_step, self.f), self.f.p,
                    self.n)

    def _v0_host(self) -> torch.Tensor:
        # random64() % p: all 62 bits kept
        with profiling.span("v0.draw", device="cpu"):
            block = self._rng.fill_mod64(self.n_eff * self.n, self.f.p)
        with profiling.span("v0.pack"):
            v0 = np.zeros((self.np_rows, self.n), np.int64)
            v0[:self.n_eff] = block.reshape(self.n_eff, self.n)
        with profiling.span("v0.upload"):
            return torch.from_numpy(v0).to(self.device)

    def _resume_block(self, resume_state: dict, name: str) -> torch.Tensor:
        arr = resume_rows(resume_state, name, self.np_rows, self.n)
        if arr.size and (arr.min() < 0 or int(arr.max()) >= self.f.p):
            raise ValueError(f"resume block {name!r} holds values outside "
                             f"[0, p)")
        return torch.from_numpy(arr.astype(np.int64)).to(self.device)

    def _banner(self) -> list:
        return ["Block Lanczos [wide field]"]
