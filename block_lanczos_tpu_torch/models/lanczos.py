"""The block Lanczos solver (Thome's "fewer vectors" variant), narrow field,
one device.

Computes a block of kernel vectors of x*M == 0 (mod p) — or M*x == 0 with
right=True — with the JAX package's (and the reference's) semantics bit for
bit (reference: sequential/lanczos_modp.c:585-669):

    v0 <- xoshiro256+ fixed seed (row-major over nrows*n entries)
    loop:  tmp  = Mt*v ; Av = M*tmp            (A = M*Mt implicitly)
           [vtAv ; vtAAv] = [v | Av]^T * Av
           winv, d <- semi_inverse(vtAv);  stop if 0 pivots
           v, p <- orthogonalize recurrence
    final_check: v != 0 and v^T*M == 0

One iteration is five kernel launches on the CUDA device: two `spmv_ell`,
one `gram_mod`, one `semi_inverse` (with the invariant checks and the
update's right-hand side) and one `orthogonalize`, which updates v and p in
place.  The device keeps the latched scalars [stop, inv_ok, k_done, frozen]
(ops/semi_inverse.py), so the host runs up to K iterations per sync, with
K doubling from 1 to 1024 as in the JAX package's blocked_solve_loop: once
a halt is latched, v and p stay frozen (on stop the converged block is the
pre-update v) and the remaining iterations of the block recompute the same
values and change nothing.  Zero padding rows stay zero through every phase.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.ops.dense import gram_mod, matmul_mod
from block_lanczos_tpu_torch.ops.gfp import GFp, barrett_mu, np_matmul_mod
from block_lanczos_tpu_torch.ops.semi_inverse import (FROZEN, INV_OK, K_DONE,
                                                      MAX_N, STOP,
                                                      empty_outputs,
                                                      new_state,
                                                      semi_inverse)
from block_lanczos_tpu_torch.ops.xoshiro import LaneDraw, xoshiro_fill
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix
from block_lanczos_tpu_torch.utils.rng import Xoshiro256Plus


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return dev


def pad_rows(dim: int, multiple: int) -> int:
    return ((dim + multiple - 1) // multiple) * multiple


def fit_rows(arr, rows: int) -> np.ndarray:
    """Adapt a resume-state block's zero-padded row count to this solver's
    padding (all padding rows are zero, so any padding resumes exactly)."""
    arr = np.asarray(arr)
    if arr.shape[0] == rows:
        return arr
    if arr.shape[0] > rows:
        if arr[rows:].any():
            raise ValueError(
                f"checkpoint block has {arr.shape[0]} rows with nonzero data "
                f"beyond this solver's padded size {rows} — wrong matrix or "
                "kernel side?")
        return np.ascontiguousarray(arr[:rows])
    pad = np.zeros((rows - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def state_rows(state: dict, name: str) -> np.ndarray:
    """A checkpoint block in TRUE row order: mesh solvers of the JAX
    package store blocks in a permuted band layout and record the
    padded-position -> true-index map as `rowmap`; un-permute it here."""
    arr = state[name]
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    rm = state.get("rowmap")
    if rm is None:
        return arr
    rm = np.asarray(rm)
    if rm.shape[0] != arr.shape[0]:
        raise ValueError(
            f"checkpoint rowmap covers {rm.shape[0]} rows but block "
            f"{name!r} has {arr.shape[0]}")
    dim = int(rm.max()) + 1
    out = np.zeros((dim,) + arr.shape[1:], arr.dtype)
    sel = rm >= 0
    out[rm[sel]] = arr[sel]
    return out


def resume_rows(state: dict, name: str, rows: int, width: int) -> np.ndarray:
    """A resume-state block in true row order, fitted to `rows` rows, which
    must hold `width` entries a row (the port's form: residues or words; a
    JAX package state goes through convert.FROM_NUMPY first, so that a
    wide field's (rows, n, 2) pairs are refused here, not misread)."""
    arr = np.asarray(fit_rows(state_rows(state, name), rows))
    if arr.shape[1:] != (width,):
        raise ValueError(
            f"resume block {name!r} must be (rows, {width}), got "
            f"{arr.shape}; a JAX package state goes through "
            "convert.FROM_NUMPY[field] first")
    return arr


# ---------------------------------------------------------------------------
# The orthogonalize kernel and its plain version
# ---------------------------------------------------------------------------

# n >= ORTHO_MMA_MIN_N runs on the tensor cores (csrc/orthogonalize.cu)
ORTHO_MMA_MIN_N = 9


def orthogonalize_plain(v, p_blk, Av, rhs, d, p: int, state) -> None:
    """Plain PyTorch version of the orthogonalize kernel (in place, with
    the same halt and k_done/frozen bookkeeping)."""
    n = v.shape[1]
    halt = (state[STOP] != 0) | (state[INV_OK] == 0)
    frozen = state[FROZEN] != 0
    upd = matmul_mod(torch.cat([v, p_blk], dim=1), rhs, p).to(torch.int64)
    dmask = d.to(torch.bool)[None, :]
    v_next = (torch.where(dmask, Av, v).to(torch.int64) + upd[:, :n]) % p
    p_next = (torch.where(dmask, torch.zeros_like(p_blk), p_blk)
              .to(torch.int64) + upd[:, n:]) % p
    v.copy_(torch.where(halt, v, v_next.to(v.dtype)))
    p_blk.copy_(torch.where(halt, p_blk, p_next.to(p_blk.dtype)))
    state[K_DONE] += (~frozen).to(state.dtype)
    state[FROZEN] = (frozen | halt).to(state.dtype)


def orthogonalize(v, p_blk, Av, rhs, d, p: int, state) -> None:
    """v, p <- the Thome recurrence step, IN PLACE, unless the state holds
    a halt (then v and p are left as they are).  Counts the iteration in
    state[k_done] while the state is not frozen and freezes it on a halt.
    CUDA tensors launch the orthogonalize kernel; CPU tensors take
    orthogonalize_plain."""
    N, n = v.shape
    if p_blk.shape != (N, n) or Av.shape != (N, n) \
            or rhs.shape != (2 * n, 2 * n) or d.shape != (n,):
        raise ValueError("orthogonalize: inconsistent block shapes")
    if v.device.type == "cpu":
        return orthogonalize_plain(v, p_blk, Av, rhs, d, p, state)
    if n > MAX_N:
        raise ValueError(f"the orthogonalize kernel supports n <= {MAX_N} "
                         f"(got {n})")
    kernels.check_operands("orthogonalize", v, p_blk, Av, rhs, d, state)
    kernels.launch("orthogonalize", v.data_ptr(), p_blk.data_ptr(),
                   Av.data_ptr(), rhs.data_ptr(), d.data_ptr(), N, n, p,
                   barrett_mu(p), state.data_ptr())
    orthogonalize.launches += 1


orthogonalize.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches} of the five kernel wrappers (xoshiro_fill,
    v0 drawn on the card, once a solve)."""
    return {"spmv_ell": spmm.spmv.launches, "gram_mod": gram_mod.launches,
            "semi_inverse": semi_inverse.launches,
            "orthogonalize": orthogonalize.launches,
            "xoshiro_fill": xoshiro_fill.launches}


def reset_launch_counts() -> None:
    for w in (spmm.spmv, gram_mod, semi_inverse, orthogonalize,
              xoshiro_fill):
        w.launches = 0


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------

def iteration_step(f: GFp, mp_rows: int, np_rows: int, check: bool,
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
    tmp = spmm.spmv(first_op, v, out_rows=mp_rows, out=ws.get("tmp"))
    Av = spmm.spmv(second_op, tmp, out_rows=np_rows, out=ws.get("av"))
    grams = gram_mod(v, Av, Av, f.p, out=ws.get("grams"))
    si = semi_inverse(grams, f.p, state, check, out=ws.get("si"))
    orthogonalize(v, p_blk, Av, si.rhs, si.d, f.p, state)
    ws.update(tmp=tmp, av=Av, grams=grams, si=si)
    return (v, p_blk, tmp, Av, grams[:n], grams[n:], si.winv, si.d,
            state[STOP] != 0, state[INV_OK] != 0)


# ---------------------------------------------------------------------------
# Host-side checks (reference: lanczos_modp.c:532-582)
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_invariants(p: int, vtAv, vtAAv, winv, d):
    """Per-iteration algebraic asserts, on the host (for the message)."""
    vtAv, vtAAv, winv, d = (_np(a).astype(np.uint32)
                            for a in (vtAv, vtAAv, winv, d))
    assert (vtAv == vtAv.T).all(), "vtAv not symmetric"
    assert (vtAAv == vtAAv.T).all(), "vtAAv not symmetric"
    assert (winv == winv.T).all(), "winv not symmetric"
    dd = d.astype(bool)
    support_ok = (winv == 0) | dd[:, None] | dd[None, :]
    assert support_ok.all(), "winv support does not match d"
    vtAvd = np.where(dd[None, :], vtAv, 0).astype(np.uint32)
    check = np_matmul_mod(p, winv, vtAvd)
    assert (np.diag(check) == d).all() and \
        (check[~np.eye(len(d), dtype=bool)] == 0).all(), \
        "winv * (vtAv*d) != diag(d)"


def final_check(v, vtM, n_rows: int, m_rows: int, verbose: bool = True):
    """End-of-run self check (span final.check): v != 0 and v^T*M == 0,
    on tensors or NumPy arrays."""
    with profiling.span("final.check"):
        v_nonzero = bool((v[:n_rows] != 0).any())
        product_zero = bool((vtM[:m_rows] == 0).all())
    if verbose:
        print("Final check:")
        print(f"  - {'OK:    v != 0' if v_nonzero else 'KO:    v == 0'}")
        print(f"  - {'OK: vt*M == 0' if product_zero else 'KO: vt*M != 0'}")
    return v_nonzero, product_zero


# ---------------------------------------------------------------------------
# Solver driver
# ---------------------------------------------------------------------------

_ADAPT_CAP, _ADAPT_TARGET_S = 1024, 0.25
PAD_MULTIPLE = 8  # vector blocks are zero-padded to a multiple of 8 rows


def multi_step(step: Callable[[], object], state: torch.Tensor):
    """blocked_solve_loop's multi_step for a solver: k calls of `step()`
    (one iteration each, on the solver's blocks) issued without a sync
    (span block.issue), then the one sync, reading the latched state
    (block.sync).  Returns multi_step(k) -> (k_done, stop, inv_ok), k_done
    counted from the state's k_done since the previous block."""
    seen = [0]

    def run(k: int):
        with profiling.span("block.issue"):
            for _ in range(k):
                step()
        with profiling.span("block.sync"):
            stop, inv_ok, k_total, _ = state.tolist()
        k_done, seen[0] = k_total - seen[0], k_total
        return k_done, bool(stop), bool(inv_ok)
    return run


def start_blocks(solver, resume_state: dict | None):
    """(v, p, the iteration it starts at) of a solver's solve(): v0 from
    `solver.initial_block()` (span solve.v0) and p zero, or the blocks of
    a resume_state through `solver._resume_block` (solve.resume)."""
    if resume_state is None:
        with profiling.span("solve.v0"):
            v = solver.initial_block()
        return v, torch.zeros_like(v), 0
    with profiling.span("solve.resume"):
        return (solver._resume_block(resume_state, "v"),
                solver._resume_block(resume_state, "p"),
                int(resume_state["iteration"]))


def block_callback(solver, on_iteration, v, p_blk):
    """blocked_solve_loop's on_iteration for solve()'s
    `on_iteration(solver, iteration, v, p_blk, start)`; None without
    one."""
    if on_iteration is None:
        return None
    return lambda iteration, start: on_iteration(solver, iteration, v, p_blk,
                                                 start)


class LoopResult(NamedTuple):
    """What blocked_solve_loop returns: `iterations` as the reference
    counts them; `elapsed` the loop's seconds by perf_counter; `issued`
    the iterations the blocks ran on the device, `done` those that ran
    unhalted (the stopping probe included), `blocks` the host syncs."""
    iterations: int
    stopped_by_limit: bool
    elapsed: float
    issued: int
    done: int
    blocks: int

    def solve_attrs(self, launches_before: dict, launches_after: dict
                    ) -> dict:
        """The `solve` span's attributes: the loop's counts and each
        kernel wrapper's launches over the solve an issued iteration."""
        per = {k: (n - launches_before[k]) / self.issued
               for k, n in launches_after.items()
               if n != launches_before[k]} if self.issued else {}
        return dict(iterations=self.iterations,
                    iterations_issued=self.issued,
                    iterations_done=self.done, blocks=self.blocks,
                    launches_per_iteration=per)


def blocked_solve_loop(multi_step, start_iter: int, stop_after: int,
                       sync_every: int | None, on_iteration=None,
                       inv_fail=None, agree=None) -> LoopResult:
    """The driver loop: blocks of device-side iterations + one host sync.

    multi_step(k) runs k iterations without a sync, then syncs once and
    returns (k_done, stop, inv_ok): the iterations that ran unhalted in this
    block (the stopping probe included) and the latched flags.  Up to
    `sync_every` iterations run per block (adaptive doubling 1 -> 1024,
    targeting ~0.25 s blocks, when None).  On a failed invariant,
    inv_fail(iteration) is called to raise with context.  on_iteration
    fires once per block as on_iteration(n_iterations, start).  agree
    (the mesh solvers) maps a block's seconds to the time every rank
    decides the next block's length by, so that all ranks run blocks of
    the same length.  `start`, given to on_iteration, is the loop's start
    in epoch seconds (the ETA and the checkpoint manifest read it so).
    Records the spans solve.loop and, a block, `block`
    (attributes `issued` and `done`) around block.callback and block.agree,
    and the counters iterations_issued, iterations_done and blocks.
    """
    start = time.time()
    t_start = time.perf_counter()
    n_iterations = start_iter
    stopped_by_limit = False
    block = sync_every or 1
    issued = done = blocks = 0
    with profiling.span("solve.loop"):
        while True:
            remaining = stop_after - n_iterations if stop_after > 0 \
                else block
            if remaining <= 0:
                stopped_by_limit = True
                break
            with profiling.span("block") as blk:
                k = min(block, remaining)
                t_blk = time.perf_counter()
                k_done, stop, inv_ok = multi_step(k)
                issued, done, blocks = issued + k, done + k_done, blocks + 1
                blk.set(issued=k, done=k_done)
                profiling.count("iterations_issued", k)
                profiling.count("iterations_done", k_done)
                profiling.count("blocks")
                if inv_fail is not None and not inv_ok:
                    inv_fail(n_iterations + k_done)
                    raise AssertionError("device invariant check failed")
                # the stopping probe iteration is not counted (the
                # reference breaks before incrementing,
                # sequential/lanczos_modp.c:649-656)
                n_iterations += k_done - (1 if stop else 0)
                if on_iteration is not None:
                    with profiling.span("block.callback"):
                        on_iteration(n_iterations, start)
                if stop:
                    break
                if sync_every is None and block < _ADAPT_CAP:
                    t_blk = time.perf_counter() - t_blk
                    if agree is not None:
                        with profiling.span("block.agree"):
                            t_blk = agree(t_blk)
                    if t_blk < _ADAPT_TARGET_S:
                        block *= 2
    return LoopResult(n_iterations, stopped_by_limit,
                      time.perf_counter() - t_start, issued, done, blocks)


@dataclasses.dataclass
class SolveResult:
    kernel: np.ndarray          # (N_eff, n) uint32 — the block of vectors
    iterations: int
    v_nonzero: bool | None      # final-check outcomes (None if stopped early)
    product_zero: bool | None
    elapsed: float
    stopped_by_limit: bool
    # v^T M (the last tmp), kept ONLY when the final check failed
    vtM: np.ndarray | None = None


class BlockLanczos:
    """Single-device narrow-field solver (p <= 2^30 - 35).

    device=None runs on CUDA and raises when CUDA is absent; device="cpu"
    runs the plain PyTorch versions of the kernels.
    """

    field = "narrow"   # the checkpoint manifest's field

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 check_invariants: bool = True,
                 sync_every: int | None = None, device=None):
        self.device = resolve_device(device)
        self.f = GFp.make(M.prime)
        self.n = int(n)
        if not 1 <= self.n <= MAX_N:
            raise ValueError(f"block width n must be in [1, {MAX_N}]")
        self.right = bool(right)
        self.check_invariants = bool(check_invariants)
        self.sync_every = sync_every
        with profiling.span("layout", field=self.field):
            with profiling.span("layout.build"):
                sp = spmm.SpMatrix.from_coo(self.f, M)
            with profiling.span("layout.upload"):
                self.sp = sp.to(self.device)
        # effective dimensions: the kernel vector lives on N_eff
        self.n_eff = M.ncols if right else M.nrows
        self.m_eff = M.nrows if right else M.ncols
        self.first_op = self.sp.fwd if right else self.sp.bwd
        self.second_op = self.sp.bwd if right else self.sp.fwd
        self.np_rows = pad_rows(self.n_eff, PAD_MULTIPLE)
        self.mp_rows = pad_rows(self.m_eff, PAD_MULTIPLE)
        self.expected_iterations = 1 + self.m_eff // self.n
        self._rng = Xoshiro256Plus()
        self._v0_draw = (LaneDraw(self.n_eff * self.n, self.device)
                         if self.device.type == "cuda" else None)

    def initial_block(self) -> torch.Tensor:
        """v0: xoshiro row-major over n_eff*n entries, zero-padded; drawn
        on the card on CUDA, in NumPy otherwise."""
        if self._v0_draw is not None:
            with profiling.span("v0.draw", device="cuda"):
                return self._v0_draw.block(self._rng, self.field, self.f.p,
                                           (self.np_rows, self.n))
        with profiling.span("v0.draw", device="cpu"):
            block = self._rng.fill_mod(self.n_eff * self.n, self.f.p)
        with profiling.span("v0.pack"):
            v0 = np.zeros((self.np_rows, self.n), np.int32)
            v0[:self.n_eff] = block.reshape(self.n_eff, self.n)
        with profiling.span("v0.upload"):
            return torch.from_numpy(v0).to(self.device)

    def workspace(self) -> dict:
        """The iteration's buffers (iteration_step's `ws`): tmp, and on
        CUDA the kernels' outputs av, grams and si."""
        n, dev = self.n, self.device
        ws = {"tmp": torch.zeros((self.mp_rows, n), dtype=torch.int32,
                                 device=dev)}
        if dev.type == "cuda":
            ws["av"] = torch.empty((self.np_rows, n), dtype=torch.int32,
                                   device=dev)
            ws["grams"] = torch.empty((2 * n, n), dtype=torch.int32,
                                      device=dev)
            ws["si"] = empty_outputs(n, dev)
        return ws

    def _resume_block(self, resume_state: dict, name: str) -> torch.Tensor:
        arr = resume_rows(resume_state, name, self.np_rows, self.n)
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    def solve(self, stop_after: int = -1, verbose: bool = False,
              on_iteration: Callable | None = None,
              resume_state: dict | None = None) -> SolveResult:
        """Run to convergence (or `stop_after` iterations).

        `on_iteration(solver, iteration, v, p_blk, start)` fires once per
        block of device-side iterations (adaptive, up to 1024 per block
        under the default sync_every=None); construct with sync_every=1
        for per-iteration callbacks.  `resume_state` is a {v, p, iteration}
        dict (NumPy or tensors, optionally with `rowmap`), e.g. from
        convert.state_from_numpy.
        """
        with profiling.span("solve", field=self.field) as sp:
            # the wrappers' launch counters, read only while recording
            launches = None if sp is profiling.NOOP else launch_counts()
            v, p_blk, start_iter = start_blocks(self, resume_state)
            if verbose:
                print("Block Lanczos")
                print(f"  - Expecting {self.expected_iterations} iterations")
                print("  - Main loop")
            with profiling.span("solve.prepare"):
                if self.device.type == "cuda":
                    kernels.load_all()
                state = new_state(self.device)
                ws = self.workspace()
            f = self.f

            def inv_fail(iteration):
                # reproduce the precise failing assertion on the host
                n = self.n
                grams, si = ws["grams"], ws["si"]
                check_invariants(f.p, grams[:n], grams[n:], si.winv, si.d)

            loop = blocked_solve_loop(
                multi_step(functools.partial(
                    iteration_step, f, self.mp_rows, self.np_rows,
                    self.check_invariants, self.first_op, self.second_op, v,
                    p_blk, state, ws), state),
                start_iter, stop_after, self.sync_every,
                on_iteration=block_callback(self, on_iteration, v, p_blk),
                inv_fail=inv_fail if self.check_invariants else None)
            if launches is not None:
                sp.set(**loop.solve_attrs(launches, launch_counts()))
            tmp = ws["tmp"]
            v_nonzero = product_zero = None
            vtM = None
            with profiling.span("solve.final"):
                if not loop.stopped_by_limit:
                    v_nonzero, product_zero = final_check(
                        v, tmp, self.n_eff, self.m_eff, verbose)
                with profiling.span("final.download"):
                    if product_zero is False:
                        vtM = tmp[:self.m_eff].cpu().numpy().astype(
                            np.uint32)
                    kernel = v[:self.n_eff].cpu().numpy().astype(np.uint32)
        if verbose:
            print(f"  - Terminated in {loop.elapsed:.1f}s after "
                  f"{loop.iterations} iterations")
        return SolveResult(kernel=kernel, iterations=loop.iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=loop.elapsed,
                           stopped_by_limit=loop.stopped_by_limit, vtM=vtM)
