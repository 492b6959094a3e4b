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


class LanczosSolver:
    """The solve protocol of the port's six solvers, written once: solve()
    runs v0 (or a resume), the blocked host loop and the final step under
    their spans, on one device or on every rank of a mesh.

    A solver sets `field` (the checkpoint manifest's), `device`, `n`,
    `sync_every`, `check_invariants`, `expected_iterations` and
    `_launch_counts` (its kernel wrappers' counter, read while recording),
    and writes the hooks `_banner()` (the verbose header's first lines) and
    `_resume_block`.  The base's other hooks serve the one-device prime
    fields, and a solver overrides those that do not fit it:
      - `_setup`, the constructors' tail;
      - `_workspace()`, the iteration's buffers (ws) in `_residues`;
      - `initial_block()`, drawn on the card on CUDA and by the field's
        `_v0_host` elsewhere;
      - `_stepper(v, p_blk, state, ws)`, the callable multi_step runs for
        one iteration: a flat partial of the field's iteration_step, so
        that the loop adds no frame of its own;
      - `_invariant_failure(ws, iteration)`, which raises with the failed
        check: the field's `_invariants` on the Grams;
      - `_final(v, tmp, ws, verbose)`, the final step (tmp None when the
        limit stopped the loop).
    The mesh's base (parallel/distributed.py::_ShardedSolver) overrides
    all but `_invariant_failure` and sets `_agree`."""

    kernel_dtype = np.uint32    # the prime fields' kernel block and vtM
    _agree = None               # the mesh: the block time all ranks take
    _invariants = staticmethod(check_invariants)    # the field's asserts
    _residues = torch.int32                         # the blocks' dtype
    _empty_outputs = staticmethod(empty_outputs)    # semi_inverse's

    def _setup(self, right: bool, check_invariants: bool,
               sync_every: int | None, nrows: int, ncols: int, fwd, bwd,
               iteration, v0_modulus: int, v0_cols: int):
        """The one-device constructors' tail, after the layout of an
        nrows x ncols operator whose directions are fwd (M) and bwd (Mt):
        the kernel side's dimensions (n_eff the kernel vector's), the two
        ops in the iteration's order, the blocks' padded rows, the field's
        iteration_step with its first argument bound (`iteration`), and
        v0's generator with, on CUDA, its draw on the card (blocks of
        v0_cols values a row, drawn mod v0_modulus)."""
        self.right = bool(right)
        self.check_invariants = bool(check_invariants)
        self.sync_every = sync_every
        self.n_eff, self.m_eff = (ncols, nrows) if right else (nrows, ncols)
        self.first_op, self.second_op = (fwd, bwd) if right else (bwd, fwd)
        self.np_rows = pad_rows(self.n_eff, PAD_MULTIPLE)
        self.mp_rows = pad_rows(self.m_eff, PAD_MULTIPLE)
        self.expected_iterations = 1 + self.m_eff // self.n
        self._iteration = iteration
        self._rng = Xoshiro256Plus()
        self._v0_form = (v0_modulus, (self.np_rows, v0_cols))
        self._v0_draw = (LaneDraw(self.n_eff * self.n, self.device)
                         if self.device.type == "cuda" else None)

    def initial_block(self) -> torch.Tensor:
        """v0: the xoshiro256+ stream from its fixed seed, row-major over
        n_eff * n entries (mod p; over GF(2) its bits, packed), zero-padded;
        drawn on the card on CUDA, by the field's `_v0_host` otherwise."""
        if self._v0_draw is None:
            return self._v0_host()
        with profiling.span("v0.draw", device="cuda"):
            return self._v0_draw.block(self._rng, self.field, *self._v0_form)

    def _workspace(self) -> dict:
        """The iteration's buffers (iteration_step's `ws`): tmp, and on
        CUDA the kernels' outputs av, grams and si."""
        n, dev, dtype = self.n, self.device, self._residues
        ws = {"tmp": torch.zeros((self.mp_rows, n), dtype=dtype, device=dev)}
        if dev.type == "cuda":
            ws["av"] = torch.empty((self.np_rows, n), dtype=dtype, device=dev)
            ws["grams"] = torch.empty((2 * n, n), dtype=dtype, device=dev)
            ws["si"] = self._empty_outputs(n, dev)
        return ws

    def _stepper(self, v, p_blk, state, ws):
        """One iteration on the solve's blocks: one partial of the field's
        iteration_step (partials of a partial flatten), read at each solve
        so that the ops set on the solver are the ones it runs."""
        return functools.partial(
            self._iteration, self.mp_rows, self.np_rows,
            self.check_invariants, self.first_op, self.second_op, v, p_blk,
            state, ws)

    def _invariant_failure(self, ws, iteration):
        # reproduce the precise failing assertion on the host
        n, grams, si = self.n, ws["grams"], ws["si"]
        self._invariants(self.f.p, grams[:n], grams[n:], si.winv, si.d)

    def _final(self, v, tmp, ws, verbose):
        """The prime fields' final step on one device: (kernel, v_nonzero,
        product_zero, vtM), final_check on the blocks (none without tmp),
        the kernel block and, on a failed check, vtM downloaded as
        kernel_dtype."""
        v_nonzero = product_zero = vtM = None
        if tmp is not None:
            v_nonzero, product_zero = final_check(v, tmp, self.n_eff,
                                                  self.m_eff, verbose)
        with profiling.span("final.download"):
            if product_zero is False:
                vtM = tmp[:self.m_eff].cpu().numpy().astype(self.kernel_dtype)
            kernel = v[:self.n_eff].cpu().numpy().astype(self.kernel_dtype)
        return kernel, v_nonzero, product_zero, vtM

    def solve(self, stop_after: int = -1, verbose: bool = False,
              on_iteration: Callable | None = None,
              resume_state: dict | None = None) -> SolveResult:
        """Run to convergence (or `stop_after` iterations); on a mesh, on
        every rank of the grid together.

        `on_iteration(solver, iteration, v, p_blk, start)` fires once per
        block of device-side iterations (adaptive, up to 1024 per block
        under the default sync_every=None); construct with sync_every=1
        for per-iteration callbacks.  On a mesh v and p_blk are this rank's
        bands (`gather_rows` gives them whole; every rank must then call
        it).  `resume_state` is a {v, p, iteration} dict in true row order
        (NumPy or tensors, optionally with `rowmap`) of residues (int64 in
        the wide field) or GF(2) words (uint32 or int32), e.g. from
        convert.state_from_numpy.  The result's `kernel` and `vtM` are
        uint64 in the wide field.
        """
        with profiling.span("solve", field=self.field) as sp:
            # the wrappers' launch counters, read only while recording
            launches = None if sp is profiling.NOOP else self._launch_counts()
            if resume_state is None:
                with profiling.span("solve.v0"):
                    v = self.initial_block()
                p_blk, start_iter = torch.zeros_like(v), 0
            else:
                with profiling.span("solve.resume"):
                    v, p_blk = (self._resume_block(resume_state, name)
                                for name in ("v", "p"))
                    start_iter = int(resume_state["iteration"])
            if verbose:
                for line in self._banner():
                    print(line)
                print(f"  - Expecting {self.expected_iterations} iterations")
                print("  - Main loop")
            with profiling.span("solve.prepare"):
                if self.device.type == "cuda":
                    kernels.load_all()
                state = new_state(self.device)
                ws = self._workspace()
            loop = blocked_solve_loop(
                multi_step(self._stepper(v, p_blk, state, ws), state),
                start_iter, stop_after, self.sync_every,
                on_iteration=None if on_iteration is None else (
                    lambda iteration, start: on_iteration(
                        self, iteration, v, p_blk, start)),
                inv_fail=(functools.partial(self._invariant_failure, ws)
                          if self.check_invariants else None),
                agree=self._agree)
            if launches is not None:
                sp.set(**loop.solve_attrs(launches, self._launch_counts()))
            with profiling.span("solve.final"):
                kernel, v_nonzero, product_zero, vtM = self._final(
                    v, None if loop.stopped_by_limit else ws["tmp"], ws,
                    verbose)
        if verbose:
            print(f"  - Terminated in {loop.elapsed:.1f}s after "
                  f"{loop.iterations} iterations")
        return SolveResult(kernel=kernel, iterations=loop.iterations,
                           v_nonzero=v_nonzero, product_zero=product_zero,
                           elapsed=loop.elapsed,
                           stopped_by_limit=loop.stopped_by_limit, vtM=vtM)


class BlockLanczos(LanczosSolver):
    """Single-device narrow-field solver (p <= 2^30 - 35).

    device=None runs on CUDA and raises when CUDA is absent; device="cpu"
    runs the plain PyTorch versions of the kernels.
    """

    field = "narrow"   # the checkpoint manifest's field
    _launch_counts = staticmethod(launch_counts)

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 check_invariants: bool = True,
                 sync_every: int | None = None, device=None):
        self.device = resolve_device(device)
        self.f = GFp.make(M.prime)
        self.n = int(n)
        if not 1 <= self.n <= MAX_N:
            raise ValueError(f"block width n must be in [1, {MAX_N}]")
        with profiling.span("layout", field=self.field):
            with profiling.span("layout.build"):
                sp = spmm.SpMatrix.from_coo(self.f, M)
            with profiling.span("layout.upload"):
                self.sp = sp.to(self.device)
        self._setup(right, check_invariants, sync_every, M.nrows, M.ncols,
                    self.sp.fwd, self.sp.bwd,
                    functools.partial(iteration_step, self.f), self.f.p,
                    self.n)

    def _v0_host(self) -> torch.Tensor:
        with profiling.span("v0.draw", device="cpu"):
            block = self._rng.fill_mod(self.n_eff * self.n, self.f.p)
        with profiling.span("v0.pack"):
            v0 = np.zeros((self.np_rows, self.n), np.int32)
            v0[:self.n_eff] = block.reshape(self.n_eff, self.n)
        with profiling.span("v0.upload"):
            return torch.from_numpy(v0).to(self.device)

    def _resume_block(self, resume_state: dict, name: str) -> torch.Tensor:
        arr = resume_rows(resume_state, name, self.np_rows, self.n)
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    def _banner(self) -> list:
        return ["Block Lanczos"]
