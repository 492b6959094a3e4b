"""Profiling helpers of the port (the JAX package's utils/profiling.py on
PyTorch), for the narrow-field `models.lanczos.BlockLanczos`:

  * `trace(path)`: a context manager around torch.profiler (the CPU and,
    where CUDA is available, the card's kernels) that writes a Chrome
    trace, `path/trace.json`, viewable in Perfetto or chrome://tracing;
  * `phase_timers(solver)`: each phase of an iteration (the two SpMVs,
    the Gram, the semi-inverse, the update) timed alone, the device
    synchronised at both ends, with its share and nnz/s;
  * `ablation_timers(solver)`: the whole iteration timed, then again with
    one phase at a time replaced by a cheap stand-in of its shape; a
    phase's cost in context is the difference.

They run on whatever device the solver is on (CPU times are the plain
PyTorch versions', not the card's).  Both timers draw v0 from the
solver's xoshiro stream, as the JAX module's do, so a later solve() of
the same solver starts from the next block.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from block_lanczos_tpu_torch.models import lanczos as L
from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.ops.dense import gram_mod
from block_lanczos_tpu_torch.ops.semi_inverse import new_state, semi_inverse

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(path: str):
    """Profile the block and write its Chrome trace to path/trace.json;
    yields the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


def _sync(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _timed(fn, sync, iters: int):
    """(seconds a call, the last call's result), after a warm call."""
    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / iters, out


def phase_timers(solver, iters: int = 5) -> dict:
    """Per-phase seconds of a BlockLanczos solver's iteration, each phase
    run `iters` times alone between two device syncs: spmv_first_s,
    spmv_second_s, gram_s, semi_inverse_s, orthogonalize_s, total_s,
    spmv_share and spmv_nnz_per_s.  Useful for relative comparisons; the
    loop's own pace is ablation_timers'."""
    p, n = solver.f.p, solver.n
    v = solver.initial_block()
    sync, ws = _sync(v.device), solver.workspace()
    t_spmv1, tmp = _timed(lambda: spmm.spmv(
        solver.first_op, v, out_rows=solver.mp_rows, out=ws["tmp"]),
        sync, iters)
    t_spmv2, av = _timed(lambda: spmm.spmv(
        solver.second_op, tmp, out_rows=solver.np_rows, out=ws.get("av")),
        sync, iters)
    t_gram, grams = _timed(lambda: gram_mod(v, av, av, p,
                                            out=ws.get("grams")),
                           sync, iters)
    state = new_state(v.device)
    t_semi, si = _timed(lambda: semi_inverse(
        grams, p, state, solver.check_invariants, out=ws.get("si")),
        sync, iters)
    v2, p2 = v.clone(), torch.zeros_like(v)     # updated in place
    t_orth, _ = _timed(lambda: L.orthogonalize(v2, p2, av, si.rhs, si.d, p,
                                               state), sync, iters)
    total = t_spmv1 + t_spmv2 + t_gram + t_semi + t_orth
    report = {"spmv_first_s": t_spmv1, "spmv_second_s": t_spmv2,
              "gram_s": t_gram, "semi_inverse_s": t_semi,
              "orthogonalize_s": t_orth, "total_s": total,
              "spmv_share": (t_spmv1 + t_spmv2) / total}
    nnz = solver.sp.nnz
    if nnz:
        report["spmv_nnz_per_s"] = 2 * nnz / (t_spmv1 + t_spmv2)
    return report


PHASES = ("spmv1", "spmv2", "gram", "semi", "orth")


def _iteration(solver, disabled, v, p_blk, state, ws) -> None:
    """One iteration of the solve on ws's buffers (the invariant checks
    off), with the phase `disabled` (one of PHASES, or None) replaced by a
    cheap stand-in of its shape, as the JAX module's ablation loop does."""
    p, n = solver.f.p, solver.n
    if disabled == "spmv1":     # v's rows, zero-padded, as tmp
        tmp = ws["tmp"]
        r = min(solver.mp_rows, solver.np_rows)
        tmp.zero_()
        tmp[:r] = v[:r]
    else:
        tmp = spmm.spmv(solver.first_op, v, out_rows=solver.mp_rows,
                        out=ws["tmp"])
    if disabled == "spmv2":     # tmp's rows as Av
        av = torch.zeros_like(v)
        r = min(solver.mp_rows, solver.np_rows)
        av[:r] = tmp[:r]
    else:
        av = spmm.spmv(solver.second_op, tmp, out_rows=solver.np_rows,
                       out=ws.get("av"))
    if disabled == "gram":      # vtAv = vtAAv = v[:n] + Av[:n]
        u = ((v[:n].to(torch.int64) + av[:n]) % p).to(torch.int32)
        grams = torch.cat([u, u])
    else:
        grams = gram_mod(v, av, av, p, out=ws.get("grams"))
    if disabled == "semi":      # winv = vtAv, d all ones
        rhs = torch.zeros((2 * n, 2 * n), dtype=torch.int32, device=v.device)
        rhs[:n, n:] = grams[:n]
        d = torch.ones(n, dtype=torch.int32, device=v.device)
    else:
        si = semi_inverse(grams, p, state, False, out=ws.get("si"))
        rhs, d = si.rhs, si.d
    if disabled == "orth":      # v <- Av + v, p <- p + v
        p_blk.copy_((p_blk.to(torch.int64) + v) % p)
        v.copy_((av.to(torch.int64) + v) % p)
    else:
        L.orthogonalize(v, p_blk, av, rhs, d, p, state)


def ablation_timers(solver, iters: int = 50, runs: int = 2) -> dict:
    """In-loop phase attribution for a BlockLanczos solver: `iters`
    iterations timed whole (the best of `runs`, each from the same v0),
    then with each phase of PHASES replaced by its stand-in; reports
    full_iteration_s and, for each phase, <phase>_s = the difference
    (clamped at 0), with spmv_nnz_per_s and iteration_nnz_per_s."""
    v0 = solver.initial_block()
    sync, ws = _sync(v0.device), solver.workspace()

    def timed_loop(disabled):
        best = float("inf")
        for k in range(max(runs, 1) + 1):      # the first run warms up
            v, p_blk = v0.clone(), torch.zeros_like(v0)
            state = new_state(v0.device)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                _iteration(solver, disabled, v, p_blk, state, ws)
            sync()
            if k:
                best = min(best, (time.perf_counter() - t0) / iters)
        return best

    full = timed_loop(None)
    report = {"full_iteration_s": full}
    for phase in PHASES:
        report[f"{phase}_s"] = max(full - timed_loop(phase), 0.0)
    nnz = solver.sp.nnz
    if nnz:
        report["spmv_nnz_per_s"] = 2 * nnz / max(
            report["spmv1_s"] + report["spmv2_s"], 1e-12)
        report["iteration_nnz_per_s"] = 2 * nnz / full
    return report
