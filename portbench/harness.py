"""One run of a cell: set-up, the window of whole solves (or, traced, one
profiled solve), and the reference's judgement of every kernel block (the
left kernel: x^T M == 0).

Set-up makes the matrix on the device from the seed, builds one solver of
the program with the traffic's block width and options, and warms it up
with one `solve(stop_after=WARMUP_ITERATIONS)` from a random start.  The
window then calls `solve()` back to back, each call drawing its own v0 from
the solver's xoshiro stream; a solve still running when `seconds` is up is
finished and counted, so a window holds whole solves only.  Each solve is
capped at CAP_FACTOR times the solver's expected iterations: one that
reaches the cap never converged and counts as failed.  The solver's
on_iteration callback records the benchmark's own perf_counter and the
iteration count at every block sync.

Once the window has closed the device's peak memory is read, the solver
is dropped, and the plain reference (reference/check.py) judges the
kernel block of every solve against the COO the benchmark made.

A traffic's `grid` [R, C] runs the program's mesh solver: in this process
for a 1 x 1 grid, and with one process a card for more ranks (`run_ranks`,
through the program's launcher), rank 0 deciding for all when the window
closes and judging the blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import socket
import time
import traceback

import numpy as np
import torch

from portbench import matrix, trace as trace_mod
from portbench.reference import check

# the numbers compared for each kernel block, each with its limit
LIMITS = {"unfinished": 0, "shape_bad": 0, "zero_columns": 0,
          "xM_nonzero": 0}
WARMUP_ITERATIONS = 64
CAP_FACTOR = 2      # a solve past 2x its expected iterations never converged


@dataclasses.dataclass
class SolveRec:
    t_call: float
    t_return: float | None = None
    blocks: list = dataclasses.field(default_factory=list)  # (t, iteration)
    iterations: int | None = None
    capped: bool = False
    error: str | None = None
    kernel: np.ndarray | None = None

    def loop(self):
        """(seconds, iterations) from the first block's callback to the
        last one's; None with fewer than two blocks."""
        if len(self.blocks) < 2:
            return None
        (t0, i0), (t1, i1) = self.blocks[0], self.blocks[-1]
        return t1 - t0, i1 - i0


@dataclasses.dataclass
class Record:
    config: dict
    traffic: dict
    field: str
    t_start: float
    t_setup_end: float = 0.0
    layout_s: float | None = None
    v0_s: float | None = None
    solves: list = dataclasses.field(default_factory=list)
    trace: trace_mod.Trace | None = None
    nnz: int = 0                  # entries nonzero mod p (GF(2): odd)
    memory_peak_bytes: int | None = None
    busy_us_ranks: list | None = None   # each rank's traced busy time
    judged: list = dataclasses.field(default_factory=list)
    warmup_error: str | None = None


def field_of(prime: int) -> str:
    p = int(prime)
    return "gf2" if p == 2 else "narrow" if p < 1 << 31 else "wide"


def _load_class(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def grid_ranks(traffic: dict) -> int:
    """The ranks the traffic's grid needs: R * C, or 1 without a grid."""
    shape = traffic.get("grid")
    return int(shape[0]) * int(shape[1]) if shape else 1


@contextlib.contextmanager
def _grid(traffic: dict, device):
    """The mesh grid a traffic asks for (`grid`: [R, C]), or None without
    one.  Inside a world that run_ranks started, the grid spans it; else
    a 1 x 1 grid is a world of this one process."""
    shape = traffic.get("grid")
    if not shape:
        yield None
        return
    import torch.distributed as dist

    from block_lanczos_tpu_torch.parallel import mesh, multihost
    R, C = (int(k) for k in shape)
    if dist.is_initialized():
        yield mesh.make_grid(R, C, device)
        return
    if R * C != 1:
        raise ValueError(f"grid {R} x {C}: run_ranks starts its ranks")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    multihost.init_distributed(f"tcp://localhost:{_free_port()}", 1, 0,
                               backend, 300, device)
    try:
        yield mesh.make_grid(R, C, device)
    finally:
        dist.destroy_process_group()


def _rank0_says(flag: bool, grid, device) -> bool:
    """Rank 0's flag, on every rank of the grid's world."""
    if grid is None:
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def build_solver(config: dict, traffic: dict, coo: matrix.Coo, device, grid):
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix
    M = COOMatrix(coo.nrows, coo.ncols, coo.nnz, coo.i, coo.j, coo.x,
                  coo.prime)
    opts = dict(traffic.get("solver_options") or {})
    if grid is not None:
        cls = _load_class(config["mesh_solver"])
        return cls(M, n=int(traffic["n"]), grid=grid, **opts)
    cls = _load_class(config["solver"])
    return cls(M, n=int(traffic["n"]), device=device, **opts)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _checkpointer(traffic: dict, solver, workdir):
    """The program's CheckpointManager when the traffic saves every
    `checkpoint_s` seconds, writing under `workdir`; else None."""
    every = traffic.get("checkpoint_s")
    if not every:
        return None
    from block_lanczos_tpu_torch.utils.checkpoint import CheckpointManager
    return CheckpointManager(str(workdir), interval_s=float(every),
                             solver=solver)


def _warmup_state(rec: Record, traffic: dict, seed: int) -> dict:
    """A random {v, p, iteration} start for the warm-up: the solver's own
    resume path runs the loop's kernels at the cell's shapes without a
    host draw of v0 (seconds of set-up for a wide GF(2) block)."""
    rng = np.random.default_rng([int(seed), 1])
    n, rows = int(traffic["n"]), int(rec.config["nrows"])
    if rec.field == "gf2":
        v = rng.integers(0, 1 << 32, (rows, n // 32),
                         dtype=np.uint64).astype(np.uint32)
    else:
        v = rng.integers(0, int(rec.config["prime"]), (rows, n),
                         dtype=np.uint64)
    return {"v": v, "p": np.zeros_like(v), "iteration": 0}


def _solve(solver, cap: int, mark: bool, ckpt,
           resume_state=None) -> SolveRec:
    """One whole solve through the program's solve() (from
    `resume_state` when given); an exception is recorded (the solve
    failed) and the window goes on.  With `mark`, each block sync also
    puts a marker on the device (trace.mark)."""
    rec = SolveRec(t_call=time.perf_counter())

    def on_block(_solver, iteration, v, p_blk, start):
        rec.blocks.append((time.perf_counter(), iteration))
        if mark:
            trace_mod.mark()
        if ckpt is not None:
            ckpt.maybe_save(iteration, v, p_blk, start)

    try:
        res = solver.solve(stop_after=cap, on_iteration=on_block,
                           resume_state=resume_state)
    except Exception:                 # a failed solve is a result
        rec.t_return = time.perf_counter()
        rec.error = traceback.format_exc(limit=4)
        return rec
    rec.t_return = time.perf_counter()
    rec.iterations = int(res.iterations)
    rec.capped = bool(res.stopped_by_limit)
    rec.kernel = res.kernel
    return rec


def _profiled(solver, cap: int, ckpt, device) -> tuple:
    """One whole solve under a profiler session that records the device's
    activity only (no host operator events, which would slow the host's
    issue), between two device markers."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_mod.mark()
        rec = _solve(solver, cap, True, ckpt)
        trace_mod.mark()
        _sync(device)
    return rec, trace_mod.collect(prof)


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float, workdir=None,
             judge_blocks: bool = True) -> Record:
    """Set-up, the window (or the traced solve) and the judgement."""
    field = field_of(config["prime"])
    rec = Record(config=config, traffic=traffic, field=field,
                 t_start=t_start)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from block_lanczos_tpu_torch import kernels
        kernels.load_all()
    coo = matrix.generate(config, seed, device)
    _sync(device)
    nonzero = (coo.x % 2 == 1) if field == "gf2" else coo.x != 0
    rec.nnz = int(np.count_nonzero(nonzero))
    with _grid(traffic, device) as grid:
        t = time.perf_counter()
        solver = build_solver(config, traffic, coo, device, grid)
        rec.layout_s = time.perf_counter() - t
        cap = CAP_FACTOR * int(solver.expected_iterations)
        ckpt = _checkpointer(traffic, solver, workdir)
        warm = _solve(solver, WARMUP_ITERATIONS, False, None,
                      _warmup_state(rec, traffic, seed))
        rec.warmup_error = warm.error
        _sync(device)
        if traced and hasattr(solver, "initial_block"):
            t = time.perf_counter()
            solver.initial_block()
            _sync(device)
            rec.v0_s = time.perf_counter() - t
        rec.t_setup_end = time.perf_counter()
        if traced:
            one, rec.trace = _profiled(solver, cap, ckpt, device)
            rec.solves.append(one)
        else:
            while True:
                rec.solves.append(_solve(solver, cap, False, ckpt))
                late = rec.solves[-1].t_return - rec.t_setup_end >= seconds
                if _rank0_says(late, grid, device):
                    break
        _sync(device)
        if device.type == "cuda":
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
                device))
        del solver, ckpt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if judge_blocks:
        judge(rec, coo, device=device)
    return rec


def _rank_main(rank, world, device, config, traffic, seed, seconds, traced,
               t_start, workdir):
    """A rank of run_ranks: the cell on this rank's card; rank 0 judges
    and returns the record, the others their peak memory and busy time."""
    rec = run_cell(config, traffic, seed, seconds, traced, device, t_start,
                   None if workdir is None else f"{workdir}/rank{rank}",
                   judge_blocks=rank == 0)
    busy = rec.trace.busy_us() if rec.trace is not None else None
    if rank == 0:
        return rec, rec.memory_peak_bytes, busy
    return None, rec.memory_peak_bytes, busy


def run_ranks(config: dict, traffic: dict, seed: int, seconds: float,
              traced: bool, devices: list, t_start: float,
              workdir=None) -> Record:
    """The cell on a grid of one process a device (the program's
    launcher: NCCL on cards, gloo on the CPU): rank 0's record, with the
    largest peak memory of any rank and each rank's traced busy time."""
    from block_lanczos_tpu_torch.parallel import launch
    backend = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    outs = launch.spawn(_rank_main, devices,
                        (config, traffic, seed, seconds, traced, t_start,
                         None if workdir is None else str(workdir)),
                        backend=backend,
                        init_method=f"tcp://localhost:{_free_port()}")
    rec = outs[0][0]
    peaks = [peak for _, peak, _ in outs if peak is not None]
    rec.memory_peak_bytes = max(peaks) if peaks else None
    if traced:
        rec.busy_us_ranks = [busy for _, _, busy in outs]
    return rec


def judge(rec: Record, coo: matrix.Coo, transform=None,
          device="cpu") -> None:
    """The reference's numbers for every solve of the record, into
    rec.judged; `transform(kernel, k)` (the control) alters each block
    first."""
    e = check.prepare(coo.nrows, coo.ncols, coo.i, coo.j, coo.x, coo.prime,
                      device)
    rec.judged = []
    for k, one in enumerate(rec.solves):
        if one.kernel is None or one.capped:
            rec.judged.append({"unfinished": 1, "shape_bad": 0,
                               "zero_columns": 0, "xM_nonzero": 0})
            continue
        kernel = one.kernel if transform is None else transform(one.kernel,
                                                                k)
        rec.judged.append({"unfinished": 0, **check.judge(e, kernel)})


def checks(rec: Record) -> dict:
    """Each number compared, summed over the judged solves, with its
    limit; a warm-up solve that raised counts as unfinished."""
    out = {name: {"value": sum(j[name] for j in rec.judged),
                  "limit": limit} for name, limit in LIMITS.items()}
    out["unfinished"]["value"] += int(rec.warmup_error is not None)
    return out


def failed(rec: Record) -> int:
    """The solves whose block fails any limit, the warm-up's if it
    raised."""
    return int(rec.warmup_error is not None) + sum(
        any(j[name] > limit for name, limit in LIMITS.items())
        for j in rec.judged)
