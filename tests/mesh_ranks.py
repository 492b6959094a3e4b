"""Rank functions for the mesh tests (tests/test_torch_mesh_*.py).

parallel/launch.py spawns fresh interpreters, which import these by name:
they live outside the test files so that a rank imports torch and the port
only, never JAX.  Each returns its results from rank 0 (None elsewhere).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
from block_lanczos_tpu_torch.parallel import collectives as C
from block_lanczos_tpu_torch.parallel import distributed as D
from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
    ShardedBlockLanczosGF2
from block_lanczos_tpu_torch.parallel.distributed_wide import \
    ShardedBlockLanczosWide
from block_lanczos_tpu_torch.parallel.mesh import make_grid
from block_lanczos_tpu_torch.utils import mmio

SOLVERS = {"narrow": D.ShardedBlockLanczos, "gf2": ShardedBlockLanczosGF2,
           "wide": ShardedBlockLanczosWide}


def collectives_job(rank, world, device, cases):
    """cases: (kind, R, p, partials) with partials (R, ...) NumPy; the first
    R ranks sum their partial over a group of R ranks by the solvers' bound
    form of psum_mod / psum_mod_wide / pxor (kind "mod", "wide", "xor":
    C.PsumMod / C.PsumModWide / C.Pxor), once by a fresh object and again
    by one object called twice on one tensor.  Returns every case's results
    as rank 0 holds them, and as rank R - 1 holds them: [the first call's,
    the second object's] a case."""
    sizes = sorted({R for _, R, _, _ in cases})
    groups = {R: (dist.group.WORLD if R == world
                  else dist.new_group(list(range(R)))) for R in sizes}
    out = []
    for kind, R, p, parts in cases:
        if rank >= R:
            out.append(None)
            continue
        if kind == "mod":
            def make(t):
                return C.PsumMod(t, p, groups[R])
        elif kind == "wide":
            def make(t):
                return C.PsumModWide(t, GFpWide.make(p), groups[R])
        else:
            def make(t):
                return C.Pxor(t, groups[R])
        x = torch.from_numpy(parts[rank].copy())
        make(x)(x)
        y = torch.from_numpy(parts[rank].copy())
        bound = make(y)
        for _ in range(2):          # the same object, a fresh partial
            y.copy_(torch.from_numpy(parts[rank]))
            bound(y)
        out.append([x.numpy(), y.numpy()])
    # rank 0 collects the last member's copies, to show every rank agrees
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank != 0:
        return None
    last = [gathered[R - 1][k] for k, (_, R, _, _) in enumerate(cases)]
    return out, last


def _matrix(task):
    m = task["matrix"]
    if isinstance(m, str):
        return mmio.load_mtx(m, task["prime"])
    nrows, ncols, i, j, x = m
    return mmio.COOMatrix(nrows, ncols, len(i), i, j, x, task["prime"])


def _skew_grams(real):
    def skewed(V1, V2, W, p, out=None):
        g = real(V1, V2, W, p, out)
        g[-1, 0] = (g[-1, 0] + 1) % p      # vtAAv no longer symmetric
        return g
    return skewed


@contextlib.contextmanager
def _bound_forms_only(calls):
    """Within the block each call of a bound form (C.PsumMod, PsumModWide,
    Pxor; whole, or started for the overlap step to finish later) adds one
    to calls[its class name], and a summing torch.distributed.all_reduce
    raises unless a bound form's `start` made it (the loop's agreement on
    its clock, a MAX, passes)."""
    real_start, real_all_reduce = C._BoundSum.start, dist.all_reduce
    inside = []

    def counted(self, x):
        calls[type(self).__name__] = calls.get(type(self).__name__, 0) + 1
        inside.append(self)
        try:
            return real_start(self, x)
        finally:
            inside.pop()

    def all_reduce(tensor, op=dist.ReduceOp.SUM, **kwargs):
        if op == dist.ReduceOp.SUM and not inside:
            raise RuntimeError("the step summed outside a bound form")
        return real_all_reduce(tensor, op=op, **kwargs)
    C._BoundSum.start = counted
    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        C._BoundSum.start = real_start
        dist.all_reduce = real_all_reduce


def _rounds(tasks):
    """Consecutive tasks on disjoint ranks run side by side: a round."""
    rounds, used = [], set()
    for k, task in enumerate(tasks):
        ranks = set(_ranks(task))
        if not rounds or used & ranks:
            rounds.append([])
            used = set()
        rounds[-1].append(k)
        used |= ranks
    return rounds


def _ranks(task):
    R, C_ = task["grid"]
    return list(task.get("ranks", range(R * C_)))


def _run(task, grid):
    try:
        solver = SOLVERS[task["field"]](
            _matrix(task), n=task["n"], right=task.get("right", False),
            grid=grid, pad_multiple=task.get("pad_multiple", 8),
            check_invariants=task.get("check", True),
            sync_every=task.get("sync_every"),
            overlap=task.get("overlap", False))
    except ValueError as e:     # the same on every rank: no collective ran
        return _errors(str(e), grid)
    iterates = []

    def capture(slv, iteration, v, p_blk, start):
        iterates.append((iteration, slv.gather_rows(v),
                         slv.gather_rows(p_blk)))

    real = D.gram_mod
    if task.get("skew_gram"):
        D.gram_mod = _skew_grams(real)
    calls = {}
    try:
        with (_bound_forms_only(calls) if task.get("count_bound")
              else contextlib.nullcontext()):
            res = solver.solve(
                stop_after=task.get("stop_after", -1),
                on_iteration=capture if task.get("capture") else None,
                resume_state=task.get("resume"))
        out = dict(kernel=res.kernel, iterations=res.iterations,
                   bound_calls=calls,
                   v_nonzero=res.v_nonzero, product_zero=res.product_zero,
                   stopped_by_limit=res.stopped_by_limit, iterates=iterates,
                   row_identity=solver.row_map.identity,
                   col_identity=solver.col_map.identity)
    except AssertionError as e:
        out = dict(error=str(e))
    finally:
        D.gram_mod = real
    if "error" in out:
        out = _errors(out["error"], grid)
    return out


def _errors(message, grid):
    """A failed solve's result: every member's message, at the root."""
    errors = [None] * grid.size
    dist.all_gather_object(errors, message, group=grid.group)
    return dict(error=message, errors=errors)


def solve_job(rank, world, device, tasks):
    """Each task (a dict) on its own grid: grid (R, C) over `ranks`
    (default the first R * C), field, matrix (a path or (nrows, ncols, i,
    j, x)), prime, n, and optionally right, pad_multiple, stop_after,
    sync_every, resume, check, overlap, capture (the whole (v, p) in true
    order after every block), skew_gram (a narrow Gram made non-symmetric
    on every rank: the invariant check must fail on all of them),
    count_bound (the module
    collectives refused during the solve, the bound forms' calls counted
    in the result's bound_calls).  Consecutive tasks on
    disjoint ranks run side by side.  Returns the tasks' result dicts at
    rank 0; a failed solve's dict (an AssertionError in the solve, a
    ValueError in the solver's constructor) holds every member rank's
    message."""
    mine = {}
    for round_ in _rounds(tasks):
        grids = [make_grid(*tasks[k]["grid"], device, ranks=_ranks(tasks[k]))
                 for k in round_]
        for k, grid in zip(round_, grids):
            if grid is not None:
                out = _run(tasks[k], grid)
                if grid.is_root:
                    mine[k] = out
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    merged = {k: v for d in every for k, v in d.items()}
    return [merged[k] for k in range(len(tasks))]


def raising_job(rank, world, device):
    """Rank 1 raises (fault 6: spawn must raise RankFailed)."""
    if rank == 1:
        raise ValueError("rank 1 raised on purpose")
    return rank


def exiting_job(rank, world, device):
    """Rank 1 exits with code 3, as the CLI's rank does on a failed solve."""
    if rank == 1:
        raise SystemExit(3)
    return rank


def sleeping_job(rank, world, device):
    """Every rank outlives any test's wall limit."""
    import time
    time.sleep(600)


def cli_job(rank, world, device, cases):
    """cases: (argv, (R, C)) or (argv, (R, C), ranks); each runs the CLI's
    solve as one rank of an R x C grid over `ranks` (default the whole
    world; they must include rank 0, which writes the kernel file).
    Returns every case's exit code at rank 0."""
    from block_lanczos_tpu_torch.utils import cli
    rcs = []
    for argv, (R, C_), *ranks in cases:
        args = cli.build_parser().parse_args(argv)
        grid = make_grid(R, C_, device, ranks=ranks[0] if ranks else None)
        rcs.append(None if grid is None else cli._solve(args, grid))
    return rcs if rank == 0 else None


def sequence_job(rank, world, device, jobs):
    """jobs: (the name of a job function of this module, its arguments),
    run one after another in this world; returns their results at rank
    0."""
    out = [globals()[name](rank, world, device, *args) for name, args in jobs]
    return out if rank == 0 else None


def checkpoint_job(rank, world, device, tasks):
    """Each task (a dict) on a grid over the whole world: grid (R, C),
    field, matrix, prime, n, stop_after, and optionally
      resume: a checkpoint directory the solve resumes from (through
        convert.FROM_NUMPY, as the CLI does);
      save: {dir, interval (s, default 0), request: (iteration, who)}: a
        CheckpointManager bound to the solver, at every rank's callback
        (sync_every 1); at that iteration the root (who "root") or every
        other rank (who "other") calls request_save(SIGTERM).
    Returns, at rank 0, each task's kernel, iterations, whether its row
    map is the identity, and every rank's (saves' iterations, the signal
    its manager ends with); and every rank's (multihost.is_root(),
    multihost.process_count())."""
    import signal

    from block_lanczos_tpu_torch import convert
    from block_lanczos_tpu_torch.parallel import multihost
    from block_lanczos_tpu_torch.utils import checkpoint as ckpt
    out = []
    world_view = [None] * world
    dist.all_gather_object(world_view, (multihost.is_root(),
                                        multihost.process_count()))
    for task in tasks:
        grid = make_grid(*task["grid"], device)
        field = task["field"]
        solver = SOLVERS[field](_matrix(task), n=task["n"], grid=grid,
                                sync_every=1)
        resume = None
        if "resume" in task:
            resume = convert.FROM_NUMPY[field](
                ckpt.load_checkpoint(task["resume"]), "cpu")
        saves, mgr, on_iteration = [], None, None
        if "save" in task:
            sv = task["save"]
            mgr = ckpt.CheckpointManager(
                sv["dir"], interval_s=sv.get("interval", 0.0),
                meta={"field": field}, solver=solver)
            at, who = sv.get("request", (None, None))
            me = "root" if grid.is_root else "other"

            def on_iteration(slv, iteration, v, p_blk, start):
                if iteration == at and who == me:
                    mgr.request_save(signal.SIGTERM)
                if mgr.maybe_save(iteration, v, p_blk, start):
                    saves.append(iteration)
        res = solver.solve(stop_after=task.get("stop_after", -1),
                           on_iteration=on_iteration, resume_state=resume)
        every = [None] * grid.size
        dist.all_gather_object(
            every, (saves, None if mgr is None else mgr.signum),
            group=grid.group)
        if grid.is_root:
            out.append(dict(kernel=res.kernel, iterations=res.iterations,
                            row_identity=solver.row_map.identity,
                            ranks=every))
    multihost.barrier()
    return (out, world_view) if rank == 0 else None

