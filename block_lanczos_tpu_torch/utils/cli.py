"""Solver command-line interface of the port: the narrow field, the wide
field and bitsliced GF(2), on one device or on a mesh of ranks.

Flag-compatible with the JAX package's CLI for the part this port covers
(reference: sequential/lanczos_modp.c:124-194):

    lanczos-modp-torch --matrix M.mtx --prime 65537 --n 4
                       [--output-file K.mtx] [--right | --left]
                       [--stop-after N] [--no-checks] [--sync-every K]
                       [--salvage [--salvage-restarts K]] [--no-dedup]
                       [--checkpoint [SECONDS]] [--load-checkpoint]
                       [--checkpoint-dir DIR]
                       [--device cuda|cpu] [--single]
                       [--devices K | --grid R C] [--overlap]
                       [--coordinator HOST:PORT --num-processes P
                        --process-id I [--local-devices L]]

p = 2 with n % 32 == 0 selects the bitsliced GF(2) solver, 2^30 - 35 < p <
2^62 the wide field (as in the JAX package's CLI; p >= 2^62 exits 1), every
other p the narrow field.  Runs on the CUDA device by default and exits
with an error when there is none; `--device cpu` runs the plain PyTorch
versions of the kernels.

Without `--devices`, `--grid` or `--coordinator` the solve runs on one
device (`--single` keeps it there).  `--devices K` solves on a (K, 1)
grid of ranks and `--grid R C` on R x C ranks (parallel/): this process
spawns them (parallel/launch.py), rank r on cuda:r over NCCL with
`--device cuda` (K above this host's CUDA device count exits 2 before the
matrix is loaded: one card a rank), or on the CPU over gloo with
`--device cpu`.  Several hosts: each runs this command with the same
`--coordinator HOST:PORT` (or a file:// rendezvous), `--num-processes P`
and its `--process-id I`, and spawns `--local-devices L` ranks (default
1), global ranks I*L .. I*L+L-1 of P*L; the grid is `--grid` or `--devices`
(which must then count P*L ranks) or (P*L, 1).  Rank 0 alone prints and
writes the kernel file.  `--num-processes 1 --process-id 0` alone is the
one-device solve.  `--overlap` splits each SpMV into two row chunks so
that one chunk's exact all-reduce runs while the other's product is
computed (the mesh solvers' overlap=True); alone, it runs the mesh over
every CUDA device of this host (one gloo rank with `--device cpu`), as
the JAX CLI runs it over every device; `--single` ignores it.

Checkpoints are the JAX package's CLI's (utils/checkpoint.py, in its
on-disk form, so that either package resumes the other's): `--checkpoint
[SECONDS]` saves {v, p, iteration} every SECONDS (default 60) to
`--checkpoint-dir`, `--load-checkpoint` resumes from it (validated against
this run's prime, n, side, field, matrix shape and m_eff; exit 1 on a
mismatch).  With `--checkpoint`, SIGTERM or SIGINT requests a save at the
next iteration callback, after which the run exits 128 + signum; a second
signal takes the default action.  On a mesh the signal to this process is
passed on to its ranks (they poll a shared value), the root's request is
the one every rank follows, and each rank exits 128 + signum.

Exit code 2, before the matrix is loaded, for mesh flags that cannot
run and for block widths above the kernels' caps, n <= 64 in the narrow
and the wide field and, on CUDA, n <= 512 over GF(2).
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading

from block_lanczos_tpu_torch import convert
from block_lanczos_tpu_torch.ops import gf2
from block_lanczos_tpu_torch.ops import semi_inverse as narrow
from block_lanczos_tpu_torch.ops import wide_ops as wide
from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP
from block_lanczos_tpu_torch.ops.gfp_wide import WIDE_PRIME_CAP
from block_lanczos_tpu_torch.utils import checkpoint as ckpt
from block_lanczos_tpu_torch.utils import mmio
from block_lanczos_tpu_torch.utils.verbosity import VerbosityEngine

PREEMPTION_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lanczos-modp-torch",
        description="block Lanczos kernel vectors of a sparse matrix mod p "
                    "(PyTorch + CUDA, p < 2^62 and GF(2), on one device or "
                    "a mesh of ranks)")
    ap.add_argument("--matrix", required=True,
                    help="MatrixMarket file containing the sparse matrix")
    ap.add_argument("--prime", required=True, type=int,
                    help="compute modulo P (P < 2^62; P > 2^30 - 35 "
                         "takes the wide field)")
    ap.add_argument("--n", type=int, default=1,
                    help=f"blocking factor [default 1]; this port takes "
                         f"n <= {narrow.MAX_N} in the narrow field, "
                         f"n <= {wide.MAX_N} in the wide field and, on "
                         f"CUDA, n <= {gf2.MAX_N} over GF(2)")
    ap.add_argument("--output-file",
                    help="store the block of kernel vectors")
    ap.add_argument("--right", action="store_true",
                    help="compute right kernel vectors")
    ap.add_argument("--left", action="store_true",
                    help="compute left kernel vectors [default]")
    ap.add_argument("--stop-after", type=int, default=-1,
                    help="stop the algorithm after N iterations")
    ap.add_argument("--no-checks", action="store_true",
                    help="disable per-iteration invariant checks")
    ap.add_argument("--sync-every", type=int, default=None, metavar="K",
                    help="iterations per host sync; default: adaptive "
                         "doubling up to 1024")
    ap.add_argument("--salvage", action="store_true",
                    help="on a failed final check, extract the verified "
                         "kernel combinations from the partial block "
                         "(the reference just reports KO)")
    ap.add_argument("--salvage-restarts", type=int, default=0, metavar="K",
                    help="with --salvage: if the salvaged yield is short of "
                         "n, re-solve up to K times with fresh random blocks "
                         "(the xoshiro stream continues) and combine the "
                         "exactly-independent verified vectors across runs")
    ap.add_argument("--no-dedup", action="store_true",
                    help="GF(2) only: keep duplicate/empty operator lines "
                         "verbatim like the reference (default: drop "
                         "duplicates to restore rank(A) on structured "
                         "instances; a no-op on duplicate-free matrices)")
    ap.add_argument("--checkpoint", nargs="?", const=60.0, type=float,
                    default=None, metavar="SECONDS",
                    help="checkpoint every SECONDS seconds [default 60]")
    ap.add_argument("--load-checkpoint", action="store_true",
                    help="resume from the checkpoint directory")
    ap.add_argument("--checkpoint-dir", default="lanczos_checkpoint",
                    help="checkpoint directory [default lanczos_checkpoint]")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA device [default] or on the CPU "
                         "(plain PyTorch versions of the kernels)")
    ap.add_argument("--single", action="store_true",
                    help="solve on a single device (the default without "
                         "--devices, --grid or --coordinator)")
    mesh = ap.add_argument_group(
        "mesh (ranks spawned by this process, one CUDA device each over "
        "NCCL, or CPU ranks over gloo with --device cpu)")
    mesh.add_argument("--devices", type=int, default=None, metavar="K",
                      help="solve on a (K, 1) grid of K ranks; with "
                           "--device cuda, K CUDA devices on this host")
    mesh.add_argument("--grid", type=int, nargs=2, default=None,
                      metavar=("R", "C"),
                      help="solve on an R x C grid of ranks")
    mesh.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                      help="several hosts: the rendezvous (HOST:PORT of "
                           "global rank 0, or a file:// path all can "
                           "reach); run one process per host with "
                           "identical flags")
    mesh.add_argument("--num-processes", type=int, default=1,
                      help="number of processes (hosts) [default 1]")
    mesh.add_argument("--process-id", type=int, default=0,
                      help="this process's index in [0, num-processes)")
    mesh.add_argument("--local-devices", type=int, default=None,
                      metavar="L",
                      help="ranks this process spawns [default 1]; with "
                           "--device cuda, L CUDA devices on this host")
    mesh.add_argument("--overlap", action="store_true",
                      help="chunk each SpMV so exact reductions overlap "
                           "local compute (mesh solvers, all three "
                           "fields); alone, a mesh over every CUDA device "
                           "of this host (one rank with --device cpu)")
    return ap


def _refusal(args) -> str | None:
    if args.prime > PRIME_CAP:
        if args.n > wide.MAX_N:
            return (f"n = {args.n} is above the wide field's cap of n <= "
                    f"{wide.MAX_N}: not supported by this port yet")
    elif args.prime == 2 and args.n % 32 == 0:
        if args.device == "cuda" and args.n > gf2.MAX_N:
            return (f"n = {args.n} is above the GF(2) kernels' cap of n <= "
                    f"{gf2.MAX_N}: not supported by this port yet")
    elif args.n > narrow.MAX_N:
        return (f"n = {args.n} is above the narrow field's cap of n <= "
                f"{narrow.MAX_N}: not supported by this port yet")
    return None


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The ranks this process spawns and the grid they form."""
    R: int
    C: int
    devices: tuple          # one a local rank
    backend: str
    init_method: str | None
    world: int
    rank_offset: int


def _mesh_plan(args):
    """None for the one-device solve, a MeshPlan, or the reason (str) to
    exit with code 2."""
    if args.coordinator is None:
        if args.single:
            return None
        if args.num_processes != 1:
            return "--num-processes needs --coordinator"
        if args.process_id != 0:
            return "--process-id needs --coordinator"
        if args.local_devices is not None:
            return "--local-devices needs --coordinator"
        if args.grid is not None:
            local = world = args.grid[0] * args.grid[1]
        elif args.devices is not None:
            local = world = args.devices
        elif args.overlap:      # the JAX CLI's mesh over every device
            local = world = _device_count(args.device)
        else:
            return None
        init_method, offset = None, 0
    else:
        P, local = args.num_processes, args.local_devices or 1
        if P < 1 or local < 1:
            return "--num-processes and --local-devices must be >= 1"
        if not 0 <= args.process_id < P:
            return (f"--process-id {args.process_id} is not in "
                    f"[0, {P})")
        world, offset = P * local, args.process_id * local
        init_method = (args.coordinator if "://" in args.coordinator
                       else f"tcp://{args.coordinator}")
    R, C = (tuple(args.grid) if args.grid
            else (args.devices, 1) if args.devices else (world, 1))
    if R < 1 or C < 1:
        return f"the grid {R} x {C} must have R, C >= 1"
    if args.devices is not None and args.devices != R * C:
        return f"--devices {args.devices} does not match the grid {R} x {C}"
    if R * C != world:
        return (f"the grid {R} x {C} needs {R * C} ranks; this world has "
                f"{world} ({args.num_processes} process(es) x {local})")
    if args.device == "cuda":
        import torch
        have = torch.cuda.device_count()
        if local > have:
            return (f"{local} ranks on this host need {local} CUDA devices "
                    f"(one a rank); torch.cuda.device_count() = {have}")
        devices = tuple(f"cuda:{k}" for k in range(local))
        backend = "nccl"
    else:
        devices, backend = ("cpu",) * local, "gloo"
    return MeshPlan(R, C, devices, backend, init_method, world, offset)


def _device_count(device: str) -> int:
    """The ranks a mesh over every device of this host has: its CUDA
    devices (at least one, so that a host without any is told it needs
    one), or one CPU rank."""
    if device != "cuda":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.prime > WIDE_PRIME_CAP:
        # the reference stops at 2^30 - 35; the JAX package at 2^62
        print(f"p is capped at 2**62 - 1 (got {args.prime})",
              file=sys.stderr)
        return 1
    reason = _refusal(args)
    plan = _mesh_plan(args) if reason is None else None
    if isinstance(plan, str):
        reason = plan
    if reason is not None:
        print(reason, file=sys.stderr)
        return 2
    if args.output_file and args.stop_after > 0:
        print("--stop-after and --output-file are mutually exclusive",
              file=sys.stderr)
        return 1
    if plan is None:
        return _solve(args)
    import torch.multiprocessing as mp

    from block_lanczos_tpu_torch.parallel import launch
    # the signal a checkpointed mesh's ranks poll: this process receives
    # SIGTERM / SIGINT, its ranks do not (launch.spawn passes it on)
    preempt = (None if args.checkpoint is None
               else mp.get_context("spawn").RawValue("i", 0))
    try:
        rcs = launch.spawn(_mesh_rank, plan.devices,
                           args=(args, plan, preempt),
                           backend=plan.backend,
                           init_method=plan.init_method,
                           world_size=plan.world,
                           rank_offset=plan.rank_offset, preempt=preempt)
    except launch.RankFailed as e:
        print(f"the mesh failed: {e}", file=sys.stderr)
        return 1
    return max(rcs)


def _preempted(rc: int) -> bool:
    """The exit code of a run that saved and stopped on a signal."""
    return rc in {128 + int(s) for s in PREEMPTION_SIGNALS}


def _mesh_rank(rank, world, device, args, plan: MeshPlan,
               preempt=None) -> int:
    """One rank of the mesh: the CLI's solve on the grid.  A rank that
    fails exits non-zero, and the launcher then stops the others; a
    preempted mesh returns 128 + signum from every rank."""
    from block_lanczos_tpu_torch.parallel.mesh import make_grid
    if preempt is not None:
        # a terminal's Ctrl-C reaches the ranks as well as their parent:
        # a signal here is a request like the one the parent passes on
        def on_signal(signum, frame):
            preempt.value = preempt.value or int(signum)
        _on_signals(on_signal)
    rc = _solve(args, make_grid(plan.R, plan.C, device), preempt)
    if rc != 0 and not _preempted(rc):
        raise SystemExit(rc)
    return rc


def _make_solver(args, M, right: bool, grid):
    checks, sync, overlap = not args.no_checks, args.sync_every, args.overlap
    if args.prime > PRIME_CAP:
        if grid is None:
            from block_lanczos_tpu_torch.models.lanczos_wide import \
                BlockLanczosWide
            return BlockLanczosWide(M, n=args.n, right=right,
                                    check_invariants=checks, sync_every=sync,
                                    device=args.device)
        from block_lanczos_tpu_torch.parallel.distributed_wide import \
            ShardedBlockLanczosWide
        return ShardedBlockLanczosWide(M, n=args.n, right=right, grid=grid,
                                       check_invariants=checks,
                                       sync_every=sync, overlap=overlap)
    if args.prime == 2 and args.n % 32 == 0:
        if grid is None:
            from block_lanczos_tpu_torch.models.lanczos_gf2 import \
                BlockLanczosGF2
            return BlockLanczosGF2(M, n=args.n, right=right,
                                   check_invariants=checks, sync_every=sync,
                                   dedup=not args.no_dedup,
                                   device=args.device)
        from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
            ShardedBlockLanczosGF2
        return ShardedBlockLanczosGF2(M, n=args.n, right=right, grid=grid,
                                      check_invariants=checks,
                                      sync_every=sync,
                                      dedup=not args.no_dedup,
                                      overlap=overlap)
    if grid is None:
        from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
        return BlockLanczos(M, n=args.n, right=right,
                            check_invariants=checks, sync_every=sync,
                            device=args.device)
    from block_lanczos_tpu_torch.parallel.distributed import \
        ShardedBlockLanczos
    return ShardedBlockLanczos(M, n=args.n, right=right, grid=grid,
                               check_invariants=checks, sync_every=sync,
                               overlap=overlap)


class _PreemptionSaved(Exception):
    pass


def _on_signals(handler):
    """Install `handler` for SIGTERM and SIGINT (in the main thread only:
    elsewhere Python takes no handlers); returns what puts the old ones
    back."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    old = {sig: signal.signal(sig, handler) for sig in PREEMPTION_SIGNALS}
    return lambda: [signal.signal(sig, h) for sig, h in old.items()]


def _solve(args, grid=None, preempt=None) -> int:
    """Load, resume, solve, checkpoint, salvage and write, on one device
    (grid None) or as one rank of a grid; only the root rank prints and
    writes.  `preempt`: a mesh rank's shared signal number, which its
    parent process and its own handler set (0 while none came)."""
    root = grid is None or grid.is_root
    right = args.right and not args.left

    def say(*a, err=False):
        if root:
            print(*a, file=sys.stderr if err else sys.stdout)

    try:
        M = mmio.load_mtx(args.matrix, args.prime, verbose=root)
    except (OSError, ValueError) as e:
        print(f"cannot load matrix {args.matrix}: {e}", file=sys.stderr)
        return 1
    say(f"  - {M.nrows} x {M.ncols} with {M.nnz} nz", err=True)
    field = ("wide" if args.prime > PRIME_CAP
             else "gf2" if args.prime == 2 and args.n % 32 == 0
             else "narrow")
    run_meta = {"matrix": args.matrix, "prime": args.prime, "n": args.n,
                "right": right, "field": field,
                "nrows": M.nrows, "ncols": M.ncols, "nnz": M.nnz}
    state = None
    extra_time = 0.0
    if args.load_checkpoint:
        try:
            state = ckpt.load_checkpoint(args.checkpoint_dir)
        except (OSError, ValueError) as e:
            # ValueError covers corrupt manifests (json.JSONDecodeError)
            # and torn sharded snapshots (_load_sharded)
            say(f"cannot load checkpoint from {args.checkpoint_dir}: {e}",
                err=True)
            return 1
        try:
            ckpt.validate_meta(state, run_meta)
        except ckpt.CheckpointMismatch as e:
            say(e, err=True)
            return 1
        if state.get("matrix") not in (None, args.matrix):
            say(f"  - note: checkpoint was written for matrix path "
                f"{state['matrix']!r} (shape/nnz match; continuing)",
                err=True)
        extra_time = float(state.get("elapsed", 0.0))
        say(f"Resuming from iteration {state['iteration']} "
            f"({args.checkpoint_dir})")
    if field == "wide":
        say("  - wide field (p > 2^30): native 64-bit residues", err=True)
    elif field == "gf2":
        # the factorization case: bitsliced GF(2), 32 elements per word
        say("  - GF(2) bitsliced path (p = 2, n % 32 == 0)", err=True)
    try:
        solver = _make_solver(args, M, right, grid)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1

    # The operator dimension m_eff depends on the GF(2) dedup setting, so a
    # checkpoint written under a different --no-dedup choice would continue
    # the recurrence under a DIFFERENT operator: refuse it before solving.
    run_meta["m_eff"] = int(solver.m_eff)
    resume_state = None
    if state is not None:
        try:
            ckpt.validate_meta(state, run_meta)
        except ckpt.CheckpointMismatch as e:
            say(e, err=True)
            if field == "gf2":
                say("  (an m_eff mismatch at equal nrows/ncols/nnz means "
                    "the checkpoint was written under a different GF(2) "
                    "dedup setting; rerun with the matching --no-dedup "
                    "choice)", err=True)
            return 1
        try:   # the JAX package's on-disk form -> the port's blocks
            resume_state = convert.FROM_NUMPY[field](
                state, "cpu" if grid is not None else solver.device)
        except ValueError as e:
            say(f"cannot load checkpoint from {args.checkpoint_dir}: {e}",
                err=True)
            return 1

    verb = VerbosityEngine(solver.expected_iterations, extra_time=extra_time)
    verb.n_iterations = int(state["iteration"]) if state is not None else 0
    manager = restore = None
    if args.checkpoint is not None:
        manager = ckpt.CheckpointManager(
            args.checkpoint_dir, interval_s=args.checkpoint, meta=run_meta,
            verbose=True, solver=solver)
    if manager is not None and grid is None:
        # Preemption-safe exit: SIGTERM/SIGINT request a checkpoint; the
        # next callback persists {v, p, iteration} and the run exits
        # 128 + signum; a second signal before the save takes the default
        # action.  (A mesh rank polls `preempt` instead, below; its parent
        # kills the ranks on a second signal, parallel/launch.py.)
        def on_signal(signum, frame):
            manager.request_save(signum)
            signal.signal(signum, signal.SIG_DFL)

        restore = _on_signals(on_signal)

    def on_iteration(slv, iteration, v, p_blk, start):
        # iteration == 0 happens when the very first probe converges (the
        # stopping iteration is uncounted): nothing to report, but the
        # checkpoint due-check below must still run (collective on a mesh)
        verb.n_iterations = max(iteration - 1, 0)
        if root and iteration > 0:
            verb.tick(start)
        if manager is None:
            return
        if preempt is not None and preempt.value:
            manager.request_save(preempt.value)
        if manager.maybe_save(iteration, v, p_blk, start,
                              extra_time=extra_time) \
                and manager.signum is not None:
            raise _PreemptionSaved

    try:
        res = solver.solve(stop_after=args.stop_after, verbose=root,
                           on_iteration=on_iteration,
                           resume_state=resume_state)
    except _PreemptionSaved:
        say(f"\nReceived signal {manager.signum}; state checkpointed to "
            f"{args.checkpoint_dir} — resume with --load-checkpoint",
            err=True)
        return 128 + manager.signum
    finally:
        if restore is not None:
            restore()
    say()
    kernel, n_cols = res.kernel, args.n
    if args.salvage and res.product_zero is False and res.vtM is not None:
        from block_lanczos_tpu_torch.utils.salvage import (
            salvage_kernel, salvage_with_restarts)
        if args.salvage_restarts > 0:
            # every rank re-solves: the restarts are collective on a mesh;
            # they skip the checkpoint machinery, each a fresh independent
            # block rather than a resumable recurrence
            salvaged = salvage_with_restarts(
                lambda: solver.solve(stop_after=args.stop_after,
                                     verbose=root),
                res, args.prime, args.n, restarts=args.salvage_restarts,
                verbose=root)
        else:
            salvaged = salvage_kernel(res.kernel, res.vtM, args.prime)
            say(f"Salvage: recovered {salvaged.shape[1]} / {args.n} "
                "verified kernel vectors from the partially-converged "
                "block")
        if salvaged.shape[1] == 0:
            say("Salvage found no kernel vectors", err=True)
            return 1
        kernel, n_cols = salvaged, salvaged.shape[1]
    if args.output_file:
        say(f"Saving result in {args.output_file}")
        if root:
            mmio.write_kernel_mtx(args.output_file, kernel, solver.n_eff,
                                  n_cols)
    else:
        say("Not saving result (no --output given)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
