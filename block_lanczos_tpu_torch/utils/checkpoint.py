"""Checkpoint / resume for long solves, in the JAX package's on-disk form.

The port's copy of the JAX package's utils/checkpoint.py.  The reference
snapshots {v, tmp, Av, p} as one-u32-per-line text files on a wall-clock
timer, overwriting in place (reference: mpi/lanczos_modp.c:1413-1522,
trigger :1781-1790).  Only {v, p, n_iterations} are mathematically required
(tmp and Av are recomputed at the top of every iteration), so that is what
is saved, as a compressed `state.npz` plus a JSON `manifest.json`, each
written ATOMICALLY (tmp file + os.rename).

The files are the JAX package's, key for key and dtype for dtype, so that
either package resumes the other's checkpoint bit for bit: narrow uint32
residues (rows, n), GF(2) packed uint32 words (rows, n/32), wide (rows, n,
2) uint32 (lo, hi) pairs of canonical residues.  The port's solvers hold
int32 residues, int32 words and int64 residues: a manager bound to a
solver writes through convert.TO_NUMPY[solver.field], and a resume reads
through convert.FROM_NUMPY[field].

On a mesh (parallel/, a grid of torch.distributed ranks: processes of
their own, so "multi-process" here means any grid of more than one rank)
every rank gathers v and p whole, in true row order (`gather_rows`,
collective over its column of the grid), the grid's root writes the plain
format, and a barrier orders the write before any rank goes on; the
due-check is the root's, broadcast.  One file thus serves any grid, one
device and the JAX package at any process count.  `load_checkpoint` also
reads the JAX package's multi-process per-host step directories
(`_load_sharded`); the port writes none.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from block_lanczos_tpu_torch.utils import profiling

MANIFEST = "manifest.json"
ARRAYS = "state.npz"


def _atomic_write(path: str, write_fn):
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_tmp_")
    try:
        with os.fdopen(fd, "wb") as fh:
            write_fn(fh)
        os.rename(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(ckpt_dir: str, v, p_blk, iteration: int, elapsed: float,
                    meta: dict | None = None, verbose: bool = False,
                    rowmap: np.ndarray | None = None):
    """rowmap: padded-position -> true-row index (-1 on padding) when the
    blocks are stored in a non-identity band layout (skew-balanced mesh
    partitions, parallel/sharding.BandMap); omitted for identity layouts
    so old checkpoints stay byte-compatible."""
    os.makedirs(ckpt_dir, exist_ok=True)
    v = np.asarray(v)
    p_blk = np.asarray(p_blk)
    arrays = {"v": v, "p": p_blk}
    if rowmap is not None:
        arrays["rowmap"] = np.asarray(rowmap)
    _atomic_write(os.path.join(ckpt_dir, ARRAYS),
                  lambda fh: np.savez_compressed(fh, **arrays))
    manifest = {"iteration": int(iteration), "elapsed": float(elapsed),
                "timestamp": time.time(), "shape": list(v.shape)}
    manifest.update(meta or {})
    _atomic_write(os.path.join(ckpt_dir, MANIFEST),
                  lambda fh: fh.write(json.dumps(manifest, indent=1).encode()))
    if verbose:
        print(f"\n    >> checkpoint at iteration {iteration} -> {ckpt_dir}",
              flush=True)


def _load_sharded(ckpt_dir: str, manifest: dict) -> dict:
    """Reassemble the global {v, p} from per-host shard files."""
    step_dir = os.path.join(ckpt_dir, manifest["step_dir"])
    state = {}
    for name, am in manifest["arrays"].items():
        state[name] = np.zeros(tuple(am["shape"]), np.dtype(am["dtype"]))
    for k in range(int(manifest["shard_files"])):
        with np.load(os.path.join(step_dir, f"shard_{k}.npz")) as z:
            if int(z["iteration"]) != int(manifest["iteration"]):
                raise ValueError(
                    f"torn checkpoint: shard_{k} is at iteration "
                    f"{int(z['iteration'])}, manifest at "
                    f"{int(manifest['iteration'])}")
            if "rowmap" in z.files:
                state["rowmap"] = z["rowmap"]
            for name in manifest["arrays"]:
                for t in range(int(z[f"{name}_count"])):
                    data = z[f"{name}{t}_data"]
                    start = z[f"{name}{t}_start"]
                    sl = tuple(slice(int(s), int(s) + int(d))
                               for s, d in zip(start, data.shape))
                    state[name][sl] = data
    state.update(manifest)
    return state


def load_checkpoint(ckpt_dir: str) -> dict:
    """The checkpoint in ckpt_dir as a {v, p, ...manifest} dict (span
    checkpoint.load)."""
    with profiling.span("checkpoint.load"):
        with open(os.path.join(ckpt_dir, MANIFEST)) as fh:
            manifest = json.load(fh)
        if "step_dir" in manifest:  # per-host sharded format
            return _load_sharded(ckpt_dir, manifest)
        with np.load(os.path.join(ckpt_dir, ARRAYS)) as z:
            state = {"v": z["v"], "p": z["p"]}
            if "rowmap" in z.files:
                state["rowmap"] = z["rowmap"]
        state.update(manifest)
        return state


class CheckpointMismatch(ValueError):
    """The checkpoint on disk belongs to a different problem/configuration."""


# Manifest keys that must agree with the resuming invocation.  Matrix identity
# is established by (nrows, ncols, nnz) rather than the path string, so moving
# the matrix file does not invalidate a checkpoint.  The reference blindly
# trusts whatever is on disk (mpi/lanczos_modp.c:1678-1686) — we refuse instead
# of silently producing garbage.  m_eff fingerprints the EFFECTIVE operator:
# it differs at equal (nrows, ncols, nnz) exactly when the GF(2) dedup
# setting changed between write and resume (ops/gf2.py::dedup_lines).
VALIDATED_KEYS = ("prime", "n", "right", "field", "nrows", "ncols", "nnz",
                  "m_eff")


def validate_meta(state: dict, expected: dict):
    """Raise CheckpointMismatch if the manifest conflicts with `expected`.

    Only keys present in BOTH dicts are compared, so manifests written by
    older versions (without the full meta) still resume.
    """
    mismatches = []
    for k in VALIDATED_KEYS:
        if k in state and k in expected and state[k] != expected[k]:
            mismatches.append(
                f"{k}: checkpoint has {state[k]!r}, this run has "
                f"{expected[k]!r}")
    if mismatches:
        raise CheckpointMismatch(
            "checkpoint is incompatible with this invocation:\n  "
            + "\n  ".join(mismatches))


class CheckpointManager:
    """Timer-driven checkpointing (reference default: every 60 s).

    Without `solver`, maybe_save writes the blocks it is given as they are
    (NumPy arrays in the on-disk form).  Bound to a solver (one device, or
    a mesh solver on its grid), it takes the solver's own v and p tensors,
    as the solvers' on_iteration hands them over, and writes them in the
    JAX package's form; on a grid of more than one rank every rank must
    call maybe_save at every callback (the due-check and the save are
    collective).
    """

    def __init__(self, ckpt_dir: str, interval_s: float = 60.0,
                 meta: dict | None = None, verbose: bool = False,
                 solver=None):
        self.ckpt_dir = ckpt_dir
        self.interval_s = interval_s
        self.meta = meta or {}
        self.verbose = verbose
        self.solver = solver
        self.grid = getattr(solver, "grid", None)
        self._last = time.time()
        self.saves = 0
        # Iteration-deterministic due-check schedule: ranks only talk when
        # `iteration` crosses the (broadcast-agreed) target, so the steady
        # state between checkpoints costs ZERO collectives even with
        # per-iteration callbacks (sync_every=1).
        self._next_check_iter = 0
        self._iter_mark = None  # (iteration, time) of the last rate sample
        # preemption support: a signal handler calls request_save() and the
        # next callback persists the state (see cli's SIGTERM handler);
        # `signum` is the signal to exit with once saved (on a mesh: the
        # root's, as every rank learns at the due-check)
        self.save_requested = False
        self.signum = None

    def request_save(self, signum: int | None = None):
        """Ask for a save at the next opportunity (signal-handler-safe:
        only sets flags), to be followed by an exit on `signum` when one is
        given.  One device: the next callback saves immediately.  A mesh:
        honored at the next iteration-deterministic due-check (a
        rank-local bypass would desync the collective save), and only the
        ROOT's request counts; its signal number reaches every rank with
        the due-check, so that all leave at the same save."""
        self.save_requested = True
        if signum is not None:
            self.signum = int(signum)

    def _agree(self, due: bool, nxt: int) -> tuple:
        """The root's (due, next check, signal) on every rank of the grid."""
        import torch
        import torch.distributed as dist

        from block_lanczos_tpu_torch.parallel import multihost
        grid = self.grid
        t = torch.tensor([int(due), int(nxt), self.signum or 0],
                         dtype=torch.int64,
                         device=multihost.group_device(grid.group))
        dist.broadcast(t, src=grid.root, group=grid.group)
        due, nxt, sig = t.tolist()
        return bool(due), int(nxt), (int(sig) or None)

    def _disk_blocks(self, v, p_blk):
        """v and p as save_checkpoint writes them: as given without a
        solver; else the solver's blocks whole (gathered on a grid: every
        rank) in the JAX package's form."""
        if self.solver is None:
            return v, p_blk
        if self.grid is not None:
            v, p_blk = self.solver.gather_rows(v), self.solver.gather_rows(
                p_blk)
        from block_lanczos_tpu_torch.convert import TO_NUMPY
        disk = TO_NUMPY[self.solver.field]({"v": v, "p": p_blk})
        return disk["v"], disk["p"]

    def maybe_save(self, iteration: int, v, p_blk, start_time: float,
                   extra_time: float = 0.0):
        # a grid of more than one rank: the due-check is the root's
        multi = self.grid is not None and self.grid.size > 1
        if iteration < self._next_check_iter and not (
                self.save_requested and not multi):
            return False
        now = time.time()
        due = (now - self._last >= self.interval_s) or self.save_requested
        # root's iteration-rate estimate -> next due-check target (approach
        # the deadline geometrically: at most ~log2 checks per interval)
        rate = None
        if self._iter_mark is not None:
            i0, t0 = self._iter_mark
            if iteration > i0 and now > t0:
                rate = (iteration - i0) / (now - t0)
        self._iter_mark = (iteration, now)
        remaining_s = (self.interval_s if due
                       else self.interval_s - (now - self._last))
        if rate is None:
            nxt = iteration + 1
        else:
            nxt = iteration + max(1, int(rate * remaining_s * 0.5))
        # A mesh: the save is collective (every rank gathers, the root
        # writes, then a barrier), and the NEXT check target gates whether
        # ranks enter this function's collective at all — both must be
        # identical everywhere, so take the root's verdict for both.
        if multi:
            due, nxt, self.signum = self._agree(due, nxt)
        self._next_check_iter = int(nxt)
        if not due:
            return False
        self._last = now
        with profiling.span("checkpoint.save", iteration=iteration):
            v, p_blk = self._disk_blocks(v, p_blk)
            if self.grid is None or self.grid.is_root:
                save_checkpoint(self.ckpt_dir, v, p_blk, iteration,
                                (now - start_time) + extra_time, self.meta,
                                self.verbose)
            if multi:
                from block_lanczos_tpu_torch.parallel import multihost
                multihost.barrier(self.grid.group)
        self.saves += 1
        self.save_requested = False
        return True
