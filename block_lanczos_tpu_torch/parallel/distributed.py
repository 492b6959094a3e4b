"""The sharded block Lanczos solver on a process grid, narrow field.

The port of the JAX package's parallel/distributed.py (`_local_step`,
`_local_multi_step`, `ShardedBlockLanczos`, and with overlap=True
`_local_step_overlap`) on torch.distributed.  Each rank of an (R, C) grid
(parallel/mesh.py) holds its block of the matrix (parallel/sharding.py),
the rows-band of v, Av and p and the cols-band of tmp; one iteration is
the single-device iteration (models/lanczos.py::iteration_step) with an
exact all-reduce after each partial (parallel/collectives.py):

    tmp = Mt_rc v_r        psum_mod over rows  -> tmp_c
    Av  = M_rc tmp_c       psum_mod over cols  -> Av_r
    [v | Av]^T Av          psum_mod over rows  -> the Grams, on every rank
    semi_inverse, orthogonalize: on every rank, from the replicated Grams

so every rank latches the same [stop, inv_ok, k_done, frozen] state, runs
the same number of iterations and issues the same collectives.  With
overlap (the JAX package's comm/compute overlap) each SpMV direction is
two row chunks (sharding.partition_overlap): chunk A's all-reduce is
started (collectives' `start`) before chunk B's SpMV and finished after
it, five all-reduces an iteration where the plain step has three; on a
card NCCL runs A's on its own stream while B's SpMV runs.  There is
no root: each rank draws the same xoshiro v0 and keeps its band, and the
final kernel is gathered through the band maps at the end.  solve() is
the single-device solvers' (models/lanczos.py::LanczosSolver, its host
loop blocked_solve_loop) with this module's hooks; the adaptive block
length is agreed over the grid (the slowest rank's time), so that all
ranks sync after the same iterations.  Bit-exact for ANY grid: mod-p sums are
exact and order-independent.

`ShardedBlockLanczosWide` (distributed_wide.py) and
`ShardedBlockLanczosGF2` (distributed_gf2.py) are this driver with the
other fields' kernels and collectives.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from block_lanczos_tpu_torch.models import lanczos as single
from block_lanczos_tpu_torch.models.lanczos import (LanczosSolver,
                                                    final_check, resume_rows)
from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.ops.dense import gram_mod
from block_lanczos_tpu_torch.ops.gfp import GFp
from block_lanczos_tpu_torch.ops.semi_inverse import (MAX_N, empty_outputs,
                                                      semi_inverse)
from block_lanczos_tpu_torch.parallel import collectives, multihost
from block_lanczos_tpu_torch.parallel import sharding as shard_lib
from block_lanczos_tpu_torch.parallel.mesh import Grid, make_mesh
from block_lanczos_tpu_torch.parallel.multihost import (fetch_global,
                                                        put_global)
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix
from block_lanczos_tpu_torch.utils.rng import Xoshiro256Plus


def agree_max(x: float, grid: Grid) -> float:
    """The largest x over the grid's ranks (one tiny all_reduce)."""
    t = torch.tensor([x], dtype=torch.float64,
                     device=multihost.group_device(grid.group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=grid.group)
    return float(t.item())


def launch_counts() -> dict:
    """{kernel name: launches} of the fifteen kernels a mesh runs: the
    three fields' four each and the three collectives (and xoshiro_fill,
    which only the single-device solvers launch)."""
    from block_lanczos_tpu_torch.models import lanczos_gf2, lanczos_wide
    out = single.launch_counts()
    out.update(lanczos_gf2.launch_counts())
    out.update(lanczos_wide.launch_counts())
    out.update(collectives.launch_counts())
    return out


def reset_launch_counts() -> None:
    from block_lanczos_tpu_torch.models import lanczos_gf2, lanczos_wide
    for mod in (single, lanczos_gf2, lanczos_wide, collectives):
        mod.reset_launch_counts()


def _chunk_views(block: torch.Tensor, split: int | None) -> list:
    """The row chunks of a workspace block the step writes and sums: the
    block itself, or its rows [0, split) and [split, ...) (contiguous
    views)."""
    return [block] if split is None else [block[:split], block[split:]]


class _ShardedSolver(LanczosSolver):
    """The mesh's hooks of the solve protocol (models/lanczos.py::
    LanczosSolver), shared by the three fields: v0 and resume bands, the
    workspace's bound collectives, the two reduced products (whole, or in
    two row chunks with overlap), the block length agreed over the grid,
    the final gather and the prime fields' check.  A field sets `label`,
    `overlap_mark` (the verbose header's, with overlap) and `field` (the
    checkpoint manifest's) and writes `_v0`, `_state_block`, `_workspace`,
    `_spmv` and `_step` (the wide field its `_invariants`; GF(2) its own
    `_invariant_failure` and `_final_gathered`)."""

    label = ""
    overlap_mark = ""
    _launch_counts = staticmethod(launch_counts)

    def _setup(self, grid: Grid, ops, n: int, right: bool,
               check_invariants: bool, sync_every: int | None,
               overlap: bool):
        self.overlap = bool(overlap)
        self.right = bool(right)
        self._rng = Xoshiro256Plus()
        self.grid = grid
        self.device = grid.device
        self.ops = ops
        self.n = int(n)
        self.check_invariants = bool(check_invariants)
        self.sync_every = sync_every
        self.n_eff, self.m_eff = ops.n_eff, ops.m_eff
        self.np_rows, self.mp_rows = ops.np_rows, ops.mp_rows
        self.row_map, self.col_map = ops.row_map, ops.col_map
        self.expected_iterations = 1 + self.m_eff // self.n

    # -- the reduced products --------------------------------------------

    def _bind_sums(self, ws: dict, cls, *field) -> None:
        """The exact all-reduce of each partial of an iteration, bound to
        its workspace block (collectives.PsumMod or PsumModWide at the
        field `field`, or Pxor): tmp over the grid's rows, Av over its
        columns, the Grams over its rows.  ws["chunks"][key] lists the
        (operator, view of ws[key], bound sum) of each product: one, or
        with overlap the two row chunks'."""
        grid, ops = self.grid, self.ops
        split = ((None, None) if not self.overlap else (ops.ha, ops.hb))
        dirs = (((ops.first,), (ops.second,)) if not self.overlap else
                ((ops.first_a, ops.first_b), (ops.second_a, ops.second_b)))
        ws["chunks"] = {
            key: [(op, view, cls(view, *field, group=group))
                  for op, view in zip(d, _chunk_views(ws[key], s))]
            for key, d, s, group in (
                ("tmp", dirs[0], split[0], grid.rows_group),
                ("av", dirs[1], split[1], grid.cols_group))}
        ws["grams_sum"] = cls(ws["grams"], *field, group=grid.rows_group)

    def _product(self, ws: dict, key: str, x: torch.Tensor) -> torch.Tensor:
        """ws[key] <- this rank's band of the matrix's product with x,
        summed exactly over the grid: the first direction (key "tmp", x =
        v's band, summed over the rows) or the second ("av", x = tmp's,
        over the columns).  With overlap, chunk A's sum is in flight while
        chunk B's SpMV runs; every rank issues the same sums in the same
        order (A, then B)."""
        chunks = ws["chunks"][key]
        done = []
        for op, view, total in chunks:
            part = self._spmv(op, x, view)
            total.start(part)
            done.append((part, view, total))
        for part, view, total in done:
            total.finish()
            if part is not view:     # the CPU's plain SpMVs return blocks
                view.copy_(part)     # of their own
        return ws[key]

    # -- blocks in and out ------------------------------------------------

    def _band(self, padded: np.ndarray) -> torch.Tensor:
        """This rank's rows-band of a (np_rows, width) band-layout block."""
        return put_global(padded, self.grid.r, self.grid.R, self.device)

    def initial_block(self) -> torch.Tensor:
        """This rank's band of v0 (the field's `_v0`, in the band
        layout)."""
        block = self._v0()
        with profiling.span("v0.upload"):
            return self._band(block)

    def _resume_block(self, resume_state: dict, name: str) -> torch.Tensor:
        return self._band(self._state_block(resume_state, name))

    def gather_rows(self, t: torch.Tensor) -> np.ndarray:
        """A rows-split block (v, p, Av) in true row order, on every rank
        (collective over the rank's column of the grid)."""
        return self.row_map.gather(fetch_global(t, self.grid.rows_group))

    def gather_cols(self, t: torch.Tensor) -> np.ndarray:
        """A cols-split block (tmp) in true order, on every rank."""
        return self.col_map.gather(fetch_global(t, self.grid.cols_group))

    # -- the solve's hooks -----------------------------------------------

    def _banner(self) -> list:
        R, C = self.grid.shape
        mark = self.overlap_mark if self.overlap else ""
        return [f"Block Lanczos [{self.label}sharded {R}x{C}{mark}]",
                self.ops.stats.summary()]

    def _stepper(self, v, p_blk, state, ws):
        return functools.partial(self._step, v, p_blk, state, ws)

    def _agree(self, t: float) -> float:
        return agree_max(t, self.grid)

    def _final(self, v, tmp, ws, verbose):
        """v and tmp gathered whole on every rank, then checked."""
        with profiling.span("final.gather"):
            v_true = self.gather_rows(v)
            tmp_true = None if tmp is None else self.gather_cols(tmp)
        return self._final_gathered(v_true, tmp_true, verbose)

    def _final_gathered(self, v_true, tmp_true, verbose):
        """The prime fields' check of the gathered blocks: (kernel,
        v_nonzero, product_zero, vtM) as kernel_dtype."""
        v_nonzero = product_zero = vtM = None
        if tmp_true is not None:
            v_nonzero, product_zero = final_check(
                v_true, tmp_true, self.n_eff, self.m_eff, verbose)
            if product_zero is False:
                vtM = tmp_true[:self.m_eff].astype(self.kernel_dtype)
        return (v_true[:self.n_eff].astype(self.kernel_dtype), v_nonzero,
                product_zero, vtM)


class ShardedBlockLanczos(_ShardedSolver):
    """The narrow-field (p <= 2^30 - 35) solver on a process grid; the API
    mirrors models.lanczos.BlockLanczos.  `grid` defaults to the rows-only
    grid over the whole world on CUDA (mesh.make_mesh, which raises when
    there is no CUDA; torch.distributed must be initialized, e.g. by
    parallel/launch.py); blocks live on grid.device.  overlap=True splits
    each SpMV into two row chunks, so that chunk A's all-reduce is in
    flight while chunk B's product runs (sharding.partition_overlap;
    ValueError when a band is too small to split)."""

    field = "narrow"

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 grid: Grid | None = None, pad_multiple: int = 8,
                 check_invariants: bool = True,
                 sync_every: int | None = None, overlap: bool = False):
        grid = make_mesh() if grid is None else grid
        if not 1 <= int(n) <= MAX_N:
            raise ValueError(f"block width n must be in [1, {MAX_N}]")
        self.f = GFp.make(M.prime)
        part = (shard_lib.partition_matrix_overlap if overlap
                else shard_lib.partition_matrix)
        with profiling.span("layout", field=self.field):
            ops = part(self.f, M, right, grid, pad_multiple)
        self._setup(grid, ops, n, right, check_invariants, sync_every,
                    overlap)

    def _v0(self) -> np.ndarray:
        """v0 over TRUE kernel rows (the sequential xoshiro block, bit-exact
        with the reference), scattered to the band layout."""
        with profiling.span("v0.draw", device="cpu"):
            block = self._rng.fill_mod(self.n_eff * self.n, self.f.p)
        with profiling.span("v0.pack"):
            return self.row_map.scatter(
                block.reshape(self.n_eff, self.n).astype(np.int32))

    def _state_block(self, resume_state: dict, name: str) -> np.ndarray:
        arr = resume_rows(resume_state, name, self.n_eff, self.n)
        return self.row_map.scatter(arr.astype(np.int32))

    def _workspace(self) -> dict:
        ops, n, dev = self.ops, self.n, self.device
        ws = {"tmp": torch.zeros((ops.mband, n), dtype=torch.int32,
                                 device=dev),
              "av": torch.zeros((ops.band, n), dtype=torch.int32, device=dev),
              "grams": torch.zeros((2 * n, n), dtype=torch.int32, device=dev)}
        if dev.type == "cuda":
            ws["si"] = empty_outputs(n, dev)
        self._bind_sums(ws, collectives.PsumMod, self.f.p)
        return ws

    def _spmv(self, op, x, out):
        return spmm.spmv(op, x, out_rows=out.shape[0], out=out)

    def _step(self, v, p_blk, state, ws) -> None:
        """One iteration on this rank (the JAX package's _local_step, or
        with overlap its _local_step_overlap)."""
        p = self.f.p
        tmp = self._product(ws, "tmp", v)               # split by cols
        av = self._product(ws, "av", tmp)               # split by rows
        grams = gram_mod(v, av, av, p, out=ws["grams"])
        ws["grams_sum"](grams)                          # replicated
        si = semi_inverse(grams, p, state, self.check_invariants,
                          out=ws.get("si"))
        single.orthogonalize(v, p_blk, av, si.rhs, si.d, p, state)
        ws.update(grams=grams, si=si)
