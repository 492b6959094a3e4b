"""The sharded block Lanczos solver for wide primes (2^30 - 35 < p < 2^62).

The port of the JAX package's parallel/distributed_wide.py
(`partition_matrix_wide`, `_local_step`, `ShardedBlockLanczosWide`, and
the overlap variant `partition_matrix_overlap_wide` and
`_local_step_overlap`): parallel/distributed.py's solver on int64 residues,
with the wide kernels (ops/wide_ops.py, models/lanczos_wide.py) and the
exact wide all-reduce `psum_mod_wide` after each partial.  Each rank's
block is built by the single-device wide layout builder
(ops/wide_ops.py::make_wide_op), so the int32 signed-coefficient slab is
chosen per block; layout.build's `slab` names each direction's.
"""

from __future__ import annotations

import numpy as np
import torch

from block_lanczos_tpu_torch.models import lanczos_wide as lw
from block_lanczos_tpu_torch.models.lanczos import resume_rows
from block_lanczos_tpu_torch.ops import wide_ops as wo
from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
from block_lanczos_tpu_torch.parallel import collectives
from block_lanczos_tpu_torch.parallel import sharding as shard_lib
from block_lanczos_tpu_torch.parallel.distributed import _ShardedSolver
from block_lanczos_tpu_torch.parallel.mesh import Grid, make_mesh
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix


def _op_maker(f: GFpWide):
    """A block's operator: the single-device wide layout (its slab chosen
    per block)."""
    def build(out_idx, in_idx, vals, out_dim, in_dim):
        return wo.make_wide_op(f, out_idx, in_idx, vals, out_dim, in_dim)
    return build


def partition_matrix_wide(f: GFpWide, M: COOMatrix, right: bool, grid: Grid,
                          pad_multiple: int = 8) -> shard_lib.ShardedOps:
    """This rank's block of the wide-field matrix as wide HybridOps."""
    return shard_lib.partition(grid, M.i, M.j, np.asarray(M.x), M.nrows,
                               M.ncols, right, _op_maker(f), pad_multiple,
                               span_attrs=wo.slab_attrs)


def partition_matrix_overlap_wide(f: GFpWide, M: COOMatrix, right: bool,
                                  grid: Grid, pad_multiple: int = 8
                                  ) -> shard_lib.OverlapShardedOps:
    """`partition_matrix_wide` with each direction split into two row
    chunks (sharding.partition_overlap)."""
    return shard_lib.partition_overlap(
        grid, M.i, M.j, np.asarray(M.x), M.nrows, M.ncols, right,
        _op_maker(f), pad_multiple, solver="ShardedBlockLanczosWide",
        span_attrs=wo.slab_attrs)


class ShardedBlockLanczosWide(_ShardedSolver):
    """The wide-field solver on a process grid; the API mirrors
    ShardedBlockLanczos.  The result's `kernel` and `vtM` are uint64."""

    label = "wide field, "
    field = "wide"
    kernel_dtype = np.uint64
    _invariants = staticmethod(lw.check_invariants)

    def __init__(self, M: COOMatrix, n: int = 1, right: bool = False,
                 grid: Grid | None = None, pad_multiple: int = 8,
                 check_invariants: bool = True,
                 sync_every: int | None = None, overlap: bool = False):
        grid = make_mesh() if grid is None else grid
        if not 1 <= int(n) <= lw.MAX_N:
            raise ValueError(f"block width n must be in [1, {lw.MAX_N}]")
        self.f = GFpWide.make(M.prime)
        part = (partition_matrix_overlap_wide if overlap
                else partition_matrix_wide)
        with profiling.span("layout", field=self.field):
            ops = part(self.f, M, right, grid, pad_multiple)
        self._setup(grid, ops, n, right, check_invariants, sync_every,
                    overlap)

    def _v0(self) -> np.ndarray:
        with profiling.span("v0.draw", device="cpu"):
            block = self._rng.fill_mod64(self.n_eff * self.n, self.f.p)
        with profiling.span("v0.pack"):
            return self.row_map.scatter(
                block.reshape(self.n_eff, self.n).astype(np.int64))

    def _state_block(self, resume_state: dict, name: str) -> np.ndarray:
        arr = resume_rows(resume_state, name, self.n_eff, self.n)
        if arr.size and (arr.min() < 0 or int(arr.max()) >= self.f.p):
            raise ValueError(f"resume block {name!r} holds values outside "
                             f"[0, p)")
        return self.row_map.scatter(arr.astype(np.int64))

    def _workspace(self) -> dict:
        ops, n, dev = self.ops, self.n, self.device
        ws = {"tmp": torch.zeros((ops.mband, n), dtype=torch.int64,
                                 device=dev),
              "av": torch.zeros((ops.band, n), dtype=torch.int64, device=dev),
              "grams": torch.zeros((2 * n, n), dtype=torch.int64, device=dev)}
        if dev.type == "cuda":
            ws["si"] = wo.empty_outputs(n, dev)
        self._bind_sums(ws, collectives.PsumModWide, self.f)
        return ws

    def _spmv(self, op, x, out):
        return wo.spmv_wide(self.f, op, x, out_rows=out.shape[0], out=out)

    def _step(self, v, p_blk, state, ws) -> None:
        """One iteration on this rank (the JAX package's _local_step, or
        with overlap its _local_step_overlap)."""
        f = self.f
        tmp = self._product(ws, "tmp", v)
        av = self._product(ws, "av", tmp)
        grams = wo.gram_wide(v, av, f, out=ws["grams"])
        ws["grams_sum"](grams)
        si = wo.semi_inverse_wide(grams, f, state, self.check_invariants,
                                  out=ws.get("si"))
        lw.orthogonalize_wide(v, p_blk, av, si.rhs, si.d, f, state)
        ws.update(grams=grams, si=si)
