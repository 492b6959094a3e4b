"""The sharded bitsliced GF(2) block Lanczos solver.

The port of the JAX package's parallel/distributed_gf2.py
(`partition_matrix_gf2`, `_local_step`, `ShardedBlockLanczosGF2`, the
overlap variant `partition_matrix_overlap_gf2` and `_local_step_overlap`;
not the `_pxor_planes` yardstick): parallel/distributed.py's
driver on (rows, n/32) int32 bit words, with the GF(2) kernels
(ops/gf2.py, models/lanczos_gf2.py) and the exact XOR all-reduce `pxor`
(parallel/collectives.py, K3) after each partial, through its bound form
`collectives.Pxor`, one built for each workspace block.  Each rank's block is
built by the single-device GF(2) layout builder, split by column into as
many bands as its own slice of x needs on this card's L2
(models/lanczos_gf2.py::choose_bands on the block's in_dim).
"""

from __future__ import annotations

import numpy as np
import torch

from block_lanczos_tpu_torch.models import lanczos_gf2 as lg
from block_lanczos_tpu_torch.models.lanczos import final_check, resume_rows
from block_lanczos_tpu_torch.ops import gf2
from block_lanczos_tpu_torch.parallel import collectives
from block_lanczos_tpu_torch.parallel import sharding as shard_lib
from block_lanczos_tpu_torch.parallel.distributed import _ShardedSolver
from block_lanczos_tpu_torch.parallel.mesh import Grid, make_mesh
from block_lanczos_tpu_torch.utils import profiling
from block_lanczos_tpu_torch.utils.mmio import COOMatrix


def _odd_entries(M: COOMatrix, right: bool, dedup: bool):
    """(mi, mj, nrows_eff, ncols_eff, dedup_dropped): the odd entries,
    after the m_eff-side dedup when `dedup`."""
    odd = (np.asarray(M.x) & 1) == 1
    mi, mj = M.i[odd], M.j[odd]
    if not dedup:
        return mi, mj, M.nrows, M.ncols, (0, 0)
    with profiling.span("layout.dedup"):
        mi, mj, nrows_eff, ncols_eff, n_dup, n_empty = gf2.dedup_lines(
            mi, mj, M.nrows, M.ncols, right)
    return mi, mj, nrows_eff, ncols_eff, (n_dup, n_empty)


def _op_maker(grid: Grid, W: int):
    """A block's operator: GF2Op column bands for blocks of W words, as
    many as its own slice of x needs on this card's L2."""
    l2 = (torch.cuda.get_device_properties(grid.device).L2_cache_size
          if grid.device.type == "cuda" else None)

    def build(out_idx, in_idx, _vals, out_dim, in_dim):
        return lg.make_gf2_bands(out_idx, in_idx, out_dim, in_dim,
                                 lg.choose_bands(in_dim, W, l2))
    return build


def partition_matrix_gf2(M: COOMatrix, right: bool, grid: Grid, W: int,
                         pad_multiple: int = 8, dedup: bool = True):
    """(ops, dedup_dropped): this rank's block of the odd entries (after
    the m_eff-side dedup, then balanced on the surviving entries), each
    direction a tuple of GF2Op column bands for blocks of W words."""
    mi, mj, nrows_eff, ncols_eff, dropped = _odd_entries(M, right, dedup)
    return shard_lib.partition(grid, mi, mj, None, nrows_eff, ncols_eff,
                               right, _op_maker(grid, W),
                               pad_multiple), dropped


def partition_matrix_overlap_gf2(M: COOMatrix, right: bool, grid: Grid,
                                 W: int, pad_multiple: int = 8,
                                 dedup: bool = True):
    """(ops, dedup_dropped) of `partition_matrix_gf2` with each direction
    split into two row chunks (sharding.partition_overlap), each chunk's
    operator in its own column bands."""
    mi, mj, nrows_eff, ncols_eff, dropped = _odd_entries(M, right, dedup)
    return shard_lib.partition_overlap(
        grid, mi, mj, None, nrows_eff, ncols_eff, right, _op_maker(grid, W),
        pad_multiple, solver="ShardedBlockLanczosGF2"), dropped


class ShardedBlockLanczosGF2(_ShardedSolver):
    """The bitsliced GF(2) solver on a process grid; the API mirrors
    ShardedBlockLanczos.  Requires p == 2 and n % 32 == 0 (32 <= n <= 512
    on CUDA); dedup as in models.lanczos_gf2.BlockLanczosGF2."""

    label = "GF(2) bitsliced, "
    overlap_mark = " overlap"
    field = "gf2"

    def __init__(self, M: COOMatrix, n: int = 32, right: bool = False,
                 grid: Grid | None = None, pad_multiple: int = 8,
                 check_invariants: bool = True,
                 sync_every: int | None = None, dedup: bool = True,
                 overlap: bool = False):
        grid = make_mesh() if grid is None else grid
        if int(M.prime) != 2 or int(n) % gf2.WORD != 0:
            raise ValueError("GF(2) sharded solver requires p == 2 and "
                             "n % 32 == 0")
        W = (gf2.check_width(int(n)) if grid.device.type == "cuda"
             else gf2.words(int(n)))
        part = (partition_matrix_overlap_gf2 if overlap
                else partition_matrix_gf2)
        with profiling.span("layout", field=self.field):
            ops, self.dedup_dropped = part(M, right, grid, W, pad_multiple,
                                           dedup)
        self.W = W
        self._setup(grid, ops, n, right, check_invariants, sync_every,
                    overlap)

    def _v0(self) -> np.ndarray:
        with profiling.span("v0.draw", device="cpu"):
            bits = self._rng.fill_mod(self.n_eff * self.n, 2)
        with profiling.span("v0.pack"):
            block = self.row_map.scatter(
                bits.reshape(self.n_eff, self.n).astype(np.uint32))
            return gf2.pack_bits_np(block).view(np.int32)

    def _state_block(self, resume_state: dict, name: str) -> np.ndarray:
        arr = resume_rows(resume_state, name, self.n_eff, self.W)
        return self.row_map.scatter(arr.astype(np.uint32).view(np.int32))

    def _workspace(self) -> dict:
        ops, n, W, dev = self.ops, self.n, self.W, self.device
        ws = {"tmp": torch.zeros((ops.mband, W), dtype=torch.int32,
                                 device=dev),
              "av": torch.zeros((ops.band, W), dtype=torch.int32, device=dev),
              "grams": torch.zeros((2 * n, W), dtype=torch.int32, device=dev)}
        if dev.type == "cuda":
            ws["si"] = gf2.empty_outputs(n, dev)
        self._bind_sums(ws, collectives.Pxor)
        return ws

    def _spmv(self, ops, x, out):
        return lg.spmv_gf2(ops, x, out_rows=out.shape[0], out=out)

    def _step(self, v, p_blk, state, ws) -> None:
        """One iteration on this rank (the JAX package's _local_step, or
        with overlap its _local_step_overlap)."""
        tmp = self._product(ws, "tmp", v)               # split by cols
        av = self._product(ws, "av", tmp)               # split by rows
        grams = gf2.gram_gf2(v, av, out=ws["grams"])
        ws["grams_sum"](grams)                          # replicated
        si = gf2.semi_inverse_gf2(grams, state, self.check_invariants,
                                  out=ws.get("si"))
        lg.orthogonalize_gf2(v, p_blk, av, si.rhs, si.d, state)
        ws.update(grams=grams, si=si)

    def _invariant_failure(self, ws, iteration):
        raise AssertionError("device invariant check failed (GF2, sharded) "
                             f"at iteration ~{iteration}")

    def _final_gathered(self, v_true, tmp_true, verbose):
        with profiling.span("final.unpack"):
            v_bits = gf2.unpack_bits_np(v_true, self.n)
            tmp_bits = (None if tmp_true is None
                        else gf2.unpack_bits_np(tmp_true, self.n))
        v_nonzero = product_zero = vtM = None
        if tmp_bits is not None:
            v_nonzero, product_zero = final_check(
                v_bits, tmp_bits, self.n_eff, self.m_eff, verbose)
            if not product_zero:
                vtM = tmp_bits[:self.m_eff]
        return v_bits[:self.n_eff], v_nonzero, product_zero, vtM
