"""Host-side partition of the matrix and the vectors over a process grid.

The NumPy half of the JAX package's parallel/sharding.py, copied (the
package imports JAX at its top, so nothing of it is imported here): the
nnz-balanced `BandMap` of a dimension onto equal padded bands
(`balanced_band_map`, its LPT deals), the partition summary
(`PartitionStats`, `DirStats`) and the grid geometry (`_band_size`,
`_grid_maps`).  v0's scatter and the final gather go through these maps,
so they are kept bit-identical to the JAX package's.

Grid partition over an (R, C) grid: rank (r, c) owns the nnz whose
kernel-dimension index (N-index) falls in row-band r AND whose
other-dimension index (M-index) falls in col-band c.  Its two local SpMV
directions:

  first  (tmp partial): in = local N-band of v, out = local M-band
         -> the exact sum over "rows" gives tmp, split by cols
  second (Av partial): in = local M-band of tmp, out = local N-band
         -> the exact sum over "cols" gives Av, split by rows

Where the JAX package stacks every block on leading (R, C) axes with one
slab width for all (shard_map needs identical shapes), a rank here holds
its own block only, built by the single-device layout builder with its
own width: mod-p sums are exact, so the layout changes no residue.

For comm/compute overlap (`partition_overlap`, the JAX package's
`partition_matrix_overlap*`) each direction's output rows are split in
two at a multiple of pad_multiple, over the same band maps, and each
chunk gets an operator of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# Skew-robust band assignment (a copy of the JAX package's)
# ---------------------------------------------------------------------------
#
# Equal contiguous bands collapse on skewed matrices: on a power-law
# instance one band holds most of the nnz and the per-shard work diverges.
# The reference survives arbitrary matrices because each MPI rank stores
# raw COO triplets (mpi/lanczos_modp.c:623-964); here an nnz-balanced
# PERMUTATION of the dimension onto equal padded bands keeps the shards'
# work even, bit-exactly (mod-p sums are order-independent).  Uniform
# matrices keep the identity layout.

_BALANCE_TOL = 1.25  # identity layout kept while max shard nnz <= tol*mean


@dataclasses.dataclass(frozen=True)
class BandMap:
    """Assignment of a true dimension onto `parts` equal padded bands.

    pos[g] = padded position of true index g (shard = pos//band, local
    slot = pos%band).  pos is None for the identity layout (index g at
    padded position g), the fast path for already-balanced matrices.
    """
    dim: int
    parts: int
    band: int                      # padded rows per band
    pos: np.ndarray | None = None  # (dim,) int64, or None = identity

    @property
    def padded(self) -> int:
        return self.band * self.parts

    @property
    def identity(self) -> bool:
        return self.pos is None

    def shard_local(self, idx: np.ndarray):
        """(shard id, local slot) for an int array of true indices."""
        p = idx if self.pos is None else self.pos[idx]
        return p // self.band, p % self.band

    def scatter(self, block: np.ndarray) -> np.ndarray:
        """(dim, ...) true-layout block -> (padded, ...) band layout."""
        block = np.asarray(block)
        out = np.zeros((self.padded,) + block.shape[1:], block.dtype)
        if self.pos is None:
            out[:self.dim] = block
        else:
            out[self.pos] = block
        return out

    def gather(self, padded: np.ndarray) -> np.ndarray:
        """(padded, ...) band layout -> (dim, ...) true layout."""
        padded = np.asarray(padded)
        if self.pos is None:
            return padded[:self.dim]
        return padded[self.pos]

    def rowmap(self) -> np.ndarray | None:
        """padded position -> true index (-1 on padding slots); None for
        the identity layout."""
        if self.pos is None:
            return None
        rm = np.full(self.padded, -1, np.int64)
        rm[self.pos] = np.arange(self.dim, dtype=np.int64)
        return rm


# exact (heapq) LPT above this many indices is several single-core seconds
# per axis per direction; switch to the head-LPT + snake-tail deal
_LPT_EXACT_MAX = 200_000
_LPT_HEAD_PER_PART = 128


def balanced_band_map(counts: np.ndarray, parts: int,
                      pad_multiple: int = 8) -> BandMap:
    """nnz-balanced BandMap over a dimension with per-index weights.

    Identity when contiguous equal bands are already balanced (within
    _BALANCE_TOL of a full band of average-density rows).  Otherwise a
    capacity-capped LPT deal: indices weight-sorted descending, each
    assigned to the currently-lightest band with free slots.  Above
    _LPT_EXACT_MAX indices: exact LPT on the heaviest 128*parts indices,
    then the near-uniform tail snake-dealt (falls back to the exact deal if
    a band would overflow).  Deterministic (stable sorts), so every rank
    computes the identical map.
    """
    counts = np.asarray(counts, np.int64)
    dim = len(counts)
    band = _band_size(dim, parts, pad_multiple)
    if parts == 1 or dim == 0:
        return BandMap(dim, parts, band)
    shard_nnz = np.bincount(np.arange(dim) // band, weights=counts,
                            minlength=parts)
    total = counts.sum()
    # yardstick: the weight of a FULL band of average-density rows (the
    # trailing band is legitimately short from padding; that is not skew)
    full_band_mean = total / dim * band
    if total == 0 or shard_nnz.max() <= _BALANCE_TOL * full_band_mean:
        return BandMap(dim, parts, band)
    order = np.argsort(-counts, kind="stable")   # heavy indices first
    if dim > _LPT_EXACT_MAX:
        bin_of = _lpt_snake_deal(counts, order, parts, band)
        if bin_of is None:                       # capacity check failed
            bin_of = _lpt_exact_deal(counts, order, parts, band)
    else:
        bin_of = _lpt_exact_deal(counts, order, parts, band)
    # within each band, keep true indices ascending (stable local order)
    ord2 = np.lexsort((np.arange(dim), bin_of))
    sorted_bins = bin_of[ord2]
    starts = np.searchsorted(sorted_bins, np.arange(parts))
    local = np.arange(dim, dtype=np.int64) - starts[sorted_bins]
    pos = np.empty(dim, np.int64)
    pos[ord2] = sorted_bins * band + local
    return BandMap(dim, parts, band, pos)


def _lpt_exact_deal(counts, order, parts: int, band: int):
    """Per-index capacity-capped LPT (heapq); O(dim log parts)."""
    import heapq
    heap = [(0, r) for r in range(parts)]
    bin_count = np.zeros(parts, np.int64)
    bin_of = np.empty(len(counts), np.int64)
    clist = counts.tolist()
    for g in order.tolist():
        load, r = heapq.heappop(heap)
        bin_of[g] = r
        bin_count[r] += 1
        if bin_count[r] < band:      # full bands leave the heap
            heapq.heappush(heap, (load + clist[g], r))
    return bin_of


def _lpt_snake_deal(counts, order, parts: int, band: int):
    """Exact LPT on the heavy head, vectorized snake deal of the tail.

    Returns None when a bin would exceed the band capacity (pathological
    head placement) — the caller falls back to the exact deal.
    """
    import heapq
    dim = len(counts)
    h = min(dim, _LPT_HEAD_PER_PART * parts)
    bin_of = np.empty(dim, np.int64)
    loads = np.zeros(parts, np.int64)
    heap = [(0, r) for r in range(parts)]
    clist = counts[order[:h]].tolist()
    for k, g in enumerate(order[:h].tolist()):
        load, r = heapq.heappop(heap)
        bin_of[g] = r
        loads[r] = load + clist[k]
        heapq.heappush(heap, (loads[r], r))
    tail = order[h:]
    if len(tail):
        # serpentine over bins ordered lightest-first: row 2k deals the
        # next `parts` heaviest tail indices lightest->heaviest bin, row
        # 2k+1 reverses — each bin receives exactly one index per row
        base = np.argsort(loads, kind="stable")
        t_rows = -(-len(tail) // parts)
        pattern = np.tile(np.concatenate([base, base[::-1]]),
                          (t_rows + 1) // 2 + 1)[:t_rows * parts]
        bin_of[tail] = pattern[:len(tail)]
    if np.bincount(bin_of, minlength=parts).max() > band:
        return None
    return bin_of


@dataclasses.dataclass
class DirStats:
    """Layout cost of one SpMV direction (of this rank's block here)."""
    ell: int | tuple            # slab width (a tuple over column bands)
    slab_slots: int             # rows x L slots
    spill_slots: int            # spill entries


@dataclasses.dataclass
class PartitionStats:
    """Per-shard instrumentation for a 2D matrix partition: the nnz of
    every block (each rank knows them all), whether a dimension was
    re-balanced, and this rank's layout of its two directions."""
    grid: tuple                 # (R, C)
    shard_nnz: np.ndarray       # (R, C) true nnz per shard
    row_balanced: bool          # row dimension uses a non-identity BandMap
    col_balanced: bool
    first: DirStats
    second: DirStats

    @property
    def total_slab_slots(self) -> int:
        return self.first.slab_slots + self.second.slab_slots

    @property
    def total_spill_slots(self) -> int:
        return self.first.spill_slots + self.second.spill_slots

    def summary(self) -> str:
        nnz = self.shard_nnz
        mean = nnz.mean() if nnz.size else 0.0
        mx = int(nnz.max()) if nnz.size else 0
        bal = ("balanced" if self.row_balanced or self.col_balanced
               else "contiguous")
        return (f"  - Partition {self.grid[0]}x{self.grid[1]} ({bal}): "
                f"shard nnz max/mean = {mx}/{mean:.0f} "
                f"({(mx / mean if mean else 1):.2f}x), "
                f"ell = {self.first.ell}/{self.second.ell}, "
                f"slab slots = {self.total_slab_slots}, "
                f"spill slots = {self.total_spill_slots}")


def dir_stats(op) -> DirStats:
    """DirStats of a local operator: a HybridOp or a tuple of GF2Op
    column bands."""
    if isinstance(op, tuple):
        subs = [dir_stats(b) for b in op]
        return DirStats(ell=tuple(s.ell for s in subs),
                        slab_slots=sum(s.slab_slots for s in subs),
                        spill_slots=sum(s.spill_slots for s in subs))
    return DirStats(ell=op.ell, slab_slots=op.ell * op.out_dim,
                    spill_slots=op.spill_nnz)


def _band_size(dim: int, parts: int, multiple: int) -> int:
    return ((dim + parts * multiple - 1) // (parts * multiple)) * multiple


def _grid_maps(nnz_i, nnz_j, nrows: int, ncols: int, right: bool,
               R: int, C: int, pad_multiple: int):
    """Shared partition geometry: nnz-balanced band maps for both axes.

    Returns (n_eff, m_eff, key, other, row_map, col_map) — the key/other
    arrays are the per-nnz kernel-dimension / other-dimension true indices.
    Used by every field's partitioner.
    """
    n_eff = ncols if right else nrows   # kernel dimension
    m_eff = nrows if right else ncols
    key = (nnz_j if right else nnz_i).astype(np.int64)
    other = (nnz_i if right else nnz_j).astype(np.int64)
    row_map = balanced_band_map(
        np.bincount(key, minlength=n_eff), R, pad_multiple)
    col_map = balanced_band_map(
        np.bincount(other, minlength=m_eff), C, pad_multiple)
    return n_eff, m_eff, key, other, row_map, col_map


@dataclasses.dataclass
class GridBlock:
    """The COO of one block (r, c) in local slots, and every block's nnz."""
    lo: np.ndarray          # (nnz,) int32 local M slot
    lk: np.ndarray          # (nnz,) int32 local N slot
    vals: np.ndarray | None
    shard_nnz: np.ndarray   # (R, C)


def grid_block(key, other, vals, row_map: BandMap, col_map: BandMap,
               r: int, c: int) -> GridBlock:
    """Block (r, c) of the grid: its entries' local slots (the first
    direction maps lk -> lo, the second lo -> lk), in the order of the
    COO, as the JAX package's _grid_parts gives them for that block."""
    R, C = row_map.parts, col_map.parts
    rshard, lk64 = row_map.shard_local(key)
    cshard, lo64 = col_map.shard_local(other)
    shard_nnz = np.bincount(rshard * C + cshard,
                            minlength=R * C).reshape(R, C)
    sel = (rshard == r) & (cshard == c)
    return GridBlock(lo=lo64[sel].astype(np.int32),
                     lk=lk64[sel].astype(np.int32),
                     vals=None if vals is None else vals[sel],
                     shard_nnz=shard_nnz)


@dataclasses.dataclass
class ShardedOps:
    """This rank's two local operators and the partition's dimensions."""
    grid: tuple[int, int]  # (R, C)
    band: int          # N-rows per row-shard
    mband: int         # M-rows per col-shard
    np_rows: int       # padded kernel dimension  (= band * R)
    mp_rows: int       # padded other dimension   (= mband * C)
    n_eff: int
    m_eff: int
    first: object      # local op: v band (band) -> tmp partial (mband)
    second: object     # local op: tmp band (mband) -> Av partial (band)
    row_map: BandMap
    col_map: BandMap
    stats: PartitionStats


def _block(grid, nnz_i, nnz_j, vals, nrows: int, ncols: int, right: bool,
           pad_multiple: int):
    """This rank's place in the partition over `grid` (parallel/mesh.py):
    (n_eff, m_eff, row_map, col_map, its GridBlock)."""
    n_eff, m_eff, key, other, row_map, col_map = _grid_maps(
        nnz_i, nnz_j, nrows, ncols, right, grid.R, grid.C, pad_multiple)
    blk = grid_block(key, other, vals, row_map, col_map, grid.r, grid.c)
    return n_eff, m_eff, row_map, col_map, blk


def _to_device(op, device):
    """A local operator (a HybridOp or a tuple of GF2Op bands) on device."""
    if isinstance(op, tuple):
        return tuple(b.to(device) for b in op)
    return op.to(device)


def partition(grid, nnz_i, nnz_j, vals, nrows: int, ncols: int,
              right: bool, build, pad_multiple: int = 8,
              span_attrs=None) -> ShardedOps:
    """Split the matrix over `grid` (parallel/mesh.py) and build this
    rank's block: build(out_idx, in_idx, vals, out_dim, in_dim) makes one
    local operator on the host (a field's single-device layout builder);
    both are moved to grid.device.  span_attrs(first_ops, second_ops),
    where given, names the layout.build span's attributes."""
    with profiling.span("layout.build") as span:
        n_eff, m_eff, row_map, col_map, blk = _block(
            grid, nnz_i, nnz_j, vals, nrows, ncols, right, pad_multiple)
        band, mband = row_map.band, col_map.band
        first = build(blk.lo, blk.lk, blk.vals, mband, band)
        second = build(blk.lk, blk.lo, blk.vals, band, mband)
        if span_attrs is not None:
            span.set(**span_attrs((first,), (second,)))
    stats = PartitionStats(grid=grid.shape, shard_nnz=blk.shard_nnz,
                           row_balanced=not row_map.identity,
                           col_balanced=not col_map.identity,
                           first=dir_stats(first), second=dir_stats(second))
    with profiling.span("layout.upload"):
        first, second = (_to_device(op, grid.device)
                         for op in (first, second))
    return ShardedOps(grid=grid.shape, band=band, mband=mband,
                      np_rows=band * grid.R, mp_rows=mband * grid.C,
                      n_eff=n_eff, m_eff=m_eff, first=first, second=second,
                      row_map=row_map, col_map=col_map, stats=stats)


@dataclasses.dataclass
class OverlapShardedOps:
    """ShardedOps with each SpMV direction split into two row chunks, so
    that chunk A's exact all-reduce can run while chunk B's product is
    computed (the JAX package's comm/compute overlap).  The chunks are the
    rows [0, ha) and [ha, mband) of tmp, [0, hb) and [hb, band) of Av;
    each chunk's operator reads the whole input band.  The band maps are
    the non-overlap partition's, so the iterates are the same."""
    grid: tuple[int, int]
    band: int
    mband: int
    np_rows: int
    mp_rows: int
    n_eff: int
    m_eff: int
    ha: int            # first direction's split row (out dim = mband)
    hb: int            # second direction's split row (out dim = band)
    first_a: object    # v band -> tmp rows [0, ha)
    first_b: object    # v band -> tmp rows [ha, mband)
    second_a: object   # tmp band -> Av rows [0, hb)
    second_b: object   # tmp band -> Av rows [hb, band)
    row_map: BandMap
    col_map: BandMap
    stats: PartitionStats


def _chunk_stats(a: DirStats, b: DirStats) -> DirStats:
    return DirStats(ell=(a.ell, b.ell),
                    slab_slots=a.slab_slots + b.slab_slots,
                    spill_slots=a.spill_slots + b.spill_slots)


def partition_overlap(grid, nnz_i, nnz_j, vals, nrows: int, ncols: int,
                      right: bool, build, pad_multiple: int = 8,
                      solver: str = "ShardedBlockLanczos", span_attrs=None
                      ) -> OverlapShardedOps:
    """`partition` with each direction's output rows split in two (the
    split a multiple of pad_multiple).  Raises ValueError, naming the
    non-overlap `solver` to use instead, when a band is too small to
    split."""
    with profiling.span("layout.build") as span:
        n_eff, m_eff, row_map, col_map, blk = _block(
            grid, nnz_i, nnz_j, vals, nrows, ncols, right, pad_multiple)
        band, mband = row_map.band, col_map.band
        ha = (mband // 2 // pad_multiple) * pad_multiple
        hb = (band // 2 // pad_multiple) * pad_multiple
        if not (0 < ha < mband and 0 < hb < band):
            raise ValueError(
                "matrix bands too small to chunk for comm/compute overlap; "
                f"use the default {solver}")

        def chunks(out_idx, in_idx, split, out_dim, in_dim):
            a = out_idx < split
            b = ~a
            va, vb = ((None, None) if blk.vals is None
                      else (blk.vals[a], blk.vals[b]))
            return (build(out_idx[a], in_idx[a], va, split, in_dim),
                    build((out_idx[b] - split).astype(np.int32), in_idx[b], vb,
                          out_dim - split, in_dim))

        first_a, first_b = chunks(blk.lo, blk.lk, ha, mband, band)
        second_a, second_b = chunks(blk.lk, blk.lo, hb, band, mband)
        if span_attrs is not None:
            span.set(**span_attrs((first_a, first_b), (second_a, second_b)))
    stats = PartitionStats(
        grid=grid.shape, shard_nnz=blk.shard_nnz,
        row_balanced=not row_map.identity, col_balanced=not col_map.identity,
        first=_chunk_stats(dir_stats(first_a), dir_stats(first_b)),
        second=_chunk_stats(dir_stats(second_a), dir_stats(second_b)))
    with profiling.span("layout.upload"):
        first_a, first_b, second_a, second_b = (
            _to_device(op, grid.device)
            for op in (first_a, first_b, second_a, second_b))
    return OverlapShardedOps(
        grid=grid.shape, band=band, mband=mband, np_rows=band * grid.R,
        mp_rows=mband * grid.C, n_eff=n_eff, m_eff=m_eff, ha=ha, hb=hb,
        first_a=first_a, first_b=first_b, second_a=second_a,
        second_b=second_b, row_map=row_map, col_map=col_map, stats=stats)


def _hybrid_op_maker(f):
    def build(out_idx, in_idx, vals, out_dim, in_dim):
        return spmm.make_hybrid_op(f, out_idx, in_idx, vals, out_dim, in_dim)
    return build


def partition_matrix(f, M, right: bool, grid,
                     pad_multiple: int = 8) -> ShardedOps:
    """This rank's block of the narrow-field matrix (values in [0, p)) in
    the single-device hybrid layout (ops/spmm.py::make_hybrid_op)."""
    return partition(grid, M.i, M.j, np.asarray(M.x), M.nrows, M.ncols,
                     right, _hybrid_op_maker(f), pad_multiple)


def partition_matrix_overlap(f, M, right: bool, grid,
                             pad_multiple: int = 8) -> OverlapShardedOps:
    """`partition_matrix` with each direction split into two row chunks
    (`partition_overlap`)."""
    return partition_overlap(grid, M.i, M.j, np.asarray(M.x), M.nrows,
                             M.ncols, right, _hybrid_op_maker(f), pad_multiple)
