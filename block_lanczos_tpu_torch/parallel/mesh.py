"""The (rows, cols) process grid of the mesh solvers.

The port of the JAX package's parallel/mesh.py (`make_mesh`,
`make_mesh_grid`, `balanced_grid`; axes "rows" and "cols") on
torch.distributed: a `Grid` is this rank's place (r, c) in an R x C grid of
ranks, rank r * C + c of the ranks it spans, and two process groups:

  * `rows_group`, the R ranks of column c (r varies): the "rows" axis, over
    which the kernel dimension N_eff (v, Av, p and the matrix's N-bands) is
    split and the Mt*v partials and the Grams are summed;
  * `cols_group`, the C ranks of row r: the "cols" axis, over which the
    other dimension M_eff (tmp, the matrix's M-bands) is split and the
    M*tmp partials are summed.

C == 1 is pure row sharding (the cols sum runs over one rank).  Every rank
of the world must build every grid, in the same order, because
`torch.distributed.new_group` is collective over the world, also for the
ranks a group leaves out.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from block_lanczos_tpu_torch.models.lanczos import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in an R x C grid of ranks and its two groups."""
    R: int
    C: int
    r: int
    c: int
    rows_group: object   # torch.distributed ProcessGroup
    cols_group: object
    group: object        # all R * C ranks
    device: torch.device
    root: int = 0        # the global rank of (0, 0)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.R, self.C)

    @property
    def size(self) -> int:
        return self.R * self.C

    @property
    def is_root(self) -> bool:
        return self.r == 0 and self.c == 0


def _group(ranks: list, made: dict):
    """The process group of `ranks`: the world itself when they are all of
    it, one made before for the same ranks, else a new group, which every
    rank of the world creates."""
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    key = tuple(ranks)
    if key not in made:
        made[key] = dist.new_group(ranks)
    return made[key]


def rank_device(device=None) -> torch.device:
    """Where this rank's blocks live: CUDA unless the caller asks for the
    CPU, raising when CUDA is absent (models.lanczos.resolve_device).  An
    index-less CUDA device is this rank's current card, which
    multihost.init_distributed sets to the rank's own on NCCL."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_grid(R: int, C: int, device=None, ranks=None) -> Grid | None:
    """The R x C grid over `ranks` (default: the whole world, which must
    then hold R * C ranks), in row-major order.  Every rank of the world
    calls it; the ranks outside the grid get None.  `device` is where this
    rank's blocks live (`rank_device`: CUDA by default; only an explicit
    "cpu" gives CPU blocks).  `ranks` lets one world hold several grids
    side by side, as the mesh tests do to run a dozen grids in one world
    of 8 ranks rather than spawn a world, seconds of start-up, for each."""
    device = rank_device(device)
    if R < 1 or C < 1:
        raise ValueError(f"grid {R} x {C}: both sides must be >= 1")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(k) for k in ranks]
    if len(ranks) != R * C or len(set(ranks)) != len(ranks) \
            or not all(0 <= k < world for k in ranks):
        raise ValueError(f"a {R} x {C} grid needs {R * C} distinct ranks of "
                         f"the world's {world} (got {ranks})")
    made = {}
    rows_groups = [_group([ranks[r * C + c] for r in range(R)], made)
                   for c in range(C)]
    cols_groups = [_group([ranks[r * C + c] for c in range(C)], made)
                   for r in range(R)]
    group = _group(ranks, made)
    me = dist.get_rank()
    if me not in ranks:
        return None
    r, c = divmod(ranks.index(me), C)
    return Grid(R=R, C=C, r=r, c=c, rows_group=rows_groups[c],
                cols_group=cols_groups[r], group=group, device=device,
                root=ranks[0])


def make_mesh(device=None) -> Grid:
    """The rows-only grid (world size, 1) over the whole world, its blocks
    on `device` (`rank_device`: CUDA by default)."""
    return make_grid(dist.get_world_size(), 1, device)


def balanced_grid(n_devices: int) -> tuple[int, int]:
    """MPI_Dims_create-style near-square factorization (rows >= cols)."""
    best = (n_devices, 1)
    c = 1
    while c * c <= n_devices:
        if n_devices % c == 0:
            best = (n_devices // c, c)
        c += 1
    return best
