"""Joining a world of ranks, and moving whole blocks in and out of the grid.

The port of the JAX package's parallel/multihost.py on torch.distributed.
The reference scales across nodes with an mpiexec-launched grid whose root
scatters the matrix (mpi/lanczos_modp.c:505-566); here, as in the JAX
package, there is no root: every rank loads the matrix, builds only its own
block, and draws the same xoshiro v0, keeping its band of it, so nothing is
scattered.  The only whole-block traffic is the final gather.

  * `init_distributed`: `torch.distributed.init_process_group` from an
    init method (tcp://HOST:PORT or file://PATH), with an explicit timeout
    that bounds every collective, so that a rank that dies cannot leave the
    others waiting for ever;
  * `put_global`: this rank's band of a block that every rank holds whole;
  * `fetch_global`: the whole block on every rank, an all_gather of equal
    bands over the axis that splits it (through the host on a gloo group:
    gloo gathers no CUDA tensors);
  * `is_root`, `process_count` and `barrier`, the JAX module's helpers
    that checkpoints need (utils/checkpoint.py): rank 0 of the world and
    the world's size (a process without a world is its own root, a world
    of 1), and a barrier over a group.  A solver's root is its grid's
    (mesh.Grid.is_root); on a mesh the ranks are processes of their own
    even on one host, so every mesh of more than one rank is
    "multi-process" here, where the JAX package counts hosts.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None) -> None:
    """Join the world: `rank` of `world_size`, meeting at `init_method`.
    backend "nccl" needs `device`, this rank's CUDA device."""
    if backend == "nccl":
        if device is None:
            raise ValueError("the nccl backend needs this rank's device")
        device = torch.device(device)
        torch.cuda.set_device(device if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def put_global(block: np.ndarray, part: int, parts: int,
               device) -> torch.Tensor:
    """Band `part` of `parts` equal bands of a (padded, ...) block that
    every rank holds whole, as a tensor on `device`."""
    band = block.shape[0] // parts
    if band * parts != block.shape[0]:
        raise ValueError(f"{block.shape[0]} rows are not {parts} equal bands")
    return torch.from_numpy(
        np.ascontiguousarray(block[part * band:(part + 1) * band])
    ).to(device)


def fetch_global(local: torch.Tensor, group) -> np.ndarray:
    """The (parts * band, ...) block whose band this rank holds, on every
    rank of `group` (the axis that splits it), in band order."""
    if dist.get_backend(group) == "gloo":
        local = local.cpu()
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts).cpu().numpy()


def process_count() -> int:
    """The ranks of the world; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_root() -> bool:
    """Whether this process is rank 0 of the world (or has no world)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def group_device(group=None) -> torch.device:
    """Where a collective's tensor lives on `group`: this rank's current
    CUDA device on NCCL, the CPU on gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    """Return once every rank of `group` (default the world) has called
    it: a one-element all_reduce, read back on the host."""
    t = torch.ones(1, dtype=torch.int32, device=group_device(group))
    dist.all_reduce(t, group=group)
    t.item()
