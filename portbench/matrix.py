"""The configuration's matrix, made from the seed on the device.

Each of nrows rows draws `row_draws` columns uniformly from [0, ncols);
repeated (row, column) pairs are merged (torch.unique over row * ncols +
column), and each remaining entry takes a value uniform in
[value_low, value_high), reduced mod the prime.  The draws come from one
torch.Generator on the device seeded with --seed, in three large calls, so
the same seed gives the same matrix on the same card.  The host COO that
comes back is what both the program and the reference are given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Coo:
    nrows: int
    ncols: int
    i: np.ndarray      # int32, sorted by row, then column
    j: np.ndarray      # int32
    x: np.ndarray      # uint32 (uint64 for p >= 2^32), reduced mod p
    prime: int

    @property
    def nnz(self) -> int:
        return len(self.x)


def generate(config: dict, seed: int, device) -> Coo:
    nrows, ncols = int(config["nrows"]), int(config["ncols"])
    draws, p = int(config["row_draws"]), int(config["prime"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    cols = torch.randint(0, ncols, (nrows * draws,), generator=g,
                         device=device, dtype=torch.int64)
    rows = torch.arange(nrows, device=device,
                        dtype=torch.int64).repeat_interleave(draws)
    key = torch.unique(rows * ncols + cols)           # sorted
    del rows, cols
    vals = torch.randint(int(config["value_low"]), int(config["value_high"]),
                         (key.numel(),), generator=g, device=device,
                         dtype=torch.int64) % p
    dtype = np.uint64 if p >= 1 << 32 else np.uint32
    return Coo(nrows=nrows, ncols=ncols,
               i=(key // ncols).to(torch.int32).cpu().numpy(),
               j=(key % ncols).to(torch.int32).cpu().numpy(),
               x=vals.cpu().numpy().astype(dtype), prime=p)
