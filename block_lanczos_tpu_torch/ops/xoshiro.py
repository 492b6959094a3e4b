"""v0 drawn on the card: the wrapper of csrc/xoshiro_fill.cu and its NumPy
mirror.

On a CUDA device the single-device solvers draw their initial block here
instead of in utils/rng.py's NumPy generators: the same xoshiro256+
stream in the same lanes (`rng.lane_plan`), each lane's start state built
on the card from the jump matrices T^(m 2^k) that the host computes once a
solver (`rng.jump_columns`), and the generator's state advanced on the
host by T^count, so the next draw, on either path, goes on where this one
ended.  The epilogue is the solver's field's: GF(2) packs the draws' low
bits 32 a word, the narrow and wide fields write random64 % p as int32 or
int64.  `xoshiro_fill_np` is the kernel in NumPy, on its arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops.gfp import barrett_mu, barrett_reduce_np
from block_lanczos_tpu_torch.utils import profiling, rng

# the kernel's epilogue by the solver's field (XF_GF2, XF_NARROW, XF_WIDE)
FIELD_CODES = {"gf2": 0, "narrow": 1, "wide": 2}


def xoshiro_fill(jumps: torch.Tensor, args: tuple, out: torch.Tensor
                 ) -> None:
    """Launch the kernel: `jumps` the (levels, 256, 4) matrices on the
    device, `args` LaneDraw.args, `out` the zeroed block it writes."""
    kernels.check_operands("xoshiro_fill", out, dtype=out.dtype)
    kernels.launch("xoshiro_fill", jumps.data_ptr(), *args, out.data_ptr())
    xoshiro_fill.launches += 1


xoshiro_fill.launches = 0


class LaneDraw:
    """The draw of a solver's v0, `count` values of the stream, on the
    card: its lane schedule (`rng.lane_plan`), the jump matrices on
    `device`, and T^count, by which the host advances the generator after
    each draw.  All fixed for a solver, so it builds one at construction."""

    def __init__(self, count: int, device):
        self.count = int(count)
        self.m, self.lanes = rng.lane_plan(self.count)
        self.levels = (self.lanes - 1).bit_length()
        self.jumps = rng.jump_columns(self.m, self.levels)
        self.device = torch.device(device)
        self.jumps_dev = torch.from_numpy(
            self.jumps.view(np.int64)).to(self.device)
        self._advance = rng._step_power(self.count)

    def args(self, state, field: str, prime: int) -> tuple:
        """The kernel's arguments between `jumps` and `out` for a draw
        from `state` in `field`'s form."""
        return (self.levels, *(int(s) for s in state), self.count, self.m,
                FIELD_CODES[field], int(prime), barrett_mu(int(prime)))

    def state_after(self, state) -> list:
        """The state `count` steps after `state`: T^count applied."""
        bits = (self._advance @ rng._state_bits(state)) % 2
        return [int(rng._bits_to_u64(bits[64 * w:64 * w + 64, None])[0])
                for w in range(4)]

    def block(self, gen: rng.Xoshiro256Plus, field: str, prime: int,
              shape) -> torch.Tensor:
        """A zeroed (rows, cols) block on the device (int64 in the wide
        field, else int32) whose first `count` values, row-major, are the
        next `count` of gen's stream mod `prime` (over GF(2): its bits,
        packed, 32 a word); gen then holds the state after them.  No sync
        and no download: the state goes up as the launch's arguments."""
        out = torch.zeros(shape, device=self.device, dtype=torch.int64
                          if field == "wide" else torch.int32)
        if out.numel() * (32 if field == "gf2" else 1) < self.count:
            raise ValueError(f"a block of {tuple(shape)} cannot hold "
                             f"{self.count} draws")
        xoshiro_fill(self.jumps_dev, self.args(gen.state, field, prime), out)
        gen.state = self.state_after(gen.state)
        profiling.count("v0_draws_device")
        return out


def xoshiro_fill_np(jumps, levels, s0, s1, s2, s3, count, m, field, p, mu,
                    out: np.ndarray) -> None:
    """csrc/xoshiro_fill.cu in NumPy, on the kernel's arguments
    (`LaneDraw.args`): the lanes of `rng.draw_lanes` from `jumps`, then the
    field's epilogue into the flat `out`'s first values (field 0: bit i of
    the stream as bit i % 32 of word i / 32)."""
    flat, _ = rng.draw_lanes((s0, s1, s2, s3), jumps[:levels], count, m,
                             lambda x: x, np.uint64)
    if field == FIELD_CODES["gf2"]:
        bits = np.zeros(-(-count // 32) * 32, np.uint64)
        bits[:count] = flat & np.uint64(1)
        words = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)
                 ).sum(axis=1, dtype=np.uint64).astype(np.uint32)
        out[:len(words)] = words.view(out.dtype)
    else:
        assert mu == barrett_mu(p)
        out[:count] = barrett_reduce_np(flat, p).astype(out.dtype)
