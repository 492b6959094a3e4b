"""The mesh's exact all-reduces over a process group, for the three fields.

The port of the JAX package's parallel/collectives.py (`psum_mod`,
`psum_mod_wide`) and parallel/distributed_gf2.py (`pxor`).  Each is

    pack (a kernel) -> torch.distributed.all_reduce(SUM) -> fold (a kernel)

in place on the partial: the transport (NCCL on the card, gloo on the host)
sums signed int32 or int64, so the payload is chosen from the group's size
R so that no sum can leave its type (csrc/collectives.cu says why each is
exact):

  * `PsumMod` (K1, `psum_mod`), narrow residues: the int32 partial itself
    while R (p - 1) < 2^31, else widened to int64; the fold writes sum mod
    p;
  * `PsumModWide` (K2, `psum_mod_wide`), wide residues (int64 holding u64 <
    p < 2^62): the partial itself for R <= 2, else two 31-bit halves; the
    fold recombines hi 2^31 + lo mod p;
  * `Pxor` (K3, `pxor`), bit words: L planes of one bit a lane
    (`pxor_lanes`), the top lane negated, each plane `plane_stride(n)` words
    (n rounded up to 4, the padding zeros); the fold keeps each lane's
    parity.

Each is an object bound to one tensor (a sharded solver builds one per
workspace block, once): the group, its size (so the payload), the payload
buffer and, on CUDA, the kernels' prepared ctypes arguments
(`kernels.bind`) are fixed there, so that a call is at most a pack launch,
`all_reduce` and a fold launch, with no validation left to repeat; the
overlap step splits a call at its `all_reduce` (`start`, `finish`).  On
CUDA tensors the pack and the fold are the kernels of csrc/collectives.cu
(`launch_counts()` counts a call once, where its fold kernel launches); on
CPU tensors the `*_plain` versions beside them, which the CPU tests hold
against the JAX package's collectives.  A group of one rank runs the same
three steps: nothing is skipped.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops import gfp_wide as gw
from block_lanczos_tpu_torch.ops.gfp import barrett_mu

_HALF_BITS = 31
_HALF_MASK = (1 << _HALF_BITS) - 1
INT32_MAX = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Payloads
# ---------------------------------------------------------------------------

def mod_payload_dtype(ranks: int, p: int) -> torch.dtype:
    """K1's payload: int32 while the sum of `ranks` residues fits it."""
    return torch.int32 if ranks * (p - 1) <= INT32_MAX else torch.int64


def wide_halves(ranks: int) -> bool:
    """K2 sends two 31-bit halves when int64 cannot hold `ranks` residues
    below 2^62 (R (p - 1) < 2^63 only for R <= 2)."""
    return ranks > 2


def pxor_lanes(ranks: int) -> int:
    """K3's lane width: the narrowest L whose lane sums stay in int32 with
    the top lane negated (R <= 2^(L-1)); one bit a plane (L = 32) above
    32768 ranks."""
    for lanes in (2, 4, 8, 16):
        if ranks <= 1 << (lanes - 1):
            return lanes
    if ranks > INT32_MAX:
        raise ValueError(f"pxor takes at most 2^31 - 1 ranks (got {ranks})")
    return 32


def lane_mask(lanes: int) -> int:
    return sum(1 << b for b in range(0, 32, lanes))


def plane_stride(n: int) -> int:
    """Words between two of K3's planes for n words: n rounded up to 4, so
    that every plane starts on a 16-byte boundary where the payload does
    (the kernels' 16-byte path); the padding words are zeros."""
    return (n + 3) & ~3


def _check(x: torch.Tensor, dtype: torch.dtype, name: str):
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous {dtype} tensor "
                         f"(got {x.dtype})")


# ---------------------------------------------------------------------------
# K1: narrow residues
# ---------------------------------------------------------------------------

def pack_mod_plain(x: torch.Tensor, ranks: int, p: int) -> torch.Tensor:
    """Plain version of K1's pack: the payload for `ranks` ranks (x itself
    when it is int32)."""
    if mod_payload_dtype(ranks, p) == torch.int32:
        return x
    return x.to(torch.int64)


def fold_mod_plain(sums: torch.Tensor, x: torch.Tensor, p: int) -> None:
    """Plain version of K1's fold: x <- sums mod p (sums >= 0)."""
    x.copy_(torch.remainder(sums.view(x.shape), p))


# ---------------------------------------------------------------------------
# K2: wide residues
# ---------------------------------------------------------------------------

def pack_wide_plain(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """Plain version of K2's pack: x itself, or (2,) + x.shape halves."""
    if not wide_halves(ranks):
        return x
    return torch.stack([x & _HALF_MASK, x >> _HALF_BITS])


def fold_wide_plain(sums: torch.Tensor, x: torch.Tensor, p: int) -> None:
    """Plain version of K2's fold: x <- (hi 2^31 + lo) mod p, or sums mod
    p (sums < 2^63)."""
    if sums.numel() == x.numel():
        x.copy_(torch.remainder(sums.view(x.shape), p))
        return
    lo, hi = sums.view((2,) + tuple(x.shape))
    h = gw.shl_mod(p, torch.remainder(hi, p), _HALF_BITS)
    x.copy_(gw.modadd(p, h, torch.remainder(lo, p)))


# ---------------------------------------------------------------------------
# K3: XOR of bit words
# ---------------------------------------------------------------------------

def spread_xor_plain(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """Plain version of K3's spread: (L, plane_stride(n)) int32 planes of
    x's n words, plane k the lower lanes of x >> k minus its top lane, the
    padding zeros."""
    lanes = pxor_lanes(ranks)
    mask = lane_mask(lanes)
    top = 1 << (32 - lanes) if lanes < 32 else 0
    n = x.numel()
    ks = torch.arange(lanes, dtype=torch.int32, device=x.device)
    # >> on int32 is arithmetic: the mask drops the sign's copies (they land
    # above bit 31 - k >= 32 - L, where no lane of the mask is)
    v = (x.reshape(1, n) >> ks.view(lanes, 1)) & mask
    planes = torch.zeros((lanes, plane_stride(n)), dtype=torch.int32,
                         device=x.device)
    planes[:, :n] = (v & (mask & ~top)) - (v & top)
    return planes


def fold_xor_plain(sums: torch.Tensor, x: torch.Tensor) -> None:
    """Plain version of K3's fold: each lane's low bit of the summed
    (L, plane_stride(n)) planes, back in place in x's n words."""
    lanes, n = sums.shape[0], x.numel()
    mask = lane_mask(lanes)
    s = sums[:, :n].to(torch.int64) & mask     # the 32-bit pattern's lanes
    ks = torch.arange(lanes, dtype=torch.int64, device=x.device)
    w = (s << ks.view(lanes, 1)).sum(0)        # < 2^32
    x.copy_((w - ((w >> 31) << 32)).view(x.shape).to(torch.int32))


# ---------------------------------------------------------------------------
# The collectives bound to one tensor
# ---------------------------------------------------------------------------

class _BoundSum:
    """An exact all-reduce bound to one tensor x (a solver's workspace
    block): `ranks` (default the group's size) fixes the payload; on CUDA
    the payload buffer and the pack and fold launches are prepared here
    (x must then stay the tensor they point to), on the CPU every call runs
    the plain versions on the tensor it is given.  A call is pack,
    all_reduce over the group, fold, in place on x; `start` and `finish`
    split it at the all_reduce, which is then in flight between them."""

    def __init__(self, x: torch.Tensor, group, ranks):
        self.group = group
        self.ranks = (dist.get_world_size(group) if ranks is None
                      else int(ranks))
        self.x = x
        self._pack = self._fold = None
        self._pending = None      # (x, payload, work) between start, finish
        # a fold of nothing launches nothing and counts nothing
        self._count = int(x.numel() > 0)

    def _not_bound(self, what: str):
        return ValueError(f"{self.name}: {what} is not the bound tensor")

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """The payload of x to sum over the group."""
        if self._fold is None:
            return self._pack_plain(x)
        if x is not self.x:
            raise self._not_bound("x")
        if self._pack is not None:
            self._pack()
        return self.payload

    def fold(self, sums: torch.Tensor, x: torch.Tensor) -> None:
        """x <- the residues of the summed payload."""
        if self._fold is None:
            return self._fold_plain(sums, x)
        if x is not self.x or sums is not self.payload:
            raise self._not_bound("x or sums")
        self._fold()
        _launches[self.name] += self._count

    def start(self, x: torch.Tensor) -> None:
        """Pack x and issue the all_reduce of its payload without waiting
        for it (`finish` waits and folds): the overlap step's other work
        runs meanwhile.  One call of a bound form is in flight at a time;
        its payload is its own, so two bound forms' calls may be."""
        if self._pending is not None:
            raise RuntimeError(f"{self.name}: a call is already in flight")
        payload = self.pack(x)
        work = dist.all_reduce(payload, group=self.group, async_op=True)
        self._pending = (x, payload, work)

    def finish(self) -> torch.Tensor:
        """Wait for the all_reduce that `start` issued (on CUDA: the
        current stream waits for it, the host does not) and fold it into
        its x, which is returned."""
        x, payload, work = self._pending
        self._pending = None
        work.wait()
        self.fold(payload, x)
        return x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.start(x)
        return self.finish()


class PsumMod(_BoundSum):
    """`psum_mod` (K1) bound to an int32 tensor x at the prime p."""

    name = "psum_mod"

    def __init__(self, x: torch.Tensor, p: int, group=None, ranks=None):
        super().__init__(x, group, ranks)
        self.p = int(p)
        if x.device.type == "cpu":
            return
        _check(x, torch.int32, self.name)
        int64 = mod_payload_dtype(self.ranks, self.p) == torch.int64
        self.payload = (torch.empty(x.shape, dtype=torch.int64,
                                    device=x.device) if int64 else x)
        n = x.numel()
        if int64:
            self._pack = kernels.bind("psum_mod_pack", x.data_ptr(),
                                      self.payload.data_ptr(), n)
        self._fold = kernels.bind("psum_mod_fold", self.payload.data_ptr(),
                                  int(int64), x.data_ptr(), n, self.p,
                                  barrett_mu(self.p))

    def _pack_plain(self, x):
        return pack_mod_plain(x, self.ranks, self.p)

    def _fold_plain(self, sums, x):
        fold_mod_plain(sums, x, self.p)


class PsumModWide(_BoundSum):
    """`psum_mod_wide` (K2) bound to an int64 tensor x of the field f
    (ops.gfp_wide.GFpWide)."""

    name = "psum_mod_wide"

    def __init__(self, x: torch.Tensor, f, group=None, ranks=None):
        super().__init__(x, group, ranks)
        self.p = f.p
        if x.device.type == "cpu":
            return
        _check(x, torch.int64, self.name)
        halves = wide_halves(self.ranks)
        self.payload = (torch.empty((2,) + tuple(x.shape), dtype=torch.int64,
                                    device=x.device) if halves else x)
        n = x.numel()
        if halves:
            self._pack = kernels.bind("psum_mod_wide_pack", x.data_ptr(),
                                      self.payload.data_ptr(), n)
        self._fold = kernels.bind("psum_mod_wide_fold",
                                  self.payload.data_ptr(),
                                  int(halves and n > 0), x.data_ptr(), n,
                                  *f.kernel_args)

    def _pack_plain(self, x):
        return pack_wide_plain(x, self.ranks)

    def _fold_plain(self, sums, x):
        fold_wide_plain(sums, x, self.p)


class Pxor(_BoundSum):
    """`pxor` (K3) bound to an int32 tensor x of bit words: the lane width
    from `ranks`, the zeroed (L, plane_stride(n)) payload and the spread
    and fold launches fixed once."""

    name = "pxor"

    def __init__(self, x: torch.Tensor, group=None, ranks=None):
        super().__init__(x, group, ranks)
        if x.device.type == "cpu":
            return
        _check(x, torch.int32, self.name)
        n, lanes = x.numel(), pxor_lanes(self.ranks)
        self.payload = torch.zeros((lanes, plane_stride(n)),
                                   dtype=torch.int32, device=x.device)
        self._pack = kernels.bind("pxor_spread", x.data_ptr(),
                                  self.payload.data_ptr(), n, lanes)
        self._fold = kernels.bind("pxor_fold", self.payload.data_ptr(),
                                  x.data_ptr(), n, lanes)

    def _pack_plain(self, x):
        return spread_xor_plain(x, self.ranks)

    def _fold_plain(self, sums, x):
        fold_xor_plain(sums, x)


# each collective's count, kept by its bound forms' folds (one launch a call)
_launches = dict.fromkeys(("psum_mod", "psum_mod_wide", "pxor"), 0)


def launch_counts() -> dict:
    """{kernel name: launches} of the three collectives."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
