"""The mesh's exact all-reduces over a process group, for the three fields.

The port of the JAX package's parallel/collectives.py (`psum_mod`,
`psum_mod_wide`) and parallel/distributed_gf2.py (`pxor`).  Each is

    pack (a kernel) -> torch.distributed.all_reduce(SUM) -> fold (a kernel)

in place on the partial: the transport (NCCL on the card, gloo on the host)
sums signed int32 or int64, so the payload is chosen from the group's size
R so that no sum can leave its type (csrc/collectives.cu says why each is
exact):

  * `psum_mod` (K1), narrow residues: the int32 partial itself while
    R (p - 1) < 2^31, else widened to int64; the fold writes sum mod p;
  * `psum_mod_wide` (K2), wide residues (int64 holding u64 < p < 2^62): the
    partial itself for R <= 2, else two 31-bit halves; the fold recombines
    hi 2^31 + lo mod p;
  * `pxor` (K3), bit words: L planes of one bit a lane (`pxor_lanes`), the
    top lane negated; the fold keeps each lane's parity.

On CUDA tensors the pack and the fold are the kernels of
csrc/collectives.cu (`fold_mod.launches` and the others count a call once,
where its fold kernel launches); on CPU tensors the `*_plain` versions
beside them, which the CPU tests hold against the JAX package's
collectives.  A group of one rank runs the same three steps: nothing is
skipped.

The sharded solvers call K1 and K2 through `PsumMod` / `PsumModWide`, one
object per workspace tensor, built once: the group, its size, the payload
and the kernels' prepared ctypes arguments (`kernels.bind`) are fixed
there, so that a call is at most a pack launch, `all_reduce` and a fold
launch, with no validation left to repeat.  The module functions do the
same work call by call.
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
# the packed payloads of the CUDA paths, one buffer per (device, dtype,
# shape), kept between calls so that a call allocates nothing (as the
# other wrappers keep their scratch); a call's fold, on the current stream,
# ends its use before the next pack writes the buffer again
_payloads: dict = {}


def _payload(shape, dtype, device) -> torch.Tensor:
    key = (device, dtype, tuple(shape))
    buf = _payloads.get(key)
    if buf is None:
        buf = _payloads[key] = torch.empty(shape, dtype=dtype, device=device)
    return buf


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


def pack_mod(x: torch.Tensor, ranks: int, p: int) -> torch.Tensor:
    """K1's payload: x itself (int32) or its int64 widening, by the
    psum_mod_pack kernel on CUDA tensors."""
    if x.device.type == "cpu" or mod_payload_dtype(ranks, p) == torch.int32:
        return pack_mod_plain(x, ranks, p)
    _check(x, torch.int32, "psum_mod")
    payload = _payload(x.shape, torch.int64, x.device)
    kernels.launch("psum_mod_pack", x.data_ptr(), payload.data_ptr(),
                   x.numel())
    return payload


def fold_mod(sums: torch.Tensor, x: torch.Tensor, p: int) -> None:
    """x <- sums mod p by the psum_mod_fold kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return fold_mod_plain(sums, x, p)
    _check(x, torch.int32, "psum_mod")
    if sums.numel() != x.numel() or not sums.is_contiguous() \
            or sums.dtype not in (torch.int32, torch.int64):
        raise ValueError("psum_mod: sums must be x's int32 or int64 payload")
    kernels.launch("psum_mod_fold", sums.data_ptr(),
                   int(sums.dtype == torch.int64), x.data_ptr(), x.numel(),
                   p, barrett_mu(p))
    if x.numel():       # the entry point launches nothing on no elements
        fold_mod.launches += 1


fold_mod.launches = 0


def psum_mod(x: torch.Tensor, p: int, group=None) -> torch.Tensor:
    """Exact sum mod p of the group's int32 partials (each in [0, p)), in
    place on x, which every rank then holds."""
    payload = pack_mod(x, dist.get_world_size(group), p)
    dist.all_reduce(payload, group=group)
    fold_mod(payload, x, p)
    return x


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


def pack_wide(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """K2's payload, by the psum_mod_wide_pack kernel on CUDA tensors."""
    if x.device.type == "cpu" or not wide_halves(ranks):
        return pack_wide_plain(x, ranks)
    _check(x, torch.int64, "psum_mod_wide")
    payload = _payload((2,) + tuple(x.shape), torch.int64, x.device)
    kernels.launch("psum_mod_wide_pack", x.data_ptr(), payload.data_ptr(),
                   x.numel())
    return payload


def fold_wide(sums: torch.Tensor, x: torch.Tensor, f) -> None:
    """x <- the residues of the summed payload, by the psum_mod_wide_fold
    kernel on CUDA tensors (f: ops.gfp_wide.GFpWide)."""
    if x.device.type == "cpu":
        return fold_wide_plain(sums, x, f.p)
    _check(x, torch.int64, "psum_mod_wide")
    halves = sums.numel() == 2 * x.numel() and x.numel() > 0
    if not (sums.numel() == x.numel() or halves) or not sums.is_contiguous() \
            or sums.dtype != torch.int64:
        raise ValueError("psum_mod_wide: sums must be x's int64 payload")
    kernels.launch("psum_mod_wide_fold", sums.data_ptr(), int(halves),
                   x.data_ptr(), x.numel(), *f.kernel_args)
    if x.numel():
        fold_wide.launches += 1


fold_wide.launches = 0


def psum_mod_wide(x: torch.Tensor, f, group=None) -> torch.Tensor:
    """Exact sum mod p of the group's int64 partials (residues in [0, p),
    p < 2^62), in place on x, which every rank then holds."""
    payload = pack_wide(x, dist.get_world_size(group))
    dist.all_reduce(payload, group=group)
    fold_wide(payload, x, f)
    return x


# ---------------------------------------------------------------------------
# K1 and K2 bound to one tensor
# ---------------------------------------------------------------------------

class _BoundSum:
    """An exact all-reduce bound to one tensor x (a solver's workspace
    block): `ranks` (default the group's size) fixes the payload; on CUDA
    the payload buffer and the pack and fold launches are prepared here
    (x must then stay the tensor they point to), on the CPU every call runs
    the plain versions on the tensor it is given.  A call is pack,
    all_reduce over the group, fold, in place on x."""

    def __init__(self, x: torch.Tensor, group, ranks):
        self.group = group
        self.ranks = (dist.get_world_size(group) if ranks is None
                      else int(ranks))
        self.x = x
        self._pack = self._fold = None
        # the collective's count, kept by its fold (a fold of nothing
        # launches nothing and counts nothing)
        self._counter = _WRAPPERS[self.name]
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
        self._counter.launches += self._count

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        payload = self.pack(x)
        dist.all_reduce(payload, group=self.group)
        self.fold(payload, x)
        return x


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


# ---------------------------------------------------------------------------
# K3: XOR of bit words
# ---------------------------------------------------------------------------

def spread_xor_plain(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """Plain version of K3's spread: (L,) + x.shape int32 planes, plane k
    the lower lanes of x >> k minus its top lane."""
    lanes = pxor_lanes(ranks)
    mask = lane_mask(lanes)
    top = 1 << (32 - lanes) if lanes < 32 else 0
    ks = torch.arange(lanes, dtype=torch.int32, device=x.device)
    # >> on int32 is arithmetic: the mask drops the sign's copies (they land
    # above bit 31 - k >= 32 - L, where no lane of the mask is)
    v = (x[None] >> ks.view((lanes,) + (1,) * x.dim())) & mask
    return (v & (mask & ~top)) - (v & top)


def fold_xor_plain(sums: torch.Tensor, x: torch.Tensor) -> None:
    """Plain version of K3's fold: each lane's low bit, back in place."""
    lanes = sums.shape[0]
    mask = lane_mask(lanes)
    s = sums.to(torch.int64) & mask            # the 32-bit pattern's lanes
    ks = torch.arange(lanes, dtype=torch.int64, device=x.device)
    w = (s << ks.view((lanes,) + (1,) * x.dim())).sum(0)   # < 2^32
    x.copy_((w - ((w >> 31) << 32)).view(x.shape).to(torch.int32))


def spread_xor(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """K3's payload, by the pxor_spread kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return spread_xor_plain(x, ranks)
    _check(x, torch.int32, "pxor")
    lanes = pxor_lanes(ranks)
    payload = _payload((lanes,) + tuple(x.shape), torch.int32, x.device)
    kernels.launch("pxor_spread", x.data_ptr(), payload.data_ptr(),
                   x.numel(), lanes)
    return payload


def fold_xor(sums: torch.Tensor, x: torch.Tensor) -> None:
    """x <- the XOR the summed planes hold, by the pxor_fold kernel on
    CUDA tensors."""
    if x.device.type == "cpu":
        return fold_xor_plain(sums, x)
    _check(x, torch.int32, "pxor")
    lanes = sums.shape[0] if sums.dim() else 0
    if lanes not in (2, 4, 8, 16, 32) or sums.numel() != lanes * x.numel() \
            or sums.dtype != torch.int32 or not sums.is_contiguous():
        raise ValueError("pxor: sums must be x's (L,) + x.shape int32 planes")
    kernels.launch("pxor_fold", sums.data_ptr(), x.data_ptr(), x.numel(),
                   lanes)
    if x.numel():
        fold_xor.launches += 1


fold_xor.launches = 0


def pxor(x: torch.Tensor, group=None) -> torch.Tensor:
    """Exact XOR of the group's int32 bit words, in place on x, which every
    rank then holds."""
    payload = spread_xor(x, dist.get_world_size(group))
    dist.all_reduce(payload, group=group)
    fold_xor(payload, x)
    return x


# each collective's count, kept by its fold (one launch a call)
_WRAPPERS = {"psum_mod": fold_mod, "psum_mod_wide": fold_wide,
             "pxor": fold_xor}


def launch_counts() -> dict:
    """{kernel name: launches} of the three collectives."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0
