"""Dense mod-p block products: the fused Gram kernel and small products.

`gram_mod(V1, V2, W)` computes [V1 | V2]^T * W mod p without materialising
the concatenation (the solver's [v | Av]^T * Av, models/lanczos.py:137 of
the JAX package).  It wraps the `gram_mod` CUDA kernel (csrc/gram_mod.cu),
the port of the Pallas kernel ops/pallas_gram.py::gram_mod_pallas and of
its XLA twin ops/dense.py::gram_mod; `gram_mod_plain` is its plain
PyTorch version, which the wrapper takes for CPU tensors only.  The kernel
is one launch: its CTAs add their partials into a u64 scratch that the
wrapper allocates (zeroed) once per device and that the kernel leaves
zeroed again, so a call allocates nothing unless `out` is omitted.
Calls that share a device must run on one stream (they share the scratch).

`matmul_mod` is plain PyTorch, for the n x n products of the tests and the
plain paths.  All inputs are residues in [0, p); every product is formed in
int64 and reduced before it is summed.
"""

from __future__ import annotations

import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops.gfp import barrett_mu

GRAM_MAX_A, GRAM_MAX_B = 128, 64  # csrc/gram_mod.cu GRAM_MAX_A, GRAM_MAX_B
GRAM_MMA_MIN_N = 8  # csrc/gram_mod.cu: b >= it runs on the tensor cores
# u64 words of the kernel's scratch: the (a, b) sums, then its ticket
_GRAM_SCRATCH = GRAM_MAX_A * GRAM_MAX_B + 1
_scratch: dict = {}


def matmul_mod(X: torch.Tensor, B: torch.Tensor, p: int) -> torch.Tensor:
    """(N, k) @ (k, m) mod p with small k, m; int32 result."""
    Xl, Bl = X.to(torch.int64), B.to(torch.int64)
    acc = torch.zeros((X.shape[0], B.shape[1]), dtype=torch.int64,
                      device=X.device)
    for k in range(X.shape[1]):  # one reduced product per step: exact
        acc += Xl[:, k:k + 1] * Bl[k] % p
    return (acc % p).to(torch.int32)


def _lhs_columns(V1, V2):
    cols = [V1[:, i] for i in range(V1.shape[1])]
    if V2 is not None:
        cols += [V2[:, i] for i in range(V2.shape[1])]
    return cols


def gram_mod_plain(V1: torch.Tensor, V2: torch.Tensor | None,
                   W: torch.Tensor, p: int) -> torch.Tensor:
    """Plain PyTorch version of the gram_mod kernel; (a, b) int32."""
    Wl = W.to(torch.int64)
    rows = [(col.to(torch.int64)[:, None] * Wl % p).sum(0) % p
            for col in _lhs_columns(V1, V2)]
    return torch.stack(rows).to(torch.int32)


def gram_mod(V1: torch.Tensor, V2: torch.Tensor | None, W: torch.Tensor,
             p: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """[V1 | V2]^T @ W mod p for (N, n1), (N, n2), (N, b) blocks; V2 may
    be None.  CUDA tensors launch the gram_mod kernel; CPU tensors take
    gram_mod_plain.  `out` (CUDA only) is an optional (a, b) buffer."""
    N = W.shape[0]
    blocks = [V1, W] if V2 is None else [V1, V2, W]
    if any(t.dim() != 2 or t.shape[0] != N for t in blocks):
        raise ValueError("gram_mod needs 2-D blocks with equal row counts")
    if W.device.type == "cpu":
        return gram_mod_plain(V1, V2, W, p)
    n1, b = V1.shape[1], W.shape[1]
    n2 = 0 if V2 is None else V2.shape[1]
    a = n1 + n2
    if not (1 <= n1 and a <= GRAM_MAX_A and 1 <= b <= GRAM_MAX_B):
        raise ValueError(f"gram_mod supports a <= {GRAM_MAX_A} and "
                         f"b <= {GRAM_MAX_B} (got a = {a}, b = {b})")
    if out is None:
        out = torch.empty((a, b), dtype=torch.int32, device=W.device)
    elif out.shape != (a, b):
        raise ValueError(f"out must be ({a}, {b})")
    kernels.check_operands("gram_mod", *blocks, out)
    scratch = _scratch.get(W.device)
    if scratch is None:
        scratch = _scratch[W.device] = torch.zeros(
            _GRAM_SCRATCH, dtype=torch.int64, device=W.device)
    kernels.launch("gram_mod", V1.data_ptr(), n1,
                   0 if V2 is None else V2.data_ptr(), n2, W.data_ptr(), b,
                   N, p, barrett_mu(p), scratch.data_ptr(), out.data_ptr())
    gram_mod.launches += 1
    return out


gram_mod.launches = 0
