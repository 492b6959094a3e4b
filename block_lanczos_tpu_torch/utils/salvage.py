"""Salvage kernel vectors from a partially-converged Lanczos block (the
port's own copy of the JAX package's utils/salvage.py; both fields).

Block Lanczos can terminate with `v^T M != 0` — over GF(2) especially,
where self-orthogonality makes partial convergence common.  The reference
just prints "KO" and gives up (sequential/lanczos_modp.c:560-582).  But the
final block usually still CONTAINS kernel vectors: any combination
`c in F_p^n` with `(v^T M) c = 0` gives `(v c)^T M = c^T (v^T M)^T = 0`,
i.e. `v @ C` is a block of true kernel vectors for any nullspace basis C
of the (m x n) matrix `vtM`.

Finding that nullspace exactly without reducing all m rows: sample a few
rows, take the nullspace of the small sample (superset of the true
nullspace), verify candidates against the FULL vtM exactly, and fold any
violating rows back into the sample until all candidates verify — each
round strictly shrinks the candidate space, so it terminates in <= n
rounds.

All arithmetic is exact host NumPy: products of residues < 2^30 split the
coefficient into 15-bit limbs so u64 accumulation over n <= 128 terms
cannot overflow; wide residues use Python ints.
"""

from __future__ import annotations

import numpy as np


def _nullspace_small(p: int, R: np.ndarray) -> np.ndarray:
    """Exact nullspace basis of a small (k x n) matrix mod p -> (n, dim)."""
    R = R.astype(object) % p
    k, n = R.shape
    R = R.copy()
    pivots = []  # (row, col)
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, k):
            if R[r, col] % p != 0:
                piv = r
                break
        if piv is None:
            continue
        R[[row, piv]] = R[[piv, row]]
        inv = pow(int(R[row, col]), p - 2, p)
        R[row] = (R[row] * inv) % p
        for r in range(k):
            if r != row and R[r, col] % p != 0:
                R[r] = (R[r] - R[r, col] * R[row]) % p
        pivots.append((row, col))
        row += 1
        if row == k:
            break
    pivot_cols = {c for _, c in pivots}
    free_cols = [c for c in range(n) if c not in pivot_cols]
    basis = np.zeros((n, len(free_cols)), dtype=object)
    for bi, fc in enumerate(free_cols):
        basis[fc, bi] = 1
        for (r, c) in pivots:
            basis[c, bi] = (-R[r, fc]) % p
    return basis


def _matmul_exact(p: int, A: np.ndarray, C: np.ndarray) -> np.ndarray:
    """(m, n) @ (n, k) mod p, exact.  u64 limb path for p < 2^30."""
    if p < (1 << 30):
        A64 = A.astype(np.uint64)
        C64 = C.astype(object) % p
        C64 = np.array(C64, dtype=np.uint64)
        hi, lo = C64 >> 15, C64 & np.uint64(0x7FFF)
        # products < 2^30 * 2^15 = 2^45; sums over n <= 2^18 terms fit u64
        out = ((A64 @ hi) % p * ((1 << 15) % p) + (A64 @ lo) % p) % p
        return out.astype(object)
    Ao = A.astype(object)
    Co = C.astype(object) % p
    return (Ao @ Co) % p


def salvage_kernel(kernel: np.ndarray, vtM: np.ndarray, p: int,
                   max_rounds: int | None = None):
    """Extract true kernel vectors from a partially-converged block.

    kernel: (N, n) final block v; vtM: (m, n) = v^T M (the solver's last
    `tmp`).  Returns (N, k) with k >= 0 columns, each verified to satisfy
    column^T M == 0 exactly; k == n means the block already converged.
    """
    kernel = np.asarray(kernel)
    vtM = np.asarray(vtM)
    m, n = vtM.shape
    rng = np.random.default_rng(0)
    take = min(m, 2 * n)
    sample_idx = list(rng.choice(m, size=take, replace=False)) if m else []
    rounds = max_rounds if max_rounds is not None else n + 1
    C = None
    for _ in range(rounds):
        R = vtM[sample_idx] if sample_idx else np.zeros((1, n), vtM.dtype)
        C = _nullspace_small(p, R)
        if C.shape[1] == 0:
            return np.zeros((kernel.shape[0], 0), kernel.dtype)
        resid = _matmul_exact(p, vtM, C)       # (m, k)
        bad_rows = np.nonzero((resid != 0).any(axis=1))[0]
        if len(bad_rows) == 0:
            break
        sample_idx.extend(bad_rows[:2 * n].tolist())
    else:
        # keep only the columns that fully verify
        resid = _matmul_exact(p, vtM, C)
        good = np.nonzero(~(resid != 0).any(axis=0))[0]
        C = C[:, good]
        if C.shape[1] == 0:
            return np.zeros((kernel.shape[0], 0), kernel.dtype)

    out = _matmul_exact(p, kernel, C)          # (N, k)
    # drop all-zero columns (v @ c == 0 is a trivial kernel vector)
    nz = np.nonzero((out != 0).any(axis=0))[0]
    out = out[:, nz]
    return np.array(out, dtype=kernel.dtype if p < (1 << 32) else np.uint64)


# ---------------------------------------------------------------------------
# Completeness across restarts: a single salvage on a structured instance
# typically recovers MOST of the block; a restarted solve with a fresh v0
# explores a different Krylov space and its salvage fills in the residue.
# The reference has no analogue (it KOs, sequential/lanczos_modp.c:560-582).
# ---------------------------------------------------------------------------

def combine_kernel_blocks(blocks, p: int) -> np.ndarray:
    """Union of verified kernel blocks, EXACTLY rank-filtered.

    Every input column must already satisfy x^T M == 0 (salvage output or
    a converged block); this routine only removes linear dependence so
    the combined yield counts genuinely independent vectors.  Exact
    full-height Gaussian elimination over the columns — no sampling, so
    an independent vector is never dropped and a dependent one never
    counted.  GF(2) runs on bit-packed words (N x k/32, XOR column ops);
    odd p uses u64 arithmetic (residues < 2^30: products fit u64
    elementwise) or object ints beyond.
    """
    cols = [np.asarray(b[:, k]) for b in blocks for k in range(b.shape[1])]
    if not cols:
        return np.zeros((0, 0), np.uint32)
    N = cols[0].shape[0]
    if p == 2:
        # pack each column into N/32-word bitstrings; greedy pivot basis
        words = (N + 31) // 32
        idx = np.arange(N)
        basis, pivots, keep = [], [], []
        for ci, c in enumerate(cols):
            w = np.zeros(words, np.uint32)
            bits = (np.asarray(c, np.uint32) & 1).astype(np.uint32)
            np.bitwise_or.at(w, idx // 32, bits << (idx % 32).astype(np.uint32))
            for b, piv in zip(basis, pivots):
                if (w[piv // 32] >> np.uint32(piv % 32)) & 1:
                    w ^= b
            nzw = np.nonzero(w)[0]
            if len(nzw):
                first = int(nzw[0])
                word = int(w[first])
                piv = first * 32 + ((word & -word).bit_length() - 1)
                basis.append(w)
                pivots.append(piv)
                keep.append(ci)
        return (np.stack([cols[k] for k in keep], axis=1).astype(np.uint32)
                if keep else np.zeros((N, 0), np.uint32))
    # odd p: column elimination mod p (u64 path for p < 2^30, else object)
    small = p < (1 << 30)
    basis, pivots, keep = [], [], []
    for ci, c in enumerate(cols):
        v = (c.astype(np.uint64) % p) if small else (c.astype(object) % p)
        for b, (piv, inv) in zip(basis, pivots):
            coef = int(v[piv])
            if coef:
                factor = (coef * inv) % p
                # small path: (p-1)*(p-1) < 2^60 fits u64 elementwise;
                # wide path: object ints, exact by construction
                v = (v + (p - factor) * b) % p
        nz = np.nonzero(v != 0)[0]
        if len(nz):
            piv = int(nz[0])
            inv = pow(int(v[piv]), p - 2, p)
            basis.append(v)
            pivots.append((piv, inv))
            keep.append(ci)
    if not keep:
        return np.zeros((N, 0), np.uint32)
    out = np.stack([cols[k] for k in keep], axis=1)
    return out.astype(np.uint32 if p < (1 << 32) else np.uint64)


def salvage_with_restarts(solve_fn, first_result, p: int, n: int,
                          restarts: int = 0, verbose: bool = False):
    """Salvage the first result, then re-solve with fresh v0 blocks until
    the combined verified yield reaches n columns or `restarts` runs out.

    `solve_fn()` re-runs the SAME solver object — its xoshiro stream
    continues, so every restart starts from a fresh random block (the
    deterministic continuation keeps multi-process replicas in lockstep).
    Returns the combined (N, k) block of exactly-independent verified
    kernel vectors, k <= n.
    """
    blocks = []
    res = first_result
    combined = np.zeros((0, 0), np.uint32)
    for attempt in range(restarts + 1):
        if attempt > 0:
            res = solve_fn()
        if res.product_zero:
            blocks.append(np.asarray(res.kernel))      # converged: all kernel
        elif res.vtM is not None:
            blocks.append(salvage_kernel(res.kernel, res.vtM, p))
        combined = combine_kernel_blocks(blocks, p)
        if verbose:
            print(f"Salvage: {combined.shape[1]} / {n} independent verified "
                  f"kernel vectors after {attempt + 1} block(s)")
        if combined.shape[1] >= n:
            break
    return combined
