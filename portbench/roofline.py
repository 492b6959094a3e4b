"""The frozen yardstick of the kernels' rooflines: bytes the algorithm
must move, counted from its inputs and outputs only (the benchmark's COO
and the block width), never from the program's layout.

A share of a roofline is (bytes / HBM_BYTES_PER_S) over the kernels'
measured device time.  No published peak exists for mod-p or GF(2) block
products, so the bound is the bytes bound alone: a floor on the least
time, which can make a share read low but never high from the operations
side.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12

INDEX_BYTES = 4     # a nonzero's column index


def element_bytes(field: str, n: int) -> float:
    """Bytes of one row of an n-wide block: 4 a residue in the narrow
    field, 8 in the wide field, one bit an entry over GF(2)."""
    return {"narrow": 4 * n, "wide": 8 * n, "gf2": n / 8}[field]


def value_bytes(field: str) -> int:
    """Bytes of a nonzero's value: none over GF(2), where every stored
    entry is 1."""
    return {"narrow": 4, "wide": 8, "gf2": 0}[field]


def spmv_bytes(field: str, nrows: int, ncols: int, nnz: int, n: int) -> float:
    """One iteration's two products, M^T v then M tmp: per direction every
    nonzero's index and value read once, the input block read once and the
    output block written once."""
    per_direction_matrix = nnz * (INDEX_BYTES + value_bytes(field))
    blocks = 2 * (nrows + ncols) * element_bytes(field, n)
    return 2 * per_direction_matrix + blocks


def gram_bytes(field: str, N: int, n: int) -> float:
    """[v | Av]^T Av: v and Av (N rows) read once, the 2n x n result
    written once."""
    return 2 * N * element_bytes(field, n) + 2 * n * element_bytes(field, n)


def orthogonalize_bytes(field: str, N: int, n: int) -> float:
    """v, p <- the recurrence: v, p and Av (N rows) and the 2n x 2n
    coefficients read once, v and p written once."""
    return (5 * N * element_bytes(field, n)
            + 2 * n * element_bytes(field, 2 * n))


def bound_s(nbytes: float) -> float:
    """The least seconds that moving `nbytes` through HBM takes."""
    return nbytes / HBM_BYTES_PER_S
