"""MatrixMarket IO (the port's own copy).

Same semantics as the JAX package's reader and writer, which follow the
reference (sequential/mmio.c and sequential/lanczos_modp.c:199-263):
sparse "coordinate integer general" matrices in, dense "array integer
general" kernel blocks out.  Coefficients are reduced mod p at load time.
For p <= 2^30 - 35 with the reference's rule for negative entries: the
value is read as a u32 (two's complement), then reduced mod p (uint32
out).  For a wide prime (p > 2^30 - 35) as the JAX package reads it: the
value is parsed as an int64 and reduced mathematically, v mod p >= 0, so
p + 5 loads as 5 and -1 as p - 1 (uint64 out).  Parsing is NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP


@dataclasses.dataclass
class COOMatrix:
    """Triplet storage, 0-based indices, coefficients already reduced mod p."""
    nrows: int
    ncols: int
    nnz: int
    i: np.ndarray   # int32
    j: np.ndarray   # int32
    x: np.ndarray   # uint32 in [0, p); uint64 for a wide prime
    prime: int


def _read_banner_and_size(f):
    """Parse the %%MatrixMarket banner + size line from an open binary file.

    Returns (object, format, field, symmetry, size_fields).
    """
    banner = f.readline().decode("ascii", "replace")
    parts = banner.strip().split()
    if not banner.startswith("%%MatrixMarket") or len(parts) < 5:
        raise ValueError("Could not process Matrix Market banner")
    mm_object, mm_format, mm_field, mm_symmetry = [p.lower() for p in parts[1:5]]
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Cannot read matrix size")
        s = line.decode("ascii", "replace").strip()
        if s and not s.startswith("%"):
            return mm_object, mm_format, mm_field, mm_symmetry, s.split()


def _validate(obj, fmt, field, sym, want_fmt: str):
    if obj != "matrix" or fmt != want_fmt:
        kind = "sparse" if want_fmt == "coordinate" else "dense"
        raise ValueError(f"Matrix Market type [{obj} {fmt}] not supported "
                         f"(only {kind} matrices are OK)")
    if sym != "general" or field != "integer":
        raise ValueError(f"Matrix type [{field} {sym}] not supported "
                         "(only integer general are OK)")


def read_mtx_header(path: str):
    """Header-only read: (nrows, ncols, nnz) of a sparse integer matrix."""
    with open(path, "rb") as f:
        obj, fmt, field, sym, size = _read_banner_and_size(f)
    _validate(obj, fmt, field, sym, "coordinate")
    return int(size[0]), int(size[1]), int(size[2])


def _validate_indices(mi: np.ndarray, mj: np.ndarray, nrows: int, ncols: int):
    """Range-check parsed 0-based indices (int64, before any narrowing)."""
    for ids, dim, what in ((mi, nrows, "row"), (mj, ncols, "column")):
        bad = (ids < 0) | (ids >= dim)
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(f"matrix entry {k + 1}: {what} index "
                             f"{int(ids[k]) + 1} outside [1, {dim}]")


def load_mtx(path: str, prime: int, verbose: bool = False) -> COOMatrix:
    """Load a sparse MatrixMarket file as COO, coefficients reduced mod prime."""
    if verbose:
        print(f"Loading matrix from {path}", flush=True)
    with open(path, "rb") as f:
        obj, fmt, field, sym, size = _read_banner_and_size(f)
        _validate(obj, fmt, field, sym, "coordinate")
        nrows, ncols, nnz = int(size[0]), int(size[1]), int(size[2])
        if verbose:
            print(f"  - [{field} {sym}] {nrows} x {ncols} with {nnz} nz",
                  flush=True)
        buf = f.read()
    toks = buf.split()
    if len(toks) < 3 * nnz:
        raise ValueError(
            f"parse error: expected {nnz} triplets, found {len(toks) // 3}")
    arr = np.array(toks[:3 * nnz], dtype=np.int64).reshape(nnz, 3)
    del toks
    _validate_indices(arr[:, 0] - 1, arr[:, 1] - 1, nrows, ncols)
    if prime > PRIME_CAP:
        # wide prime: mathematical v mod p (int64 % positive >= 0)
        mx = (arr[:, 2] % np.int64(prime)).astype(np.uint64)
    else:
        # reference semantics: value scanned into u32 (two's complement
        # for negatives), then reduced mod p as a u64
        mx = (arr[:, 2].astype(np.uint32).astype(np.uint64)
              % np.uint64(prime)).astype(np.uint32)
    return COOMatrix(nrows=nrows, ncols=ncols, nnz=nnz,
                     i=(arr[:, 0] - 1).astype(np.int32),
                     j=(arr[:, 1] - 1).astype(np.int32),
                     x=mx, prime=int(prime))


def iter_mtx_triplets(path: str, chunk: int = 1 << 20):
    """Stream (i, j, raw_value) triplet chunks without materializing the matrix.

    Yields int64 arrays (i, j, x) of at most `chunk` triplets, indices
    shifted to 0-based, values raw (not reduced).  Used by the checker,
    which like the reference's checker streams the product from disk.
    """
    with open(path, "rb") as f:
        obj, fmt, field, sym, size = _read_banner_and_size(f)
        _validate(obj, fmt, field, sym, "coordinate")
        remaining = int(size[2])
        pending: list = []   # whole tokens not yet consumed
        tail = b""           # possibly-partial trailing token bytes
        at_eof = False
        while remaining > 0:
            need = 3 * min(remaining, chunk)
            while len(pending) < need and not at_eof:
                block = f.read(32 * chunk)
                if not block:
                    at_eof = True
                    pending.extend(tail.split())
                    tail = b""
                    break
                data = tail + block
                # keep a partial trailing token for the next round
                cut = max(data.rfind(b"\n"), data.rfind(b" "),
                          data.rfind(b"\t"))
                if cut <= 0:
                    tail = data
                    continue
                head, tail = data[:cut], data[cut:]
                pending.extend(head.split())
            take = min(remaining, chunk, len(pending) // 3)
            if take == 0:
                raise ValueError("unexpected EOF while streaming triplets")
            arr = np.array(pending[:3 * take], dtype=np.int64).reshape(take, 3)
            del pending[:3 * take]
            yield arr[:, 0] - 1, arr[:, 1] - 1, arr[:, 2]
            remaining -= take


def _int_lines(values) -> bytes:
    """One decimal integer per line, as np.savetxt(fmt="%d") writes them."""
    vals = np.asarray(values).reshape(-1).tolist()
    if not vals:
        return b""
    return ("\n".join(map(str, vals)) + "\n").encode()


def write_kernel_mtx(path: str, v: np.ndarray, nrows: int, n: int,
                     comment: str = "block of left-kernel vector computed by lanczos_modp"):
    """Write the kernel block in MatrixMarket array format, column-major.

    Byte for byte the reference's layout (sequential/lanczos_modp.c:673-686):
    v is the row-major (nrows x n) block, emitted one entry per line, j-outer.
    """
    v = np.asarray(v).reshape(-1)
    block = v[:nrows * n].reshape(nrows, n)
    col_major = np.ascontiguousarray(block.T).reshape(-1).astype(np.uint64)
    with open(path, "wb") as f:
        f.write(b"%%MatrixMarket matrix array integer general\n")
        f.write(f"%{comment}\n".encode())
        f.write(f"{nrows} {n}\n".encode())
        f.write(_int_lines(col_major))


def read_array_mtx(path: str):
    """Read a dense MatrixMarket array integer file (column-major).

    Returns (nrows, ncols, data) where data is the row-major (nrows x ncols)
    int64 array.
    """
    with open(path, "rb") as f:
        obj, fmt, field, sym, size = _read_banner_and_size(f)
        _validate(obj, fmt, field, sym, "array")
        nrows, ncols = int(size[0]), int(size[1])
        vals = np.array(f.read().split(), dtype=np.int64)
    if vals.size != nrows * ncols:
        raise ValueError("dense matrix file has wrong number of entries")
    return nrows, ncols, vals.reshape(ncols, nrows).T.copy()


def write_coo_mtx(path: str, nrows: int, ncols: int, i, j, x,
                  comment: str = "generated by block_lanczos_tpu"):
    """Write a sparse integer general matrix (1-based output indices)."""
    tri = np.stack([np.asarray(i, np.int64) + 1, np.asarray(j, np.int64) + 1,
                    np.asarray(x, np.int64)], axis=1)
    with open(path, "wb") as f:
        f.write(b"%%MatrixMarket matrix coordinate integer general\n")
        f.write(f"%{comment}\n".encode())
        f.write(f"{nrows} {ncols} {len(tri)}\n".encode())
        if len(tri):
            f.write(("\n".join(f"{a} {b} {c}" for a, b, c in tri.tolist())
                     + "\n").encode())
