"""Carrying the JAX package's data across to the port.

The solver has no weights; what it carries between runs is its state and
its operator layout.  Both arrive here as NumPy arrays, so this module
needs nothing of the JAX package:

  * `state_from_numpy` takes the {v, p, iteration} checkpoint dict that the
    JAX solver's `solve(resume_state=...)` accepts (uint32 blocks, an
    optional `rowmap`) and returns the same dict with int32 tensors on the
    port's device, for the port's `BlockLanczos.solve(resume_state=...)`;
  * `hybrid_op_from_jax` turns the arrays of a JAX `HybridOp` built with
    delta=False into the port's HybridOp: slab values come back from the
    Montgomery form val*2^32 mod p (p = 2 is stored directly), and the
    (out_pad, L) slab becomes the port's column-major (L, out_dim) one.
"""

from __future__ import annotations

import numpy as np
import torch

from block_lanczos_tpu_torch.models.lanczos import state_rows
from block_lanczos_tpu_torch.ops.gfp import GFp, _invmod_int
from block_lanczos_tpu_torch.ops.spmm import HybridOp, hybrid_op_from_arrays


def state_from_numpy(state: dict, device) -> dict:
    """The JAX solver's NumPy {v, p, iteration[, rowmap]} state as the
    port's resume state: int32 tensors on `device`, in true row order."""
    out = {"iteration": int(state["iteration"])}
    for name in ("v", "p"):
        arr = state_rows(state, name)
        if arr.size and int(arr.max()) >= 1 << 30:
            raise ValueError(f"state block {name!r} holds values >= 2^30; "
                             "not narrow-field residues")
        out[name] = torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.int32))).to(device)
    return out


def _from_mont(p: int, vals: np.ndarray) -> np.ndarray:
    vals = np.asarray(vals, np.uint64)
    if p == 2:  # direct mode: stored as plain residues
        return (vals % np.uint64(p)).astype(np.int32)
    rinv = np.uint64(_invmod_int(1 << 32, p))
    return (vals * rinv % np.uint64(p)).astype(np.int32)  # < 2^60: exact


def hybrid_op_from_jax(arrays: dict, p: int) -> HybridOp:
    """The port's HybridOp from a JAX HybridOp's NumPy arrays.

    `arrays` holds the JAX op's fields: out_dim, in_dim, nnz, ell,
    cols (out_pad, L) int32 and vals (out_pad, L) Montgomery-form uint32
    (delta=False layout), and its spill SparseOp as spill_nnz,
    spill_in_idx, spill_val_mont and spill_rowptr (out_dim + 1).
    """
    GFp.make(p)
    out_dim, ell = int(arrays["out_dim"]), int(arrays["ell"])
    cols = np.asarray(arrays["cols"])
    if cols.ndim != 2:
        raise ValueError("hybrid_op_from_jax needs the absolute (delta=False) "
                         "column slab")
    vals = _from_mont(p, arrays["vals"])
    s_nnz = int(arrays["spill_nnz"])
    rowptr = np.asarray(arrays["spill_rowptr"], np.int64)
    if rowptr.shape != (out_dim + 1,) or int(rowptr[-1]) != s_nnz:
        raise ValueError("spill rowptr does not cover the spill entries")
    return hybrid_op_from_arrays(p, dict(
        ell=ell, nnz=int(arrays["nnz"]),
        cols=np.ascontiguousarray(cols[:out_dim].T.astype(np.int32)),
        vals=np.ascontiguousarray(vals[:out_dim].T),
        rowptr=rowptr.astype(np.int32),
        sp_cols=np.asarray(arrays["spill_in_idx"])[:s_nnz].astype(np.int32),
        sp_vals=_from_mont(p, np.asarray(arrays["spill_val_mont"])[:s_nnz]),
    ), out_dim, int(arrays["in_dim"]))
