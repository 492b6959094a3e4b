"""Carrying the JAX package's data across to the port.

The solver has no weights; what it carries between runs is its state and
its operator layout, for each of the three fields.  Both arrive here as
NumPy arrays, so this module needs nothing of the JAX package:

  * `state_from_numpy` takes the {v, p, iteration} checkpoint dict that the
    JAX solver's `solve(resume_state=...)` accepts (uint32 blocks, an
    optional `rowmap`) and returns the same dict with int32 tensors on the
    port's device, for the port's `BlockLanczos.solve(resume_state=...)`;
  * `hybrid_op_from_jax` turns the arrays of a JAX `HybridOp` built with
    delta=False into the port's HybridOp: slab values come back from the
    Montgomery form val*2^32 mod p (p = 2 is stored directly), and the
    (out_pad, L) slab becomes the port's column-major (L, out_dim) one;
  * the GF(2) pair: `gf2_state_from_numpy` takes the JAX BlockLanczosGF2's
    {v, p, iteration} state of packed uint32 words and returns int32 word
    patterns on the port's device, and `gf2_op_from_jax` turns a JAX
    `GF2Op`'s arrays into the port's column-major GF2Op;
  * the wide pair: `wide_state_from_numpy` takes the JAX
    BlockLanczosWide's {v, p, iteration} state of (rows, n, 2) uint32
    (lo, hi) pair blocks and returns int64 residues on the port's device,
    and `wide_op_from_jax` turns a JAX `WideHybridOp`'s arrays into the
    port's HybridOp: its slab and spill hold Montgomery pairs, val * 2^64
    mod p, taken out of that form on the host with Python ints, and stored
    in the port's narrow (int32 signed) or int64 slab;
  * the way back, for checkpoints that either package resumes:
    `state_to_numpy`, `gf2_state_to_numpy` and `wide_state_to_numpy` take
    the port's {v, p[, iteration]} blocks (tensors or NumPy) to the JAX
    solvers' on-disk forms: uint32 residues, packed uint32 words (a view of
    the int32 words: bit 31 kept), and (rows, n, 2) uint32 (lo, hi) pairs
    of canonical residues.  TO_NUMPY and FROM_NUMPY map a manifest's
    "field" (narrow, gf2, wide) to the pair.
"""

from __future__ import annotations

import numpy as np
import torch

from block_lanczos_tpu_torch.models.lanczos import state_rows
from block_lanczos_tpu_torch.models.lanczos_gf2 import (GF2Op,
                                                        gf2_op_from_arrays)
from block_lanczos_tpu_torch.ops import wide_ops
from block_lanczos_tpu_torch.ops.gfp import GFp, _invmod_int
from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
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


def gf2_state_from_numpy(state: dict, device) -> dict:
    """The JAX GF(2) solver's {v, p, iteration[, rowmap]} state of packed
    (rows, n/32) uint32 words as the port's resume state: int32 word
    patterns on `device`, in true row order."""
    out = {"iteration": int(state["iteration"])}
    for name in ("v", "p"):
        arr = np.array(state_rows(state, name), np.uint32)
        out[name] = torch.from_numpy(arr.view(np.int32)).to(device)
    return out


def gf2_op_from_jax(arrays: dict) -> GF2Op:
    """The port's GF2Op from a JAX GF2Op's NumPy arrays.

    `arrays` holds the JAX op's fields: out_dim, in_dim, nnz, ell, cols
    (out_pad, L) int32, valid (out_pad, ceil(L/32)) uint32 bit words,
    spill_in (padded past spill_nnz), spill_rowptr (out_dim + 1) and
    spill_nnz.  The slab and its valid words become column-major; the
    spill keeps its entries, without the padding.
    """
    out_dim = int(arrays["out_dim"])
    cols = np.asarray(arrays["cols"], np.int32)[:out_dim]
    valid = np.asarray(arrays["valid"], np.uint32)[:out_dim]
    s_nnz = int(arrays["spill_nnz"])
    rowptr = np.asarray(arrays["spill_rowptr"], np.int64)
    if rowptr.shape != (out_dim + 1,) or int(rowptr[-1]) != s_nnz:
        raise ValueError("spill rowptr does not cover the spill entries")
    return gf2_op_from_arrays(dict(
        ell=int(arrays["ell"]), nnz=int(arrays["nnz"]),
        cols=np.array(cols.T, order="C"),
        valid=np.array(valid.T, order="C").view(np.int32),
        rowptr=rowptr.astype(np.int32),
        sp_cols=np.asarray(arrays["spill_in"])[:s_nnz].astype(np.int32),
    ), out_dim, int(arrays["in_dim"]))


def _unpair(pairs) -> np.ndarray:
    """(..., 2) uint32 (lo, hi) pairs -> (...) Python ints."""
    pairs = np.asarray(pairs)
    return (pairs[..., 1].astype(object) << 32) + pairs[..., 0].astype(object)


def wide_state_from_numpy(state: dict, device) -> dict:
    """The JAX wide solver's NumPy {v, p, iteration[, rowmap]} state of
    (rows, n, 2) uint32 pair blocks as the port's resume state: int64
    residues on `device`, in true row order."""
    out = {"iteration": int(state["iteration"])}
    for name in ("v", "p"):
        pairs = np.asarray(state_rows(state, name), np.uint64)
        if pairs.shape[-1:] != (2,):
            raise ValueError(f"state block {name!r} must be (rows, n, 2) "
                             f"(lo, hi) pairs, got {pairs.shape}")
        vals = (pairs[..., 1] << np.uint64(32)) | pairs[..., 0]
        if vals.size and int(vals.max()) >= 1 << 62:
            raise ValueError(f"state block {name!r} holds values >= 2^62; "
                             "not wide-field residues")
        out[name] = torch.from_numpy(
            np.ascontiguousarray(vals.astype(np.int64))).to(device)
    return out


def _from_mont64(p: int, pairs) -> np.ndarray:
    """Montgomery pairs (val * 2^64 mod p) -> int64 standard residues."""
    rinv = _invmod_int(1 << 64, p)
    return ((_unpair(pairs) * rinv) % p).astype(np.int64)


def wide_op_from_jax(arrays: dict, p: int) -> HybridOp:
    """The port's wide HybridOp from a JAX WideHybridOp's NumPy arrays,
    with the slab that ops/wide_ops.py::make_wide_op would pick (int32
    signed coefficients when every coefficient fits, else int64
    residues).

    `arrays` holds the JAX op's fields: out_dim, in_dim, nnz, ell, cols
    (out_pad, L) int32 and vals (out_pad, L, 2) Montgomery uint32 pairs,
    and its spill WideSparseOp as spill_nnz, spill_in_idx, spill_val_mont
    ((nnzp, 2) pairs) and spill_rowptr (out_dim + 1).
    """
    GFpWide.make(p)
    out_dim, ell = int(arrays["out_dim"]), int(arrays["ell"])
    cols = np.asarray(arrays["cols"], np.int32)[:out_dim]
    vals = _from_mont64(p, np.asarray(arrays["vals"])[:out_dim])
    s_nnz = int(arrays["spill_nnz"])
    rowptr = np.asarray(arrays["spill_rowptr"], np.int64)
    if rowptr.shape != (out_dim + 1,) or int(rowptr[-1]) != s_nnz:
        raise ValueError("spill rowptr does not cover the spill entries")
    sp_vals = _from_mont64(
        p, np.asarray(arrays["spill_val_mont"])[:s_nnz]).reshape(-1)
    narrow = wide_ops.narrow_fits(p, vals, sp_vals)
    return hybrid_op_from_arrays(p, dict(
        ell=ell, nnz=int(arrays["nnz"]),
        cols=np.ascontiguousarray(cols.T),
        vals=np.ascontiguousarray(wide_ops.slab_values(p, vals.T, narrow)),
        rowptr=rowptr.astype(np.int32),
        sp_cols=np.asarray(arrays["spill_in_idx"])[:s_nnz].astype(np.int32),
        sp_vals=wide_ops.slab_values(p, sp_vals, narrow),
    ), out_dim, int(arrays["in_dim"]))


def _host(block) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        return block.cpu().numpy()
    return np.asarray(block)


def _to_numpy(state: dict, convert) -> dict:
    out = {name: convert(_host(state[name])) for name in ("v", "p")}
    if "iteration" in state:
        out["iteration"] = int(state["iteration"])
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's narrow {v, p[, iteration]} state (int32 residues) in the
    JAX solver's on-disk form: uint32 residues, (rows, n)."""
    return _to_numpy(state, lambda a: a.astype(np.uint32))


def gf2_state_to_numpy(state: dict) -> dict:
    """The port's GF(2) state (int32 word patterns) as the JAX solver's
    packed uint32 words, (rows, n/32): the same bits, bit 31 included."""
    return _to_numpy(state, lambda a: np.ascontiguousarray(a).view(np.uint32))


def wide_state_to_numpy(state: dict) -> dict:
    """The port's wide state (int64 residues in [0, p), p < 2^62) as the JAX
    wide solver's (rows, n, 2) uint32 (lo, hi) pairs."""
    def pairs(a):
        if a.size and int(a.min()) < 0:
            raise ValueError("wide state blocks hold residues >= 0")
        a = a.astype(np.uint64)
        return np.stack([a & np.uint64(0xFFFFFFFF), a >> np.uint64(32)],
                        axis=-1).astype(np.uint32)
    return _to_numpy(state, pairs)


# a manifest's "field" -> the way to the JAX on-disk form, and back (to the
# port's resume state on a device)
TO_NUMPY = {"narrow": state_to_numpy, "gf2": gf2_state_to_numpy,
            "wide": wide_state_to_numpy}
FROM_NUMPY = {"narrow": state_from_numpy, "gf2": gf2_state_from_numpy,
              "wide": wide_state_from_numpy}
