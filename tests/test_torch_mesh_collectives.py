"""The mesh's exact collectives and partition maps against the JAX package.

  * the sharded solvers' bound forms of psum_mod, psum_mod_wide and pxor
    (parallel/collectives.py: PsumMod, PsumModWide, Pxor; on CPU tensors
    their plain versions), on a world of 8 gloo ranks spawned once
    (parallel/launch.py), over groups of R = 1, 2, 3, 4 and 8 ranks, equal
    on every member to the JAX package's psum_mod, psum_mod_wide and pxor
    under jax.shard_map on the same partials (as tests/test_sharded.py runs
    them);
  * the bound forms' packs and folds on sums of many ranks' partials made
    here (up to 2^20 ranks), against the exact sums: K1 and K2 in Python
    ints, K3 the XOR of the words, with every lane sum inside int32, K3's
    planes plane_stride(n) words apart with zero padding, and Pxor's pack
    and fold equal to the plain spread and fold;
  * BandMap, balanced_band_map (both LPT deals), _grid_maps and each
    rank's block equal to the JAX package's on skewed counts;
  * a sharded solver given no grid runs on CUDA or raises: with no CUDA it
    never falls back to CPU blocks.

Tolerance zero everywhere.  The spawn has a 120 s wall limit that kills
its ranks.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.ops.gfp import GFp as JGFp
from block_lanczos_tpu.parallel import sharding as jshard
from block_lanczos_tpu.parallel.collectives import psum_mod as jpsum_mod
from block_lanczos_tpu.parallel.collectives import \
    psum_mod_wide as jpsum_mod_wide
from block_lanczos_tpu.parallel.distributed_gf2 import pxor as jpxor
from block_lanczos_tpu.parallel.mesh import make_mesh as jmake_mesh
from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
from block_lanczos_tpu_torch.parallel import collectives as C
from block_lanczos_tpu_torch.parallel import launch, mesh
from block_lanczos_tpu_torch.parallel import sharding as tshard
from block_lanczos_tpu_torch.utils import mmio

import mesh_ranks

RANKS = (1, 2, 3, 4, 8)
NARROW_PRIMES = (65537, (1 << 30) - 35)
WIDE_PRIMES = ((1 << 61) - 1, 4611686018427387847)
WALL_S = 120


def _partials(kind, R, p, seed):
    rng = np.random.default_rng(seed)
    if kind == "xor":
        w = rng.integers(-(1 << 31), 1 << 31, (R, 7, 2), dtype=np.int64)
        w[:, 0] = -1                    # every bit set on every rank
        w[:, 1, 0] = -(1 << 31)         # bit 31 alone
        return w.astype(np.int32)
    shape = (R, 6, 4) if kind == "mod" else (R, 5, 3)
    x = rng.integers(0, p, shape, dtype=np.int64)
    x[:, 0] = p - 1                     # the largest sums
    return x.astype(np.int32 if kind == "mod" else np.int64)


def _cases():
    cases = []
    for R in RANKS:
        for p in NARROW_PRIMES:
            cases.append(("mod", R, p, _partials("mod", R, p, R + p)))
        for p in WIDE_PRIMES:
            cases.append(("wide", R, p, _partials("wide", R, p, R + p % 97)))
        cases.append(("xor", R, 0, _partials("xor", R, 0, R)))
    return cases


@pytest.fixture(scope="module")
def port_results():
    cases = _cases()
    out, last = launch.spawn(mesh_ranks.collectives_job, ["cpu"] * 8,
                             args=(cases,), wall_s=WALL_S)[0]
    return cases, out, last


def _jax_sum(kind, R, p, parts):
    m = jmake_mesh(R)
    if kind == "mod":
        f = JGFp.make(p)
        body, x = (lambda x: jpsum_mod(f, x, "rows")), parts.astype(np.uint32)
    elif kind == "wide":
        f2 = jgw.GFpWide.make(p)
        body = lambda x: jpsum_mod_wide(f2, x, "rows")  # noqa: E731
        x = jgw.np_pair(parts.astype(object))
    else:
        body, x = (lambda x: jpxor(x, "rows")), parts.view(np.uint32)
    flat = x.reshape((-1,) + x.shape[2:])
    got = np.asarray(jax.jit(jax.shard_map(
        body, mesh=m, in_specs=P("rows"), out_specs=P()))(flat))
    if kind == "mod":
        return got.astype(np.int32)
    if kind == "wide":
        return jgw.np_unpair(got).astype(np.int64)
    return got.view(np.int32)


@pytest.mark.parametrize("kind", ["mod", "wide", "xor"])
@pytest.mark.parametrize("R", RANKS)
def test_collective_matches_jax_on_every_rank(port_results, kind, R):
    """The solvers' bound form (collectives.PsumMod / PsumModWide / Pxor),
    a fresh object's call and one object's second call, on rank 0 and on
    rank R - 1, bit for bit."""
    cases, out, last = port_results
    n = 0
    for k, (kd, r, p, parts) in enumerate(cases):
        if (kd, r) != (kind, R):
            continue
        want = _jax_sum(kd, r, p, parts)
        for got in (out[k], last[k]):
            np.testing.assert_array_equal(got[0], want, err_msg=f"p={p}")
            np.testing.assert_array_equal(got[1], want,
                                          err_msg=f"bound, p={p}")
        n += 1
    assert n == (1 if kind == "xor" else 2)


def test_payload_choices():
    """Each payload switches where a sum of R ranks would leave its type."""
    p = (1 << 30) - 35
    assert C.mod_payload_dtype(2, p) == torch.int32        # 2 (p-1) < 2^31
    assert C.mod_payload_dtype(3, p) == torch.int64
    assert C.mod_payload_dtype(255, 65537) == torch.int32
    assert C.mod_payload_dtype(32769, 65537) == torch.int64
    assert [C.wide_halves(R) for R in (1, 2, 3)] == [False, False, True]
    lanes = {R: C.pxor_lanes(R) for R in (1, 2, 3, 8, 9, 128, 129, 32768,
                                          32769)}
    assert lanes == {1: 2, 2: 2, 3: 4, 8: 4, 9: 8, 128: 8, 129: 16,
                     32768: 16, 32769: 32}


SYNTH_RANKS = (1, 2, 3, 8, 9, 127, 128, 129, 255, 256, 32768, 32769)


def _synth_words(R):
    """R ranks' (3, 2) words: random, all bits set, bit 31 alone."""
    rng = np.random.default_rng(R)
    w = rng.integers(-(1 << 31), 1 << 31, (R, 3, 2), dtype=np.int64)
    w[:, 0] = -1
    w[:, 1, 1] = -(1 << 31)
    return w.astype(np.int32)


def _rank_planes(spread, w, R):
    """Each rank's (L, 8) planes of its 6 words, by `spread` (a bound
    form's pack) on all R ranks' words as one tensor: a tensor's plane k
    holds its words in order, so rank r's are its words 6 r .. 6 r + 5,
    padded here as a 6-word tensor's plane is."""
    lanes = C.pxor_lanes(R)
    planes = spread(torch.from_numpy(w))
    assert planes.shape == (lanes, C.plane_stride(6 * R))
    assert not planes[:, 6 * R:].any()              # the padding: zeros
    own = planes[:, :6 * R].reshape(lanes, R, 6).transpose(0, 1)
    return torch.nn.functional.pad(own, (0, C.plane_stride(6) - 6))


@pytest.mark.parametrize("R", SYNTH_RANKS)
def test_pxor_folds_sums_of_many_ranks(R):
    """K3 on R ranks' words summed here: each rank's planes lie
    plane_stride(6) = 8 words apart, every lane sum stays in int32 (the
    top lane negated) and the fold gives the XOR."""
    w = _synth_words(R)
    x = torch.from_numpy(w[0].copy())
    bound = C.Pxor(x, ranks=R)
    per_rank = _rank_planes(bound.pack, w, R)
    first = bound.pack(x)
    assert first.shape == (C.pxor_lanes(R), 8) and not first[:, 6:].any()
    np.testing.assert_array_equal(per_rank[0].numpy(), first.numpy())
    planes = per_rank.to(torch.int64).sum(0)                 # (L, 8)
    assert int(planes.min()) >= -(1 << 31) and int(planes.max()) < 1 << 31
    bound.fold(planes.to(torch.int32), x)
    np.testing.assert_array_equal(x.numpy(),
                                  np.bitwise_xor.reduce(w, axis=0))


@pytest.mark.parametrize("R", (1, 2, 3, 8, 9, 129, 32769))
def test_bound_pxor_on_the_cpu_equals_pxor(R):
    """collectives.Pxor on CPU tensors (its ranks given, so no process
    group) launches nothing: its pack equals spread_xor_plain and its fold
    of R ranks' summed planes equals fold_xor_plain's, the XOR of the
    words.  (Its refusal of a tensor other than the bound one runs on CUDA
    only, where its launches are prepared: chip_smoke.py phase 12 holds
    it.)"""
    w = _synth_words(R)
    x = torch.from_numpy(w[0].copy())
    bound = C.Pxor(x, ranks=R)
    launched = C.launch_counts()["pxor"]
    np.testing.assert_array_equal(bound.pack(x).numpy(),
                                  C.spread_xor_plain(x, R).numpy())
    planes = _rank_planes(bound.pack, w, R).to(torch.int64).sum(0)
    sums = planes.to(torch.int32)
    got, want = torch.empty_like(x), torch.empty_like(x)
    bound.fold(sums, got)
    C.fold_xor_plain(sums, want)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.bitwise_xor.reduce(w, axis=0))
    assert C.launch_counts()["pxor"] == launched    # no kernel on the CPU


@pytest.mark.parametrize("R", (1, 2, 3, 255, 1 << 20))
def test_mod_folds_sums_of_many_ranks(R):
    """K1 and K2's bound forms (PsumMod, PsumModWide): their payloads for
    R ranks of p - 1 and of random residues, summed here, fold to the
    exact sums mod p (Python ints)."""
    rng = np.random.default_rng(R)
    for p in NARROW_PRIMES:
        x = torch.tensor([[p - 1, 0, 1, p // 2]], dtype=torch.int32)
        per_rank = [int(v) for v in x.view(-1)]
        bound = C.PsumMod(x, p, ranks=R)
        sums = bound.pack(x) * R                # R ranks holding x each
        assert int(sums.max()) <= (1 << 31) - 1 or sums.dtype == torch.int64
        out = torch.empty_like(x)
        bound.fold(sums, out)
        assert out.view(-1).tolist() == [v * R % p for v in per_rank]
    for p in WIDE_PRIMES:
        f = GFpWide.make(p)
        vals = [p - 1, 0, 1, int(rng.integers(0, p))]
        x = torch.tensor([vals], dtype=torch.int64)
        bound = C.PsumModWide(x, f, ranks=R)
        sums = bound.pack(x) * R                # whole or as halves
        out = torch.empty_like(x)
        bound.fold(sums, out)
        assert out.view(-1).tolist() == [v * R % p for v in vals]


def _skewed_coo(nrows, ncols, nnz, seed):
    rng = np.random.default_rng(seed)
    i = (rng.pareto(1.2, nnz) * 7).astype(np.int64) % nrows
    j = rng.integers(0, ncols, nnz)
    j[: nnz // 3] = (rng.pareto(1.0, nnz // 3) * 3).astype(np.int64) % ncols
    x = rng.integers(1, 65537, nnz).astype(np.uint32)
    return i.astype(np.int32), j.astype(np.int32), x


@pytest.mark.parametrize("parts", (1, 2, 3, 4, 8))
def test_balanced_band_map_matches_jax(parts):
    rng = np.random.default_rng(parts)
    for dim in (37, 5000, 250_000):       # the exact and the snake deals
        counts = (rng.pareto(1.1, dim) * 5).astype(np.int64)
        got = tshard.balanced_band_map(counts, parts)
        want = jshard.balanced_band_map(counts, parts)
        assert (got.dim, got.parts, got.band) == \
            (want.dim, want.parts, want.band)
        assert (got.pos is None) == (want.pos is None)
        if got.pos is not None:
            np.testing.assert_array_equal(got.pos, want.pos)
            np.testing.assert_array_equal(got.rowmap(), want.rowmap())
        block = rng.integers(0, 9, (dim, 2))
        np.testing.assert_array_equal(got.scatter(block),
                                      want.scatter(block))
        np.testing.assert_array_equal(got.gather(got.scatter(block)), block)
    if parts > 1:
        assert not tshard.balanced_band_map(
            np.r_[np.full(8, 1000), np.ones(800, np.int64)], parts).identity


@pytest.mark.parametrize("grid,right", [((2, 2), False), ((4, 2), True),
                                        ((1, 4), False), ((3, 1), True)])
def test_grid_maps_and_blocks_match_jax(grid, right):
    R, C_ = grid
    i, j, x = _skewed_coo(301, 203, 4000, R * 10 + C_)
    got = tshard._grid_maps(i, j, 301, 203, right, R, C_, 8)
    want = jshard._grid_maps(i, j, 301, 203, right, R, C_, 8)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[4:], want[4:]):
        assert (a.band, a.parts, a.pos is None) == (b.band, b.parts,
                                                    b.pos is None)
        if a.pos is not None:
            np.testing.assert_array_equal(a.pos, b.pos)
    assert not (got[4].identity and got[5].identity) or R * C_ == 1
    n_eff, m_eff, key, other, row_map, col_map = got
    (first, second), shard_nnz = jshard._grid_parts(key, other, x,
                                                    want[4], want[5])
    for r in range(R):
        for c in range(C_):
            blk = tshard.grid_block(key, other, x, row_map, col_map, r, c)
            lo, lk, xv = first[r * C_ + c]
            np.testing.assert_array_equal(blk.lo, lo)
            np.testing.assert_array_equal(blk.lk, lk)
            np.testing.assert_array_equal(blk.vals, xv)
            np.testing.assert_array_equal(blk.shard_nnz, shard_nnz)
            assert (second[r * C_ + c][0] == lk).all()


def test_balanced_grid():
    assert mesh.balanced_grid(1) == (1, 1)
    assert mesh.balanced_grid(8) == (4, 2)
    assert mesh.balanced_grid(16) == (4, 4)
    assert mesh.balanced_grid(7) == (7, 1)


@pytest.mark.parametrize("field,prime,n", [("narrow", 65537, 4),
                                          ("gf2", 2, 32),
                                          ("wide", (1 << 61) - 1, 4)])
def test_solver_without_a_grid_needs_cuda(tmp_path, field, prime, n):
    """No grid and no CUDA: the solver raises before it builds anything; only
    an explicit device "cpu" gives CPU blocks."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default grid runs there")
    i = np.array([0, 1, 2, 3], dtype=np.int64)
    M = mmio.COOMatrix(6, 4, 4, i, i, np.ones(4, dtype=np.uint64), prime)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_ranks.SOLVERS[field](M, n=n)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_grid(1, 1)
        assert mesh.make_mesh("cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
