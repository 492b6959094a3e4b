"""The port's bitsliced GF(2) ops against the JAX package's, bit for bit
(CPU tensors, so the plain versions of the four GF(2) kernels).

  * packing, bit_of and the column mask with bit 31 set everywhere;
  * matmul_gf2 on both of the JAX package's formulations (unrolled up to
    n_in = 128, the word fori loop above), gram_gf2 on both (unrolled up to
    n_x = 256, fused above) and across its row chunks, transpose_bits;
  * semi_inverse_gf2 with the invariant checks and the orthogonalize
    right-hand side, on zero, singular and full-rank Grams;
  * the layout (build_gf2_arrays and convert.gf2_op_from_jax) and spmv_gf2
    on slabs of one and of several valid words (the JAX fori path), with a
    spill; the column-banded layout (1 to 7 bands, some empty) and its
    banded product, and the band count the L2 size gives;
  * the gram_gf2 kernel's tiling on the binary tensor cores through its
    NumPy mirror (transpose32x2_np, mma_b1_np, gram_gf2_tiles_np), and the
    orthogonalize_gf2 kernel's (orthogonalize_gf2_tiles_np);
  * the semi_inverse_gf2 kernel's one-warp elimination through its NumPy
    mirror (semi_inverse_gf2_warp_np), d != d1 included;
  * dedup_lines, passthrough and compacting;
  * the kernels' C constants against the Python that sizes their buffers.
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos_gf2 as jlg
from block_lanczos_tpu.ops import gf2 as jgf2
from block_lanczos_tpu.utils.gen import random_sparse
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.convert import gf2_op_from_jax
from block_lanczos_tpu_torch.models import lanczos_gf2 as tlg
from block_lanczos_tpu_torch.ops import gf2 as tgf2
from block_lanczos_tpu_torch.ops.semi_inverse import new_state


def _words(rng, rows, W):
    """uint32 words with every bit random (bit 31 included)."""
    return rng.integers(0, 1 << 32, size=(rows, W), dtype=np.uint64).astype(
        np.uint32)


def _t(words_u32):
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))


def _u(t):
    return np.asarray(t).view(np.uint32) if isinstance(t, np.ndarray) \
        else t.numpy().view(np.uint32)


def _sym_bits(rng, n, rank):
    B = rng.integers(0, 2, size=(n, rank))
    return ((B @ B.T) % 2).astype(np.uint32)


def test_pack_unpack_and_bit_of_with_bit_31():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(37, 96)).astype(np.uint32)
    bits[:, 31] = bits[:, 63] = 1
    w = tgf2.pack_bits_np(bits)
    np.testing.assert_array_equal(w, jgf2.pack_bits_np(bits))
    assert (w[:, 0] >> 31 == 1).all()
    np.testing.assert_array_equal(_u(tgf2.pack_bits(torch.from_numpy(
        bits.astype(np.int32)))), w)
    np.testing.assert_array_equal(tgf2.unpack_bits(_t(w), 96).numpy(), bits)
    np.testing.assert_array_equal(tgf2.unpack_bits_np(w.view(np.int32), 96),
                                  jgf2.unpack_bits_np(w, 96))
    for k in (0, 5, 31, 32, 63, 95):
        want = np.asarray(jgf2.bit_of(jnp.asarray(w), k))
        np.testing.assert_array_equal(_u(tgf2.bit_of(_t(w), k)), want)
    d = rng.integers(0, 2, 96)
    d[[31, 63]] = 1
    np.testing.assert_array_equal(
        _u(tgf2.colmask(torch.from_numpy(d))),
        np.asarray(jlg._colmask(jnp.asarray(d.astype(np.uint32)))))


@pytest.mark.parametrize("n_in", [32, 128, 320])
def test_matmul_gf2_matches_jax(n_in):
    rng = np.random.default_rng(n_in)
    X, B = _words(rng, 50, n_in // 32), _words(rng, n_in, 3)
    want = np.asarray(jax.jit(jgf2.matmul_gf2, static_argnums=2)(
        jnp.asarray(X), jnp.asarray(B), n_in))
    np.testing.assert_array_equal(_u(tgf2.matmul_gf2(_t(X), _t(B), n_in)),
                                  want)


@pytest.mark.parametrize("n,N,chunk", [(32, 300, None), (128, 200, None),
                                       (160, 150, None), (64, 1000, 128),
                                       (160, 700, 256)])
def test_gram_gf2_matches_jax(n, N, chunk, monkeypatch):
    """[v | Av]^T Av: n_x = 2n <= 256 takes the JAX package's unrolled
    formulation, 320 its fused one; `chunk` forces its row-chunked scan."""
    if chunk is not None:
        monkeypatch.setattr(jgf2, "_GRAM_CHUNK", chunk)
    rng = np.random.default_rng(n + N)
    v, av = _words(rng, N, n // 32), _words(rng, N, n // 32)
    want = np.asarray(jax.jit(jgf2.gram_gf2, static_argnums=2)(
        jnp.concatenate([jnp.asarray(v), jnp.asarray(av)], axis=1),
        jnp.asarray(av), 2 * n))
    got = tgf2.gram_gf2(_t(v), _t(av))
    assert got.shape == (2 * n, n // 32)
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("n", [32, 64, 96])
def test_transpose_bits_matches_jax(n):
    M = _words(np.random.default_rng(n), n, n // 32)
    want = np.asarray(jax.jit(jgf2.transpose_bits, static_argnums=1)(
        jnp.asarray(M), n))
    np.testing.assert_array_equal(_u(tgf2.transpose_bits(_t(M), n)), want)


@pytest.mark.parametrize("n,rank", [(32, 0), (32, 12), (64, 40), (64, 64),
                                    (96, 96), (32, 100)])
def test_semi_inverse_gf2_matches_jax(n, rank):
    """winv, d, npiv against the JAX package's semi_inverse_gf2; the checks
    against check_invariants_gf2; the right-hand side against the product
    orthogonalize_gf2 takes."""
    rng = np.random.default_rng(n * 7 + rank)
    U = _sym_bits(rng, n, rank)
    UA = _sym_bits(rng, n, n)
    vtAv, vtAAv = tgf2.pack_bits_np(U), tgf2.pack_bits_np(UA)
    jw, jd, jnpiv = (np.asarray(a) for a in jax.jit(
        jgf2.semi_inverse_gf2, static_argnums=1)(jnp.asarray(vtAv), n))
    state = new_state("cpu")
    si = tgf2.semi_inverse_gf2(_t(np.concatenate([vtAv, vtAAv])), state)
    np.testing.assert_array_equal(_u(si.winv), jw)
    np.testing.assert_array_equal(si.d.numpy(), jd.astype(np.int64))
    assert int(si.npiv[0]) == int(jnpiv)
    if rank == 0:
        assert int(jnpiv) == 0 and state.tolist() == [1, 1, 0, 0]
    ok = bool(jax.jit(jlg.check_invariants_gf2, static_argnums=4)(
        jnp.asarray(vtAv), jnp.asarray(vtAAv), jnp.asarray(jw),
        jnp.asarray(jd), n))
    assert ok and state[1] == 1
    W = n // 32
    cm = np.asarray(jlg._colmask(jnp.asarray(jd)))[None, :]
    spliced = (vtAAv & cm) | (vtAv & ~cm)
    c = np.asarray(jax.jit(jgf2.matmul_gf2, static_argnums=2)(
        jnp.asarray(jw), jnp.asarray(spliced), n))
    rhs = _u(si.rhs)
    np.testing.assert_array_equal(rhs[:n, :W], c)
    np.testing.assert_array_equal(rhs[:n, W:], jw)
    np.testing.assert_array_equal(rhs[n:, :W], vtAv & cm)
    assert not rhs[n:, W:].any()


def test_semi_inverse_gf2_failing_check_and_frozen_state():
    rng = np.random.default_rng(5)
    n = 64
    g = tgf2.pack_bits_np(np.concatenate([_sym_bits(rng, n, 30),
                                          _sym_bits(rng, n, n)]))
    g[n + 3, 0] ^= np.uint32(1 << 9)           # vtAAv[3, 9]: not symmetric
    state = new_state("cpu")
    tgf2.semi_inverse_gf2(_t(g), state)
    assert state.tolist() == [0, 0, 0, 0]
    state = new_state("cpu")
    tgf2.semi_inverse_gf2(_t(g), state, check=False)
    assert state.tolist() == [0, 1, 0, 0]
    frozen = torch.tensor([1, 1, 5, 1], dtype=torch.int32)
    tgf2.semi_inverse_gf2(_t(g), frozen)
    assert frozen.tolist() == [1, 1, 5, 1]


def _layouts(oi, ii, out_dim, in_dim, ell=None):
    """The same operator as the JAX package builds it and as the port
    does, and the port's from the JAX arrays."""
    jop = jlg.make_gf2_op(oi, ii, out_dim, in_dim, ell=ell)
    top = tlg.make_gf2_op(oi, ii, out_dim, in_dim, ell=ell)
    arrays = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in vars(jop).items()}
    return jop, top, gf2_op_from_jax(arrays)


@pytest.mark.parametrize("n,ell", [(32, None), (32, 40), (64, 3),
                                   (160, None), (160, 70)])
def test_spmv_gf2_matches_jax(n, ell):
    """ell <= 32: the JAX package's unrolled slab walk; 40 and 70 (two and
    three valid words): its fori loop.  Every forced ell leaves a spill;
    one row is long."""
    i, j, _ = random_sparse(120, 90, 7, seed=n)
    i = np.concatenate([i, np.full(100, 17)])
    j = np.concatenate([j, np.arange(100) % 90])
    for out_dim, in_dim, oi, ii in ((120, 90, i, j), (90, 120, j, i)):
        jop, top, conv = _layouts(oi, ii, out_dim, in_dim, ell)
        assert top.spill_nnz == jop.spill_nnz
        assert top.spill_nnz >= 100 - (ell or 100) or out_dim == 90
        for a, b in ((top.cols, conv.cols), (top.valid, conv.valid),
                     (top.rowptr, conv.rowptr), (top.sp_cols, conv.sp_cols)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert (top.ell, top.nnz) == (conv.ell, conv.nnz)
        x = _words(np.random.default_rng(out_dim), in_dim + 3, n // 32)
        want = np.asarray(jax.jit(partial(jlg.spmv_gf2,
                                          out_rows=out_dim + 5))(
            jop, jnp.asarray(x)))
        got = tlg.spmv_gf2((top,), _t(x), out_dim + 5)
        np.testing.assert_array_equal(_u(got), want)
        assert not want[out_dim:].any()


@pytest.mark.parametrize("n", [32, 160])
@pytest.mark.parametrize("bands", [1, 2, 3, 7])
def test_banded_spmv_gf2_matches_jax(bands, n):
    """The column-banded layout and its plain banded product against the
    JAX package's unbanded spmv_gf2: columns 40..69 hold no entry, so some
    of the 7 bands are empty and most rows miss some band; one row is
    long; out_rows > out_dim."""
    rng = np.random.default_rng(bands * 100 + n)
    i, j, _ = random_sparse(120, 90, 7, seed=bands)
    keep = (j < 40) | (j >= 70)
    i = np.concatenate([i[keep], np.full(60, 17)])
    j = np.concatenate([j[keep], rng.integers(70, 90, 60)])
    for out_dim, in_dim, oi, ii in ((120, 90, i, j), (90, 120, j, i)):
        parts = tlg.make_gf2_bands(oi, ii, out_dim, in_dim, bands)
        assert len(parts) == bands
        assert sum(b.nnz for b in parts) == len(oi)
        for k, b in enumerate(parts):
            lo, hi = in_dim * k // bands, in_dim * (k + 1) // bands
            used = np.concatenate([b.sp_cols.numpy(), b.cols.numpy()[
                tgf2.unpack_bits_np(b.valid.numpy().T, b.ell).T == 1]])
            assert ((used >= lo) & (used < hi)).all()
        if out_dim == 120:
            assert min(b.nnz for b in parts) == 0 or bands < 7
        x = _words(rng, in_dim + 3, n // 32)
        x[:, 0] |= np.uint32(1 << 31)
        jop = jlg.make_gf2_op(oi, ii, out_dim, in_dim)
        want = np.asarray(jax.jit(partial(jlg.spmv_gf2,
                                          out_rows=out_dim + 5))(
            jop, jnp.asarray(x)))
        got = tlg.spmv_gf2(parts, _t(x), out_dim + 5)
        np.testing.assert_array_equal(_u(got), want)
        assert not want[out_dim:].any()


@pytest.mark.parametrize("in_dim,W,l2,bands", [
    (300_000, 4, 50 << 20, 1), (3_000_000, 4, 50 << 20, 2),
    (3_000_000, 8, 50 << 20, 4), (2_000_000, 8, 50 << 20, 3),
    (10, 16, None, 1)])
def test_choose_bands_sizes_the_slice_of_x_from_the_l2(in_dim, W, l2, bands):
    assert tlg.choose_bands(in_dim, W, l2) == bands
    if l2:
        assert -(-in_dim // bands) * W * 4 <= l2 * tlg.BAND_L2_SHARE + W * 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose32x2_mirror_is_the_bit_transpose(seed):
    x = _words(np.random.default_rng(seed), 32, 2)
    x[seed] |= np.uint32(1 << 31)
    for col, got in enumerate(tgf2.transpose32x2_np(x[:, 0], x[:, 1])):
        bits = tgf2.unpack_bits_np(x[:, col:col + 1], 32)
        np.testing.assert_array_equal(
            tgf2.unpack_bits_np(got[:, None], 32), bits.T)


@pytest.mark.parametrize("n", [32, 64, 160, 512])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 1000])
def test_gram_gf2_tile_mirror_matches_jax(N, n):
    """The gram_gf2 kernel's K-tiles, transposes, mma fragments and parity
    packing (ops/gf2.py::gram_gf2_tiles_np) against the JAX package's
    gram_gf2, with bit 31 set in every word."""
    rng = np.random.default_rng(N * 7 + n)
    v, av = _words(rng, N, n // 32), _words(rng, N, n // 32)
    v |= np.uint32(1 << 31)
    av |= np.uint32(1 << 31)
    want = np.asarray(jax.jit(jgf2.gram_gf2, static_argnums=2)(
        jnp.concatenate([jnp.asarray(v), jnp.asarray(av)], axis=1),
        jnp.asarray(av), 2 * n))
    got = tgf2.gram_gf2_tiles_np(v, av)
    assert got.shape == (2 * n, n // 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [32, 64, 128, 160, 256, 512])
@pytest.mark.parametrize("N", [1, 37, 1013])
def test_orthogonalize_gf2_tile_mirror_matches_jax(N, n):
    """The orthogonalize_gf2 kernel's rhs transpose, fragments, K-step
    padding, packing, reduce-scatter and selects
    (ops/gf2.py::orthogonalize_gf2_tiles_np) against the JAX package's
    orthogonalize_gf2, with bit 31 set in v and p and N a multiple of no
    tile."""
    rng = np.random.default_rng(N * 11 + n)
    W = n // 32
    v, p, av = (_words(rng, N, W) for _ in range(3))
    v |= np.uint32(1 << 31)
    p |= np.uint32(1 << 31)
    vtAv, vtAAv, winv = (_words(rng, n, W) for _ in range(3))
    d = rng.integers(0, 2, n).astype(np.uint32)
    d[:2] = (0, 1)
    rhs = tgf2.orthogonalize_rhs_gf2(_t(vtAv), _t(vtAAv), _t(winv),
                                     torch.from_numpy(d.astype(np.int32)), n)
    jv, jp = (np.asarray(a) for a in jax.jit(
        jlg.orthogonalize_gf2, static_argnums=7)(
            *(jnp.asarray(a) for a in (v, av, p, d, vtAv, vtAAv, winv)), n))
    gv, gp = tgf2.orthogonalize_gf2_tiles_np(v, p, av, rhs.numpy(), d)
    np.testing.assert_array_equal(gv, jv)
    np.testing.assert_array_equal(gp, jp)


def _nonsymmetric_d_differs(rng, n):
    """A dense non-symmetric bit matrix (density 1/2) whose phase-2 pivots
    differ from phase 1's, drawn until one does."""
    for _ in range(50):
        U = tgf2.pack_bits_np(rng.integers(0, 2, size=(n, n)))
        Ut = _t(U)
        _, _, d1, _ = tgf2._eliminate_plain(Ut, torch.zeros_like(Ut))
        _, d, _ = tgf2.semi_inverse_gf2_core(Ut, n)
        if not torch.equal(d, d1):
            return U
    raise AssertionError("no matrix with d != d1 drawn")


@pytest.mark.parametrize("n", [32, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("kind", ["low-rank", "full-rank", "d-not-d1"])
def test_semi_inverse_gf2_warp_mirror_matches_jax(n, kind):
    """The semi_inverse_gf2 kernel's one-warp elimination (keys, the lane's
    tracked row, the pivot row from its lane, the pos swaps, M's words from
    j's on; ops/gf2.py::semi_inverse_gf2_warp_np) against the JAX
    package's semi_inverse_gf2 at every width the kernel or its sweeps
    build it for (W <= 8)."""
    rng = np.random.default_rng(n * 13 + len(kind))
    if kind == "d-not-d1":
        U = _nonsymmetric_d_differs(rng, n)
    elif kind == "full-rank":
        L = np.tril(rng.integers(0, 2, size=(n, n)), -1) + np.eye(n, dtype=int)
        U = tgf2.pack_bits_np((L @ L.T) % 2)
    else:
        U = tgf2.pack_bits_np(_sym_bits(rng, n, n // 3))
    jw, jd, jnpiv = (np.asarray(a) for a in jax.jit(
        jgf2.semi_inverse_gf2, static_argnums=1)(jnp.asarray(U), n))
    winv, d, npiv = tgf2.semi_inverse_gf2_warp_np(U)
    np.testing.assert_array_equal(winv, jw)
    np.testing.assert_array_equal(d, jd)
    assert npiv == int(jnpiv)
    if kind == "full-rank":
        assert npiv == n


def test_spmv_gf2_empty_spill_and_empty_operator():
    op = tlg.make_gf2_op(np.arange(60) % 20, np.arange(60) % 7, 20, 7)
    assert op.spill_nnz == 0 and op.ell == 3
    x = _words(np.random.default_rng(1), 7, 2)
    jop = jlg.make_gf2_op(np.arange(60) % 20, np.arange(60) % 7, 20, 7)
    np.testing.assert_array_equal(
        _u(tlg.spmv_gf2((op,), _t(x), 24)),
        np.asarray(jlg.spmv_gf2(jop, jnp.asarray(x), 24)))
    empty = tlg.make_gf2_op(np.zeros(0, int), np.zeros(0, int), 5, 4)
    assert not tlg.spmv_gf2((empty,), _t(x[:4]), 8).any()


DEDUP_CASES = [
    # (i, j, nrows, ncols, right): empty lines only, all empty, duplicates
    (np.array([0, 1, 2, 3, 0, 4, 1, 5, 2, 6]),
     np.array([0, 0, 1, 1, 2, 2, 3, 4, 5, 5]), 40, 10, False),
    (np.array([], np.int64), np.array([], np.int64), 8, 6, True),
    (np.array([0, 0, 1, 1, 2]), np.array([0, 3, 0, 3, 1]), 5, 4, True),
    (np.array([0, 1, 0, 1, 2, 3, 3]), np.array([0, 0, 2, 2, 1, 3, 5]),
     4, 7, False),
]


@pytest.mark.parametrize("case", range(len(DEDUP_CASES)))
def test_dedup_lines_matches_jax(case):
    i, j, nr, nc, right = DEDUP_CASES[case]
    got = tgf2.dedup_lines(i, j, nr, nc, right)
    want = jgf2.dedup_lines(i, j, nr, nc, right)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if got[4] == 0:                       # passthrough: the same arrays
        assert got[0] is i and got[1] is j and got[2:] == (nr, nc, 0, 0)
    else:
        assert got[4] > 0 and (got[2] < nr if right else got[3] < nc)


def test_gf2_width_limits():
    with pytest.raises(ValueError, match="n % 32"):
        tgf2.words(48)
    with pytest.raises(ValueError, match="n <= 512"):
        tgf2.check_width(544)
    assert tgf2.check_width(512) == 16


def test_kernel_constants_match_the_python():
    cuh = (kernels.CSRC / "gf2.cuh").read_text()
    assert int(re.search(r"#define GF2_MAXN (\d+)", cuh).group(1)) \
        == tgf2.MAX_N
    gram = (kernels.CSRC / "gram_gf2.cu").read_text()
    assert "#define GG_TICKET (2 * GF2_MAXN * GF2_MAXW)" in gram
    assert int(re.search(r"#define GG_K (\d+)", gram).group(1)) == tgf2.GG_K
    for name in ("GG_REGION_A", "GG_REGION_B"):
        assert int(re.search(rf"#define {name} (\d+)", gram).group(1)) \
            == getattr(tgf2, name)
    assert tgf2._GRAM_SCRATCH == 2 * tgf2.MAX_N * (tgf2.MAX_N // 32) + 1
    ortho = (kernels.CSRC / "orthogonalize_gf2.cu").read_text()
    assert int(re.search(r"#define OG_ROWS (\d+)", ortho).group(1)) \
        == tgf2.OG_ROWS
    si = (kernels.CSRC / "semi_inverse_gf2.cu").read_text()
    assert int(re.search(r"#define SI2_WARP_MAXW (\d+)", si).group(1)) \
        == tgf2.SI2_WARP_MAXW
    assert re.search(r"#define SI2_NO_PIVOT (0x[0-9a-f]+)", si).group(1) \
        == hex(tgf2._NO_PIVOT)
    for name in ("spmv_gf2", "gram_gf2", "semi_inverse_gf2",
                 "orthogonalize_gf2"):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}(' in src
        assert kernels.SIGNATURES[name][0] == name


@pytest.mark.parametrize("key,wrapper", [
    ("void spmv_gf2_kernel<4>(int const*, ...)", "spmv_gf2"),
    ("void gram_gf2_kernel<4>(int const*, ...)", "gram_gf2"),
    ("semi_inverse_gf2_kernel(int const*, int, ...)", "semi_inverse_gf2"),
    ("void orthogonalize_gf2_mma_kernel<8>(int*, ...)", "orthogonalize_gf2"),
    ("final_unpack_kernel(unsigned int const*, long long, ...)",
     "final_unpack"),
])
def test_profile_solve_maps_gf2_kernels_to_wrappers(key, wrapper):
    from block_lanczos_tpu_torch.utils import profile_solve as ps
    assert ps.wrapper_of(ps.kernel_name(key), tlg.launch_counts()) == wrapper
