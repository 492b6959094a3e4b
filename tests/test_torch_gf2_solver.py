"""The port's GF(2) solver against the JAX package's BlockLanczosGF2, bit
for bit (CPU tensors, so the plain versions of the four GF(2) kernels).

  * the orthogonalize step against orthogonalize_gf2, and the halt;
  * 5 whole iterations from the same v0 on one shared layout (the JAX
    operators carried over by convert.gf2_op_from_jax), all ten outputs
    equal at every iteration;
  * whole solves, left and right, n = 32 and 64, dedup on and off,
    including the seed-9 instance whose reference operator breaks down,
    and on operators split into 2, 3 and 7 column bands;
  * a resume from a JAX GF(2) state (convert.gf2_state_from_numpy);
  * left_p2_n32 byte-identical to its golden kernel file;
  * salvage (utils/salvage.py) against the JAX package's, both fields;
  * the GF(2) checker path against the JAX package's checker.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos_gf2 as jlg
from block_lanczos_tpu.utils import checker as jchecker
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu.utils import salvage as jsalvage
from block_lanczos_tpu.utils.gen import random_sparse
from block_lanczos_tpu_torch.convert import (gf2_op_from_jax,
                                             gf2_state_from_numpy)
from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.models import lanczos_gf2 as tlg
from block_lanczos_tpu_torch.ops import gf2 as tgf2
from block_lanczos_tpu_torch.ops.semi_inverse import new_state
from block_lanczos_tpu_torch.utils import checker, mmio, salvage

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _coo(i, j, x, nrows, ncols):
    args = (nrows, ncols, len(x), np.asarray(i, np.int32),
            np.asarray(j, np.int32), (np.asarray(x) % 2).astype(np.uint32), 2)
    return jmmio.COOMatrix(*args), mmio.COOMatrix(*args)


def _seed9():
    """The 64 x 96 p = 2 instance whose right-kernel solve breaks down on
    the reference's operator (tests/test_salvage.py of the JAX package)."""
    i, j, x = random_sparse(64, 96, 5, seed=9)
    return _coo(i, j, x, 64, 96)


def _dup_columns():
    """300 x 210 with columns 200..209 copies of columns 0..9: duplicate
    lines on the left-kernel side, so dedup compacts."""
    i, j, x = random_sparse(300, 200, 6, seed=3)
    x = x | 1
    cp = j < 10
    return _coo(np.concatenate([i, i[cp]]), np.concatenate([j, j[cp] + 200]),
                np.concatenate([x, x[cp]]), 300, 210)


def _u(t):
    return t.numpy().view(np.uint32)


def test_orthogonalize_gf2_matches_jax_and_halts():
    rng = np.random.default_rng(3)
    N, n, W = 40, 64, 2
    v, av, pb = (rng.integers(0, 1 << 32, (N, W), dtype=np.uint64)
                 .astype(np.uint32) for _ in range(3))
    B = rng.integers(0, 2, (n, 40))
    vtAv = tgf2.pack_bits_np((B @ B.T) % 2)
    C = rng.integers(0, 2, (n, n))
    vtAAv = tgf2.pack_bits_np((C @ C.T) % 2)
    state = new_state("cpu")
    si = tgf2.semi_inverse_gf2(torch.from_numpy(
        np.concatenate([vtAv, vtAAv]).view(np.int32)), state)
    assert int(si.d.sum()) < n
    j = jnp.asarray
    want_v, want_p = jax.jit(jlg.orthogonalize_gf2, static_argnums=7)(
        j(v), j(av), j(pb), j(si.d.numpy().astype(np.uint32)), j(vtAv),
        j(vtAAv), j(_u(si.winv)), n)
    tv, tp = (torch.from_numpy(a.view(np.int32).copy()) for a in (v, pb))
    tav = torch.from_numpy(av.view(np.int32))
    tlg.orthogonalize_gf2(tv, tp, tav, si.rhs, si.d, state)
    np.testing.assert_array_equal(_u(tv), np.asarray(want_v))
    np.testing.assert_array_equal(_u(tp), np.asarray(want_p))
    assert state.tolist() == [0, 1, 1, 0]
    state[0] = 1                    # a latched stop: v and p stay frozen
    before = (tv.clone(), tp.clone())
    for _ in range(3):
        tlg.orthogonalize_gf2(tv, tp, tav, si.rhs, si.d, state)
    assert torch.equal(tv, before[0]) and torch.equal(tp, before[1])
    assert state.tolist() == [1, 1, 2, 1]


def _ops_from_jax(js):
    def conv(op):
        return gf2_op_from_jax({k: (np.asarray(v) if hasattr(v, "shape")
                                    else v) for k, v in vars(op).items()})
    return (conv(js.first_op),), (conv(js.second_op),)


@pytest.mark.parametrize("right", [False, True])
def test_five_iterations_match_jax_on_a_shared_layout(right):
    jM, _ = _dup_columns()
    n = 32
    js = jlg.BlockLanczosGF2(jM, n=n, right=right)
    first, second = _ops_from_jax(js)
    step = jax.jit(partial(jlg.iteration_step, js.first_op, js.second_op, n,
                           js.mp_rows, js.np_rows, True))
    jv = js.initial_block()
    jp = jnp.zeros((js.np_rows, n // 32), jnp.uint32)
    tv = torch.from_numpy(np.asarray(jv).view(np.int32).copy())
    tp = torch.zeros_like(tv)
    state = new_state("cpu")
    for it in range(5):
        want = step(jv, jp)
        got = tlg.iteration_step(n, js.mp_rows, js.np_rows, True, first,
                                 second, tv, tp, state)
        assert len(got) == len(want) == 10
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            g = g.numpy()
            if g.dtype == np.int32:
                g = g.view(np.uint32)
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=f"iteration {it}, "
                                                  f"output {k}")
        jv, jp = want[0], want[1]
    assert state.tolist() == [0, 1, 5, 0]


SOLVES = [  # (instance, n, right, dedup)
    ("dup", 32, False, True), ("dup", 32, True, False),
    ("dup", 64, False, False), ("dup", 64, True, True),
    ("seed9", 32, True, False), ("seed9", 32, True, True),
]


@pytest.mark.parametrize("inst,n,right,dedup", SOLVES,
                         ids=[f"{a}-n{b}-{'right' if c else 'left'}-"
                              f"{'dedup' if d else 'nodedup'}"
                              for a, b, c, d in SOLVES])
def test_solve_matches_jax(inst, n, right, dedup):
    jM, tM = _seed9() if inst == "seed9" else _dup_columns()
    js = jlg.BlockLanczosGF2(jM, n=n, right=right, dedup=dedup)
    ts = tlg.BlockLanczosGF2(tM, n=n, right=right, dedup=dedup, device="cpu")
    assert ts.dedup_dropped == js.dedup_dropped
    assert (ts.n_eff, ts.m_eff, ts.nnz) == (js.n_eff, js.m_eff, js.nnz)
    if dedup and (inst == "seed9" or not right):
        assert ts.dedup_dropped[0] > 0        # compaction happened
    want, got = js.solve(), ts.solve()
    assert (got.iterations, got.v_nonzero, got.product_zero) == \
        (want.iterations, want.v_nonzero, want.product_zero)
    np.testing.assert_array_equal(got.kernel, want.kernel)
    if want.vtM is None:
        assert got.vtM is None
    else:
        np.testing.assert_array_equal(got.vtM, want.vtM)
    if inst == "seed9":     # the breakdown without dedup, cured with it
        assert got.product_zero is dedup


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("bands", [2, 3, 7])
def test_banded_solve_matches_jax(bands, right):
    """A whole solve on operators split into column bands (the layout the
    solver takes where x outgrows the card's L2) against the JAX package's
    unbanded solve."""
    jM, tM = _dup_columns()
    js = jlg.BlockLanczosGF2(jM, n=32, right=right, dedup=False)
    ts = tlg.BlockLanczosGF2(tM, n=32, right=right, dedup=False, device="cpu")
    fwd = tlg.make_gf2_bands(tM.i, tM.j, tM.nrows, tM.ncols, bands)
    bwd = tlg.make_gf2_bands(tM.j, tM.i, tM.ncols, tM.nrows, bands)
    ts.first_op, ts.second_op = (fwd, bwd) if right else (bwd, fwd)
    want, got = js.solve(), ts.solve()
    assert (got.iterations, got.v_nonzero, got.product_zero) == \
        (want.iterations, want.v_nonzero, want.product_zero)
    np.testing.assert_array_equal(got.kernel, want.kernel)


def test_resume_from_jax_gf2_state():
    jM, tM = _dup_columns()
    n = 32
    js = jlg.BlockLanczosGF2(jM, n=n, sync_every=1)
    captured = {}

    def grab(solver, iteration, v, p_blk, start):
        captured.update(v=np.asarray(v), p=np.asarray(p_blk),
                        iteration=iteration)

    first = js.solve(stop_after=3, on_iteration=grab)
    assert first.iterations == 3 and captured["iteration"] == 3
    jax_state = {k: captured[k] for k in ("v", "p", "iteration")}
    want = js.solve(resume_state=jax_state)
    ts = tlg.BlockLanczosGF2(tM, n=n, device="cpu")
    got = ts.solve(resume_state=gf2_state_from_numpy(jax_state, "cpu"))
    assert got.iterations == want.iterations
    assert got.v_nonzero and got.product_zero == want.product_zero
    np.testing.assert_array_equal(got.kernel, want.kernel)


def test_left_p2_n32_golden_byte_identical(tmp_path):
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    ts = tlg.BlockLanczosGF2(mmio.load_mtx(mtx, 2), n=32, device="cpu")
    res = ts.solve()
    assert res.v_nonzero and res.product_zero
    out = tmp_path / "k.mtx"
    mmio.write_kernel_mtx(str(out), res.kernel, ts.n_eff, 32)
    with open(os.path.join(GOLDEN, "left_p2_n32.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()
    assert checker.check_kernel_file(mtx, str(out), 2)


def test_stop_after_and_adaptive_blocks_agree():
    _, tM = _dup_columns()
    res = tlg.BlockLanczosGF2(tM, n=32, sync_every=2,
                              device="cpu").solve(stop_after=3)
    assert res.iterations == 3 and res.stopped_by_limit
    assert res.v_nonzero is None
    a = tlg.BlockLanczosGF2(tM, n=32, sync_every=3, device="cpu").solve()
    b = tlg.BlockLanczosGF2(tM, n=32, device="cpu").solve()
    assert a.iterations == b.iterations
    np.testing.assert_array_equal(a.kernel, b.kernel)


def test_failed_invariant_raises(monkeypatch):
    _, tM = _dup_columns()
    real = tlg.gram_gf2

    def skewed_gram(v, av, out=None):
        g = real(v, av, out)
        n = g.shape[0] // 2
        g[n + 1, 0] ^= 1 << 5          # vtAAv[1, 5]: no longer symmetric
        return g

    monkeypatch.setattr(tlg, "gram_gf2", skewed_gram)
    with pytest.raises(AssertionError, match=r"invariant check failed \(GF2\)"):
        tlg.BlockLanczosGF2(tM, n=32, device="cpu").solve()
    tlg.BlockLanczosGF2(tM, n=32, device="cpu",
                        check_invariants=False).solve(stop_after=2)


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal is not testable")
    _, tM = _seed9()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlg.BlockLanczosGF2(tM, n=32)
    with pytest.raises(ValueError, match="p == 2"):
        tlg.BlockLanczosGF2(mmio.COOMatrix(2, 2, 0, np.zeros(0, np.int32),
                                           np.zeros(0, np.int32),
                                           np.zeros(0, np.uint32), 3),
                            n=32, device="cpu")
    with pytest.raises(ValueError, match="n % 32"):
        tlg.BlockLanczosGF2(tM, n=48, device="cpu")


def test_salvage_matches_jax_on_the_breakdown():
    """The seed-9 right-kernel solve on the reference's operator ends with
    vt*M != 0; both packages salvage the same verified vectors, and the
    port's checker accepts them."""
    jM, tM = _seed9()
    res = tlg.BlockLanczosGF2(tM, n=32, right=True, dedup=False,
                              check_invariants=False, device="cpu").solve()
    assert res.product_zero is False and res.vtM is not None
    got = salvage.salvage_kernel(res.kernel, res.vtM, 2)
    want = jsalvage.salvage_kernel(res.kernel, res.vtM, 2)
    assert got.shape[1] > 0 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    blocks = [got, got[:, :1], res.kernel[:, :3]]
    np.testing.assert_array_equal(salvage.combine_kernel_blocks(blocks, 2),
                                  jsalvage.combine_kernel_blocks(blocks, 2))
    Mt = jmmio.COOMatrix(tM.ncols, tM.nrows, tM.nnz, tM.j, tM.i, tM.x, 2)
    y = np.zeros((Mt.ncols, got.shape[1]), np.int64)
    for a, b, c in zip(Mt.i, Mt.j, Mt.x):   # x^T M^T over GF(2)
        if c:
            y[b] ^= got[a].astype(np.int64)
    assert not y.any()


def test_salvage_with_restarts_matches_jax():
    """Restarted solves continue the xoshiro stream; both packages combine
    the same exactly-independent vectors."""
    jM, tM = _seed9()
    kw = dict(n=32, right=True, dedup=False, check_invariants=False)
    js = jlg.BlockLanczosGF2(jM, **kw)
    ts = tlg.BlockLanczosGF2(tM, device="cpu", **kw)
    want = jsalvage.salvage_with_restarts(js.solve, js.solve(), 2, 32,
                                          restarts=2)
    got = salvage.salvage_with_restarts(ts.solve, ts.solve(), 2, 32,
                                        restarts=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [3, 65537])
def test_salvage_odd_prime_matches_jax(p):
    rng = np.random.default_rng(p)
    kernel = rng.integers(0, p, (50, 6)).astype(np.uint32)
    vtM = np.zeros((30, 6), np.int64)
    vtM[:, :4] = rng.integers(0, p, (30, 4))      # a 2-dim nullspace
    np.testing.assert_array_equal(salvage.salvage_kernel(kernel, vtM, p),
                                  jsalvage.salvage_kernel(kernel, vtM, p))
    blocks = [kernel[:, :3], (kernel[:, :2].astype(np.int64) * 2 % p)
              .astype(np.uint32), kernel[:, 3:]]
    np.testing.assert_array_equal(salvage.combine_kernel_blocks(blocks, p),
                                  jsalvage.combine_kernel_blocks(blocks, p))


def test_gf2_checker_matches_jax(tmp_path):
    """The bit-packed path against the JAX package's checker, on a block
    wider than one word, its right-kernel form, and with failures."""
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    kern = os.path.join(GOLDEN, "left_p2_n32.kernel.mtx")
    _, _, data = mmio.read_array_mtx(kern)
    x = np.concatenate([data, data[:, :13]], axis=1).astype(np.uint32)
    assert checker.check_kernel_block(mtx, x, 2)
    assert jchecker.check_kernel_block(mtx, x, 2)
    bad = x.copy()
    bad[3, 40] ^= 1
    for mod in (checker, jchecker):
        with pytest.raises(mod.CheckFailure, match="KO: y"):
            mod.check_kernel_block(mtx, bad, 2)
    i, j, v = random_sparse(40, 30, 4, seed=1)
    path = str(tmp_path / "r.mtx")
    mmio.write_coo_mtx(path, 40, 30, i, j, v)
    res = tlg.BlockLanczosGF2(mmio.load_mtx(path, 2), n=32, right=True,
                              device="cpu").solve()
    if res.product_zero:
        assert checker.check_kernel_block(path, res.kernel, 2, right=True)
    with pytest.raises(checker.CheckFailure):
        checker.check_kernel_block(path, np.zeros((30, 32), np.uint32), 2,
                                   right=True)


def test_gf2_and_narrow_p2_iterates_agree():
    """dedup=False keeps the reference's operator: the GF(2) solver's
    iterates unpack to the narrow solver's at p = 2, n = 64."""
    _, tM = _dup_columns()
    g = tlg.BlockLanczosGF2(tM, n=64, dedup=False, device="cpu")
    nw = tl.BlockLanczos(tM, n=64, device="cpu")
    rg, rn = g.solve(), nw.solve()
    assert rg.iterations == rn.iterations
    np.testing.assert_array_equal(rg.kernel, rn.kernel)
