"""The port's solver against the JAX package's, bit for bit (CPU tensors,
so the plain versions of the four kernels).

  * the orthogonalize step against `orthogonalize_device`;
  * 5 whole iterations from the same v0 against JAX `iteration_step`, all
    ten outputs equal at every iteration;
  * a resume through `convert.state_from_numpy` from a JAX state after 3
    iterations, against the JAX solver continuing from the same state;
  * the host loop's halt, stop-after and invariant-failure behaviour.
"""

import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos as jl
from block_lanczos_tpu.ops import gfp as jgfp
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.convert import state_from_numpy
from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.ops import gfp as tgfp
from block_lanczos_tpu_torch.ops import semi_inverse as tsi
from block_lanczos_tpu_torch.utils import mmio as tmmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P = 1073741789


def _golden(name, prime):
    path = os.path.join(GOLDEN, f"{name}.mtx")
    return jmmio.load_mtx(path, prime), tmmio.load_mtx(path, prime)


def _np(a):
    return np.asarray(a).astype(np.int64)


def test_orthogonalize_matches_jax():
    rng = np.random.default_rng(4)
    N, n = 50, 4
    f = jgfp.GFp.make(P)
    v, Av, pb = (rng.integers(0, P, (N, n), dtype=np.int64) for _ in range(3))
    B = rng.integers(0, P, (n, n - 1), dtype=np.int64)
    vtAv = np.zeros((n, n), np.int64)
    for k in range(n - 1):                          # rank-deficient Gram
        vtAv = (vtAv + np.outer(B[:, k], B[:, k]) % P) % P
    vtAAv = (vtAv * 3) % P
    grams = torch.from_numpy(np.concatenate([vtAv, vtAAv]).astype(np.int32))
    state = tsi.new_state("cpu")
    si = tsi.semi_inverse(grams, P, state)
    assert int(si.d.sum()) < n
    u = lambda a: jnp.asarray(np.asarray(a).astype(np.uint32))  # noqa: E731
    want_v, want_p = jl.orthogonalize_device(
        f, u(v), u(Av), u(pb), u(si.d), u(vtAv), u(vtAAv), u(si.winv))
    tv, tp = (torch.from_numpy(a.astype(np.int32)) for a in (v, pb))
    tl.orthogonalize(tv, tp, torch.from_numpy(Av.astype(np.int32)), si.rhs,
                     si.d, P, state)
    np.testing.assert_array_equal(tv.numpy(), _np(want_v))
    np.testing.assert_array_equal(tp.numpy(), _np(want_p))
    assert state.tolist() == [0, 1, 1, 0]
    # a latched stop freezes v and p, counts the probe once, then nothing
    state[tsi.STOP] = 1
    before = tv.clone()
    for _ in range(3):
        tl.orthogonalize(tv, tp, torch.from_numpy(Av.astype(np.int32)),
                         si.rhs, si.d, P, state)
    assert torch.equal(tv, before)
    assert state.tolist() == [1, 1, 2, 1]


def test_five_iterations_match_jax():
    jM, tM = _golden("left_pbig_n4", P)
    n = 4
    js = jl.BlockLanczos(jM, n=n)
    ts = tl.BlockLanczos(tM, n=n, device="cpu")
    step = jax.jit(partial(jl.iteration_step, js.f, js.mp_rows, js.np_rows,
                           True))
    jv = js.initial_block()
    jp = jnp.zeros((js.np_rows, n), jnp.uint32)
    tv = ts.initial_block()
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    tp = torch.zeros((ts.np_rows, n), dtype=torch.int32)
    state = tsi.new_state("cpu")
    for it in range(5):
        want = step(js.first_op, js.second_op, jv, jp)
        got = tl.iteration_step(ts.f, ts.mp_rows, ts.np_rows, True,
                                ts.first_op, ts.second_op, tv, tp, state)
        assert len(got) == len(want) == 10
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(
                g.numpy().astype(np.int64), _np(w),
                err_msg=f"iteration {it}, output {k}")
        jv, jp = want[0], want[1]
    assert state.tolist() == [0, 1, 5, 0]


def test_resume_from_jax_state():
    jM, tM = _golden("left_p65537_n4", 65537)
    n = 4
    js = jl.BlockLanczos(jM, n=n, sync_every=1)
    captured = {}

    def grab(solver, iteration, v, p_blk, start):
        captured.update(v=np.asarray(v), p=np.asarray(p_blk),
                        iteration=iteration)

    first = js.solve(stop_after=3, on_iteration=grab)
    assert first.iterations == 3 and captured["iteration"] == 3
    jax_state = {k: captured[k] for k in ("v", "p", "iteration")}
    want = js.solve(resume_state=jax_state)
    ts = tl.BlockLanczos(tM, n=n, device="cpu")
    got = ts.solve(resume_state=state_from_numpy(jax_state, "cpu"))
    assert got.iterations == want.iterations
    assert got.v_nonzero and got.product_zero
    np.testing.assert_array_equal(got.kernel, want.kernel)


def test_state_from_numpy_unpermutes_rowmap():
    v = np.arange(12, dtype=np.uint32).reshape(6, 2)
    rowmap = np.array([2, 0, -1, 1, -1, 3])
    st = state_from_numpy({"v": v, "p": v, "iteration": 7,
                           "rowmap": rowmap}, "cpu")
    assert st["iteration"] == 7 and st["v"].dtype == torch.int32
    np.testing.assert_array_equal(st["v"].numpy(),
                                  v[[1, 3, 0, 5]].astype(np.int32))


def test_stop_after_and_iteration_counts():
    _, tM = _golden("left_p65537_n4", 65537)
    ts = tl.BlockLanczos(tM, n=4, device="cpu", sync_every=4)
    res = ts.solve(stop_after=6)
    assert res.iterations == 6 and res.stopped_by_limit
    assert res.v_nonzero is None
    full = tl.BlockLanczos(tM, n=4, device="cpu", sync_every=7).solve()
    adaptive = tl.BlockLanczos(tM, n=4, device="cpu").solve()
    assert full.iterations == adaptive.iterations == 20
    np.testing.assert_array_equal(full.kernel, adaptive.kernel)


def test_failed_invariant_raises_with_the_reference_message(monkeypatch):
    _, tM = _golden("left_p65537_n4", 65537)
    real = tl.gram_mod

    def skewed_gram(V1, V2, W, p, out=None):
        g = real(V1, V2, W, p, out)
        g[-1, 0] = (g[-1, 0] + 1) % p      # vtAAv no longer symmetric
        return g

    monkeypatch.setattr(tl, "gram_mod", skewed_gram)
    with pytest.raises(AssertionError, match="vtAAv not symmetric"):
        tl.BlockLanczos(tM, n=4, device="cpu").solve()
    # with the checks off the solve runs on (to whatever end)
    tl.BlockLanczos(tM, n=4, device="cpu",
                    check_invariants=False).solve(stop_after=3)


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal is not testable")
    _, tM = _golden("left_p65537_n4", 65537)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.BlockLanczos(tM, n=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl.resolve_device("cuda")
    assert tl.resolve_device("cpu").type == "cpu"


ORTHO_CASES = ([(P, n) for n in (1, 3, 4, 16, 31, 32, 33, 64)]
               + [(p, n) for p in (2, 3, 65537)
                  for n in (4, 32)])


@pytest.mark.parametrize("p,n", ORTHO_CASES)
def test_orthogonalize_kernel_mirrors_match_jax(p, n):
    """The orthogonalize kernel's arithmetic, through its NumPy mirrors,
    and the port's step (CPU: the plain version) against the JAX package's
    orthogonalize_device: the tensor-core path ([v | p] x rhs over u8 limbs
    from the reduced base) at every n, the row path (lazy sums from the
    base, folded every LAZY_FOLD products) at n <= 8.  v and p rows differ;
    d is rank-deficient; one row is all p - 1."""
    rng = np.random.default_rng(p % 1021 + n)
    N = 21
    f = jgfp.GFp.make(p)
    v, Av, pb = (rng.integers(0, p, (N, n), dtype=np.int64) for _ in range(3))
    v[0], Av[0], pb[0] = p - 1, p - 1, p - 1
    rank = max(n - 1, 1) if n > 1 else 0
    B = rng.integers(0, p, (n, rank), dtype=np.int64)
    vtAv = np.zeros((n, n), np.int64)
    for k in range(rank):
        vtAv = (vtAv + np.outer(B[:, k], B[:, k]) % p) % p
    vtAAv = (vtAv * 3 + 1) % p
    grams = torch.from_numpy(np.concatenate([vtAv, vtAAv]).astype(np.int32))
    si = tsi.semi_inverse(grams, p, tsi.new_state("cpu"))
    u = lambda a: jnp.asarray(np.asarray(a).astype(np.uint32))  # noqa: E731
    want_v, want_p = (_np(w) for w in jl.orthogonalize_device(
        f, u(v), u(Av), u(pb), u(si.d), u(vtAv), u(vtAAv), u(si.winv)))
    d = si.d.numpy().astype(bool)
    rhs = si.rhs.numpy().astype(np.int64)
    assert not rhs[n:, n:].any()            # the block the kernel skips
    base = np.concatenate([np.where(d, Av, v), np.where(d, 0, pb)], axis=1)
    X = np.concatenate([v, pb], axis=1)
    mma = tgfp.limb_matmul_np(X, rhs, p, base).astype(np.int64)
    np.testing.assert_array_equal(mma[:, :n], want_v)
    np.testing.assert_array_equal(mma[:, n:], want_p)
    if n <= 8:
        row = np.array([[tgfp.lazy_dot_int(p, X[r] if c < n else v[r],
                                           rhs[:, c] if c < n else
                                           rhs[:n, c], base[r, c])
                         for c in range(2 * n)] for r in range(N)])
        np.testing.assert_array_equal(row, mma)
    tv, tp = (torch.from_numpy(a.astype(np.int32)) for a in (v, pb))
    state = tsi.new_state("cpu")
    tl.orthogonalize(tv, tp, torch.from_numpy(Av.astype(np.int32)), si.rhs,
                     si.d, p, state)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    np.testing.assert_array_equal(tp.numpy(), want_p)
    assert state.tolist() == [0, 1, 1, 0]


def test_orthogonalize_kernel_threshold_matches_the_source():
    from block_lanczos_tpu_torch import kernels
    src = (kernels.CSRC / "orthogonalize.cu").read_text()
    m = re.search(r"#define ORTHO_MMA_MIN_N (\d+)", src)
    assert m and int(m.group(1)) == tl.ORTHO_MMA_MIN_N
    assert int(re.search(r"#define ORTHO_MAX_N (\d+)", src).group(1)) \
        == tsi.MAX_N
