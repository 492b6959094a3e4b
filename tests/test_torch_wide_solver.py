"""The port's wide-field solver (CPU tensors: the plain versions of the four
wide kernels) against the JAX package's BlockLanczosWide, bit for bit:

  * 5 whole iterations from the same v0 against JAX iteration_step, all ten
    outputs equal at every iteration;
  * whole solves: left at 2^61 - 1 through both CLIs (the port's kernel
    file byte-identical to the JAX CLI's --single one, and the port's
    checker prints OK on it), right at a 55-bit prime;
  * a resume from a JAX wide state (convert.wide_state_from_numpy);
  * the wide solver at narrow primes equal to the port's narrow solver;
  * the CLI's caps, salvage at a wide prime, and the host loop's
    invariant-failure message.

Each JAX solve runs once per module (fixtures): they compile for seconds.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from block_lanczos_tpu.models import lanczos_wide as jlw
from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu.utils import salvage as jsalvage
from block_lanczos_tpu_torch.convert import wide_state_from_numpy
from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.models import lanczos_wide as tlw
from block_lanczos_tpu_torch.ops import semi_inverse as tsi
from block_lanczos_tpu_torch.utils import checker as tchecker
from block_lanczos_tpu_torch.utils import cli as tcli
from block_lanczos_tpu_torch.utils import gen
from block_lanczos_tpu_torch.utils import mmio as tmmio
from block_lanczos_tpu_torch.utils import salvage as tsalvage

P55 = 36028797018963913
P61 = (1 << 61) - 1
N_BLOCK = 4


def write_matrix(path, p, nrows, ncols, density, seed):
    """A sparse matrix file with values over the full wide range, some of
    them negative or above p (the loader reduces them)."""
    rng = np.random.default_rng(seed)
    i, j, _ = gen.random_sparse(nrows, ncols, density, seed=seed)
    x = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, len(i))]
    x[0], x[1] = -1, p + 5
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{nrows} {ncols} {len(x)}\n")
        for a, b, c in zip(i, j, x):
            fh.write(f"{a + 1} {b + 1} {c}\n")
    return path


@pytest.fixture(scope="module")
def left(tmp_path_factory):
    """The left-kernel case at 2^61 - 1: the matrix file and the JAX CLI's
    kernel file (--single: the JAX BlockLanczosWide)."""
    d = tmp_path_factory.mktemp("wide_left")
    mtx = write_matrix(str(d / "m.mtx"), P61, 96, 64, 5, seed=7)
    out = str(d / "jax.kernel.mtx")
    assert jcli.main(["--matrix", mtx, "--prime", str(P61), "--n",
                      str(N_BLOCK), "--single", "--output-file", out]) == 0
    return mtx, out


def _unpair(a):
    return jgw.np_unpair(np.asarray(a)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_iterates(left):
    """The JAX solver's first five iterations from its v0: the ten outputs
    of each iteration_step."""
    mtx, _ = left
    js = jlw.BlockLanczosWide(jmmio.load_mtx(mtx, P61), n=N_BLOCK)
    step = jax.jit(partial(jlw.iteration_step, js.f, js.mp_rows, js.np_rows,
                           True))
    v = js.initial_block()
    v0 = np.asarray(v)
    p = jnp.zeros((js.np_rows, N_BLOCK, 2), jnp.uint32)
    outs = []
    for _ in range(5):
        out = step(js.first_op, js.second_op, v, p)
        outs.append([np.asarray(o) for o in out])
        v, p = out[0], out[1]
    return v0, outs


def test_five_iterations_match_jax(left, jax_iterates):
    mtx, _ = left
    v0, outs = jax_iterates
    ts = tlw.BlockLanczosWide(tmmio.load_mtx(mtx, P61), n=N_BLOCK,
                              device="cpu")
    v = ts.initial_block()
    np.testing.assert_array_equal(v.numpy(), _unpair(v0))
    p = torch.zeros_like(v)
    state = tsi.new_state("cpu")
    scalars = (8, 9)                     # stop, inv_ok: booleans
    for it, want in enumerate(outs):
        got = tlw.iteration_step(ts.f, ts.mp_rows, ts.np_rows, True,
                                 ts.first_op, ts.second_op, v, p, state)
        assert len(got) == len(want) == 10
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w) if k in scalars or k == 7 else _unpair(w)
            np.testing.assert_array_equal(
                g.numpy().astype(np.int64), w.astype(np.int64),
                err_msg=f"iteration {it}, output {k}")
    assert state.tolist() == [0, 1, 5, 0]


def test_left_solve_through_both_clis(left, tmp_path, capsys):
    """The port's CLI on the CPU writes the JAX CLI's kernel file byte for
    byte, and the port's checker prints OK on it."""
    mtx, jax_out = left
    out = str(tmp_path / "torch.kernel.mtx")
    assert tcli.main(["--matrix", mtx, "--prime", str(P61), "--n",
                      str(N_BLOCK), "--output-file", out,
                      "--device", "cpu"]) == 0
    assert "wide field (p > 2^30)" in capsys.readouterr().err
    with open(out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    assert tchecker.main(["--matrix", mtx, "--kernel", out, "--prime",
                          str(P61)]) == 0
    assert capsys.readouterr().out.strip().endswith("OK")


def test_resume_from_jax_state(left, jax_iterates):
    """The JAX state after 3 iterations, resumed by the port, ends at the
    JAX CLI's kernel."""
    mtx, jax_out = left
    _, outs = jax_iterates
    jax_state = {"v": outs[2][0], "p": outs[2][1], "iteration": 3}
    st = wide_state_from_numpy(jax_state, "cpu")
    assert st["v"].dtype == torch.int64 and st["iteration"] == 3
    ts = tlw.BlockLanczosWide(tmmio.load_mtx(mtx, P61), n=N_BLOCK,
                              device="cpu")
    got = ts.solve(resume_state=st)
    full = tlw.BlockLanczosWide(tmmio.load_mtx(mtx, P61), n=N_BLOCK,
                                device="cpu").solve()
    assert got.v_nonzero and got.product_zero
    assert got.iterations == full.iterations
    assert got.kernel.dtype == np.uint64
    _, _, want = jmmio.read_array_mtx(jax_out)
    np.testing.assert_array_equal(got.kernel, want.astype(np.uint64))
    np.testing.assert_array_equal(full.kernel, got.kernel)


def test_wide_state_from_numpy_unpermutes_rowmap():
    vals = np.array([[5, (1 << 61) + 7], [P61 - 1, 0], [3, 1 << 40],
                     [1 << 33, 2]], dtype=object)
    rowmap = np.array([2, 0, -1, 1])
    st = wide_state_from_numpy({"v": jgw.np_pair(vals),
                                "p": jgw.np_pair(vals), "iteration": 7,
                                "rowmap": rowmap}, "cpu")
    assert st["iteration"] == 7
    np.testing.assert_array_equal(st["v"].numpy(),
                                  vals[[1, 3, 0]].astype(np.int64))
    with pytest.raises(ValueError, match="2\\^62"):
        wide_state_from_numpy({"v": jgw.np_pair(np.array([[1 << 62]],
                                                         dtype=object)),
                               "p": jgw.np_pair(np.array([[0]],
                                                         dtype=object)),
                               "iteration": 0}, "cpu")


def test_right_solve_matches_jax(tmp_path):
    mtx = write_matrix(str(tmp_path / "r.mtx"), P55, 64, 96, 5, seed=11)
    want = jlw.BlockLanczosWide(jmmio.load_mtx(mtx, P55), n=N_BLOCK,
                                right=True).solve()
    got = tlw.BlockLanczosWide(tmmio.load_mtx(mtx, P55), n=N_BLOCK,
                               right=True, device="cpu").solve()
    assert want.v_nonzero and want.product_zero
    assert got.v_nonzero and got.product_zero
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.kernel, want.kernel)
    assert tchecker.check_kernel_block(mtx, got.kernel, P55, right=True)


@pytest.mark.parametrize("p,n", [(65537, 4), (gen.BENCH_PRIME, 3),
                                 (3, 2)])
def test_wide_matches_narrow_at_a_narrow_prime(p, n):
    """The same prime through both fields' solvers: the same iterations,
    v and p after a stop, and the same whole solve."""
    i, j, x = gen.random_sparse(80, 56, 4, seed=p % 101)
    Mn = tmmio.COOMatrix(80, 56, len(x), i.astype(np.int32),
                         j.astype(np.int32), (x % p).astype(np.uint32), p)
    Mw = tmmio.COOMatrix(80, 56, len(x), i.astype(np.int32),
                         j.astype(np.int32), (x % p).astype(np.uint64), p)
    last = {}

    def grab(key):
        def on_iteration(slv, iteration, v, p_blk, start):
            last[key] = (v.clone(), p_blk.clone(), iteration)
        return on_iteration

    tl.BlockLanczos(Mn, n=n, device="cpu").solve(stop_after=9,
                                                 on_iteration=grab("n"))
    tlw.BlockLanczosWide(Mw, n=n, device="cpu").solve(
        stop_after=9, on_iteration=grab("w"))
    (nv, npb, nit), (wv, wpb, wit) = last["n"], last["w"]
    assert nit == wit == 9
    assert torch.equal(nv.long(), wv) and torch.equal(npb.long(), wpb)
    rn = tl.BlockLanczos(Mn, n=n, device="cpu").solve()
    rw = tlw.BlockLanczosWide(Mw, n=n, device="cpu").solve()
    assert rn.iterations == rw.iterations
    assert rn.product_zero == rw.product_zero
    np.testing.assert_array_equal(rn.kernel.astype(np.uint64), rw.kernel)


def test_cli_wide_caps(tmp_path, capsys):
    """p >= 2^62 exits 1, n above the wide kernels' cap exits 2, both
    before the (absent) matrix is loaded; --help states the cap."""
    absent = str(tmp_path / "absent.mtx")
    assert tcli.main(["--matrix", absent, "--prime", str((1 << 62) + 135),
                      "--n", "4", "--device", "cpu"]) == 1
    assert "capped at 2**62 - 1" in capsys.readouterr().err
    assert tcli.main(["--matrix", absent, "--prime", str(P61), "--n",
                      str(tlw.MAX_N + 1)]) == 2
    err = capsys.readouterr().err
    assert f"n <= {tlw.MAX_N}" in err and "wide field" in err
    text = " ".join(tcli.build_parser().format_help().split())
    assert f"n <= {tlw.MAX_N} in the wide field" in text


def test_salvage_at_a_wide_prime_matches_jax():
    """The CLI's --salvage on a wide block: the port's salvage_kernel
    (Python ints above 2^30) against the JAX package's."""
    p = P61
    rng = np.random.default_rng(5)
    N, m, n = 30, 25, 4
    K = (rng.integers(0, 1 << 62, (N, n)) % p).astype(np.uint64)
    B = rng.integers(0, 1 << 62, (m, 2)).astype(object) % p
    C = rng.integers(0, 1 << 62, (2, n)).astype(object) % p
    vtM = ((B @ C) % p).astype(np.uint64)        # rank 2: 2 kernel combos
    got = tsalvage.salvage_kernel(K, vtM, p)
    want = jsalvage.salvage_kernel(K, vtM, p)
    assert got.shape == want.shape == (N, 2)
    np.testing.assert_array_equal(got, want)


def test_failed_invariant_raises_with_the_host_message(monkeypatch):
    i, j, x = gen.random_sparse(60, 40, 4, seed=2)
    M = tmmio.COOMatrix(60, 40, len(x), i.astype(np.int32),
                        j.astype(np.int32), (x % P61).astype(np.uint64), P61)
    real = tlw.wo.gram_wide

    def skewed_gram(v, av, f, out=None):
        g = real(v, av, f, out)
        g[-1, 0] = (g[-1, 0] + 1) % f.p      # vtAAv no longer symmetric
        return g

    monkeypatch.setattr(tlw.wo, "gram_wide", skewed_gram)
    with pytest.raises(AssertionError, match="vtAAv not symmetric"):
        tlw.BlockLanczosWide(M, n=4, device="cpu").solve()
    tlw.BlockLanczosWide(M, n=4, device="cpu",
                         check_invariants=False).solve(stop_after=2)
    with pytest.raises(ValueError, match="block width"):
        tlw.BlockLanczosWide(M, n=tlw.MAX_N + 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlw.BlockLanczosWide(M, n=4)
