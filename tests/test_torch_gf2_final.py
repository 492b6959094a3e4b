"""GF(2)'s final step on the card (csrc/gf2_final.cu, ops/gf2.py::
final_unpack), through its NumPy mirror on the CPU and, marked `card`, the
kernel itself on a CUDA card:

  * final_unpack_np's block and flags are unpack_bits_np's block and
    final_check's answers, at n = 32 .. 256, with padding rows that hold
    set bits and n_eff / m_eff below the padded row counts;
  * an all-zero v gives v != 0 false; one set bit in tmp's last counted row
    fails the check with the host path's vtM; a set bit in tmp's padding
    is ignored; without tmp only v is written;
  * the solver's card path (BlockLanczosGF2._final_card, its launches
    emulated through the entry point's pointers) returns the host path's
    SolveResult, its verbose lines and vtM, with final.unpack's device
    "cuda" and one final_unpack_device a solve; the CPU solver keeps the
    NumPy path (device "cpu", no such count);
  * on a card: the kernel equals the mirror bit for bit, failure path's vtM
    included, and a solve's card path equals its host path.

The card tests import no JAX: on the chip run this file alone, without the
suite's conftest (which imports JAX):
    python -m pytest --noconftest tests/test_torch_gf2_final.py -m card
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.models import lanczos_gf2
from block_lanczos_tpu_torch.models.lanczos import final_check
from block_lanczos_tpu_torch.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu_torch.ops import gf2
from block_lanczos_tpu_torch.utils import gen, mmio, profiling

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernel on the chip")
    return torch.device("cuda")


def random_words(rng, rows, W):
    """(rows, W) int32 words, every bit random (bit 31 included)."""
    return rng.integers(0, 1 << 32, size=(rows, W),
                        dtype=np.uint64).astype(np.uint32).view(np.int32)


def host_path(v, tmp, n_eff, m_eff, n):
    """The solver's NumPy final step: unpack_bits_np, then final_check."""
    v_bits = gf2.unpack_bits_np(v, n)
    kernel = v_bits[:n_eff]
    if tmp is None:
        return kernel, None, None, None
    tmp_bits = gf2.unpack_bits_np(tmp, n)
    v_nonzero, product_zero = final_check(v_bits, tmp_bits, n_eff, m_eff,
                                          verbose=False)
    return kernel, v_nonzero, product_zero, (
        None if product_zero else tmp_bits[:m_eff])


def mirror_path(v, tmp, n_eff, m_eff, n):
    """The same answers from final_unpack_np (tmp's bits by a second call
    only on a failed check, as the solver's card path does)."""
    kernel, flags = gf2.final_unpack_np(v, tmp, n_eff, m_eff, n)
    if tmp is None:
        return kernel, None, None, None
    v_nonzero, product_zero = bool(flags[0]), not flags[1]
    vtM = None if product_zero else gf2.final_unpack_np(tmp, None, m_eff, 0,
                                                        n)[0]
    return kernel, v_nonzero, product_zero, vtM


def same(a, b):
    """Two final steps' answers equal, arrays in dtype, shape and layout."""
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype == np.uint32
            assert x.shape == y.shape and x.flags.c_contiguous
            assert np.array_equal(x, y)
        else:
            assert x == y and type(x) is type(y)


@pytest.mark.parametrize("n", [32, 64, 128, 256])
@pytest.mark.parametrize("rows,n_eff,m_eff", [
    (8, 8, 8), (16, 13, 9), (136, 129, 130), (1032, 1027, 1001)])
def test_mirror_matches_unpack_and_final_check(n, rows, n_eff, m_eff):
    """Random words, padding rows full of set bits: the mirror's block is
    unpack_bits_np's first n_eff rows, its flags final_check's answers."""
    rng = np.random.default_rng(n * 1000 + rows)
    W = n // 32
    v, tmp = random_words(rng, rows, W), random_words(rng, rows, W)
    same(mirror_path(v, tmp, n_eff, m_eff, n),
         host_path(v, tmp, n_eff, m_eff, n))
    tmp[:m_eff] = 0                      # v^T M = 0 but for the padding
    got = mirror_path(v, tmp, n_eff, m_eff, n)
    assert got[2] is True and got[3] is None
    same(got, host_path(v, tmp, n_eff, m_eff, n))


@pytest.mark.parametrize("n", [32, 128])
def test_zero_v_and_one_bit_in_tmp(n):
    W, rows, n_eff, m_eff = n // 32, 24, 21, 17
    v = np.zeros((rows, W), np.int32)
    v[n_eff:] = -1                       # set bits in the padding only
    tmp = np.zeros((rows, W), np.int32)
    tmp[m_eff:] = -1
    got = mirror_path(v, tmp, n_eff, m_eff, n)
    assert got[1] is False and got[2] is True     # v == 0; padding ignored
    same(got, host_path(v, tmp, n_eff, m_eff, n))
    tmp[m_eff - 1, W - 1] = np.int32(-(1 << 31))  # bit 31 of the last word
    got = mirror_path(v, tmp, n_eff, m_eff, n)
    assert got[2] is False and got[3].sum() == 1 and got[3][-1, -1] == 1
    same(got, host_path(v, tmp, n_eff, m_eff, n))


def test_without_tmp_only_v():
    rng = np.random.default_rng(5)
    v = random_words(rng, 40, 4)
    bits, flags = gf2.final_unpack_np(v, None, 37, 40, 128)
    assert bits.shape == (37, 128) and list(flags) == [1, 0]
    assert np.array_equal(bits, gf2.unpack_bits_np(v, 128)[:37])
    _, flags = gf2.final_unpack_np(np.zeros_like(v), None, 37, 0, 128)
    assert list(flags) == [0, 0]


def test_kernel_constants_and_signature():
    src = (kernels.CSRC / "gf2_final.cu").read_text()
    assert int(re.search(r"#define FU_TILE (\d+)", src).group(1)) \
        == gf2.FU_TILE
    name, argtypes = kernels.SIGNATURES["final_unpack"]
    assert name == "final_unpack" and len(argtypes) == 8
    assert kernels.SOURCES["final_unpack"] == "gf2_final"
    assert 'extern "C" int final_unpack(' in src


# ---------------------------------------------------------------------------
# The solver's card path on the CPU, its launches emulated
# ---------------------------------------------------------------------------

def _host_array(ptr, n):
    if n == 0:
        return np.zeros(0, np.int32)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), shape=(n,))


def emulated_launch(name, v_ptr, tmp_ptr, n_eff, m_eff, W, out_ptr,
                    flags_ptr):
    """kernels.launch("final_unpack", ...) on CPU tensors: the mirror reads
    v and tmp and writes the block and the flags through the pointers."""
    assert name == "final_unpack"
    n = 32 * W
    v = _host_array(v_ptr, n_eff * W).reshape(n_eff, W)
    tmp = (None if tmp_ptr is None
           else _host_array(tmp_ptr, m_eff * W).reshape(m_eff, W))
    bits, flags = gf2.final_unpack_np(v, tmp, n_eff, m_eff, n)
    _host_array(out_ptr, n_eff * n)[:] = bits.reshape(-1).view(np.int32)
    _host_array(flags_ptr, 2)[:] = flags


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(kernels, "launch", emulated_launch)
    monkeypatch.setattr(kernels, "check_operands", lambda *a, **k: None)
    lanczos_gf2.reset_launch_counts()
    yield
    lanczos_gf2.reset_launch_counts()


def _gf2_matrix():
    return mmio.load_mtx(os.path.join(GOLDEN, "left_p2_n32.mtx"), 2)


def _solve(solver, **kw):
    with profiling.recording() as rec:
        res = solver.solve(**kw)
    unpack = [s.attrs.get("device") for s in rec.spans
              if s.name == "final.unpack"]
    return res, unpack, rec.counters.get("final_unpack_device", 0)


@pytest.mark.parametrize("kw", [{}, {"stop_after": 3}])
def test_card_path_returns_the_host_path_result(emulated, kw):
    """A whole solve (and one stopped by its limit) through the card path,
    launches emulated, against the CPU solver's NumPy path."""
    M = _gf2_matrix()
    host = BlockLanczosGF2(M, n=32, device="cpu")
    card = BlockLanczosGF2(M, n=32, device="cpu")
    assert host._final_on_card is False         # the CPU keeps NumPy
    card._final_on_card = True
    want, want_dev, want_count = _solve(host, **kw)
    got, got_dev, got_count = _solve(card, **kw)
    assert (want_dev, want_count) == (["cpu"], 0)
    assert (got_dev, got_count) == (["cuda"], 1)
    assert lanczos_gf2.launch_counts()["final_unpack"] == 1
    same((got.kernel, got.v_nonzero, got.product_zero, got.vtM),
         (want.kernel, want.v_nonzero, want.product_zero, want.vtM))
    assert (got.iterations, got.stopped_by_limit) == (want.iterations,
                                                      want.stopped_by_limit)
    if not kw:
        assert got.v_nonzero and got.product_zero
    else:
        assert got.v_nonzero is None and got.stopped_by_limit


@pytest.mark.parametrize("fail", [False, True])
def test_card_final_step_prints_and_vtm(emulated, capsys, fail):
    """_final_card against _final_host on the same blocks: the answers,
    vtM on a failed check (a second launch), and final_check's lines word
    for word."""
    rng = np.random.default_rng(31)
    i, j, _ = gen.random_sparse(90, 70, 5, seed=3)
    M = mmio.COOMatrix(90, 70, len(i), i, j, np.ones(len(i), np.uint32), 2)
    s = BlockLanczosGF2(M, n=64, device="cpu")
    v = torch.from_numpy(random_words(rng, s.np_rows, 2))
    tmp = torch.zeros((s.mp_rows, 2), dtype=torch.int32)
    tmp[s.m_eff:] = -1                   # padding: ignored
    if fail:
        tmp[s.m_eff - 1, 0] = 4
    ws = {"unpacked": torch.empty((s.np_rows, 64), dtype=torch.int32),
          "flags": torch.empty(2, dtype=torch.int32)}
    want = s._final_host(v, tmp, verbose=True)
    printed = capsys.readouterr().out
    got = s._final_card(v, tmp, ws, verbose=True)
    assert capsys.readouterr().out == printed
    assert "KO: vt*M != 0" in printed if fail else "OK: vt*M == 0" in printed
    same(got, want)
    assert got[2] is (not fail)
    assert lanczos_gf2.launch_counts()["final_unpack"] == 1 + fail


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

# (n, rows, n_eff, m_eff): every width at small shapes, and the GF(2)
# cell's 500,000 x 128 (with m_eff 0: tmp's rows all padding)
CARD_SHAPES = [(n, *shape) for n in (32, 64, 128, 256, 512)
               for shape in ((8, 1, 1), (136, 129, 130), (4104, 4099, 3001))]
CARD_SHAPES += [(128, 500_000, 500_000, 499_000), (128, 500_000, 499_992, 0)]


@pytest.mark.card
@pytest.mark.parametrize("n,rows,n_eff,m_eff", CARD_SHAPES)
def test_kernel_equals_mirror(card, n, rows, n_eff, m_eff):
    """The kernel's block and flags equal the mirror's, bit for bit; rows of
    `out` past n_eff stay as they were; a second launch on tmp gives the
    mirror's vtM."""
    rng = np.random.default_rng(n + rows)
    W = n // 32
    v, tmp = random_words(rng, rows, W), random_words(rng, rows, W)
    tmp[:max(m_eff - 1, 0)] = 0          # one counted row left set
    for t in (tmp, None):
        want_bits, want_flags = gf2.final_unpack_np(v, t, n_eff, m_eff, n)
        out = torch.full((rows, n), 7, dtype=torch.int32, device=card)
        flags = torch.full((2,), 9, dtype=torch.int32, device=card)
        gf2.final_unpack(torch.from_numpy(v).to(card),
                         None if t is None else torch.from_numpy(t).to(card),
                         n_eff, m_eff, n, out, flags)
        got = out.cpu().numpy()
        assert np.array_equal(got[:n_eff].view(np.uint32), want_bits)
        assert (got[n_eff:] == 7).all()
        assert np.array_equal(flags.cpu().numpy(), want_flags)
    if m_eff:
        vtm = torch.empty((m_eff, n), dtype=torch.int32, device=card)
        gf2.final_unpack(torch.from_numpy(tmp).to(card), None, m_eff, 0, n,
                         vtm, flags)
        assert np.array_equal(vtm.cpu().numpy().view(np.uint32),
                              gf2.unpack_bits_np(tmp, n)[:m_eff])
        assert flags.tolist() == [1, 0]


@pytest.mark.card
def test_kernel_refuses_misaligned(card):
    flat = torch.zeros(40, dtype=torch.int32, device=card)
    out = torch.empty((8, 128), dtype=torch.int32, device=card)
    flags = torch.empty(2, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="final_unpack failed to launch"):
        gf2.final_unpack(flat[1:33].view(8, 4), None, 8, 0, 128, out, flags)


@pytest.mark.card
@pytest.mark.parametrize("fail", [False, True])
def test_card_solve_equals_host_path(card, capsys, fail):
    """A GF(2) solve on the card ends in the kernel and returns what the
    NumPy path returns on the same blocks; on a failing check (a bit set in
    the last tmp) both give the same vtM."""
    M = _gf2_matrix()
    s = BlockLanczosGF2(M, n=32, device=card)
    assert s._final_on_card
    lanczos_gf2.reset_launch_counts()
    res, dev, count = _solve(s)
    assert (dev, count) == (["cuda"], 1)
    assert lanczos_gf2.launch_counts()["final_unpack"] == 1
    host = BlockLanczosGF2(M, n=32, device=card)
    host._final_on_card = False
    want = host.solve()
    same((res.kernel, res.v_nonzero, res.product_zero, res.vtM),
         (want.kernel, want.v_nonzero, want.product_zero, want.vtM))
    v = torch.from_numpy(random_words(np.random.default_rng(2), s.np_rows,
                                      1)).to(card)
    tmp = torch.zeros((s.mp_rows, 1), dtype=torch.int32, device=card)
    if fail:
        tmp[s.m_eff - 1, 0] = 1
    ws = {"unpacked": torch.empty((s.np_rows, 32), dtype=torch.int32,
                                  device=card),
          "flags": torch.empty(2, dtype=torch.int32, device=card)}
    capsys.readouterr()
    same(s._final_card(v, tmp, ws, verbose=True),
         s._final_host(v, tmp, verbose=True))
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
