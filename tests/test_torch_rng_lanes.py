"""v0 drawn on the card (csrc/xoshiro_fill.cu), through its NumPy mirror
`ops/xoshiro.py::xoshiro_fill_np` (the lanes of `utils/rng.py`'s own
draw, then the kernel's epilogue), on the CPU:

  * the kernel's lane schedule (lanes of m values, m a multiple of 32;
    each lane's start state from the cached jump matrices T^(m 2^k) at the
    set bits of its index) gives the values of `fill_mod` / `fill_mod64`
    and of the JAX package's generator and, over GF(2), the packed words
    of their bits, bit for bit: at
    n = 32, 128 and 256, at counts below the lanes, not a multiple of
    32 x lanes, and equal to 1;
  * the generator's state after the draw, advanced on the host by
    T^count, is the sequential `fill_u64` state, and a second draw goes on
    from it;
  * each single-device solver's CUDA branch of `initial_block` (the
    launch emulated through the C entry point's arguments and pointers)
    gives the block its NumPy branch gives, records v0.draw with
    device "cuda", counts v0_draws_device and the wrapper's launches in
    its model's launch_counts();
  * the host's lane start states equal the kernel's per-lane products;
  * the lane plans of the benchmark's cells, the kernel's field codes and
    its entry point's arguments.
"""

import ctypes
import re

import numpy as np
import pytest

from block_lanczos_tpu.utils import rng as jrng
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.models import lanczos, lanczos_gf2, lanczos_wide
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu_torch.models.lanczos_wide import BlockLanczosWide
from block_lanczos_tpu_torch.ops import gf2, xoshiro
from block_lanczos_tpu_torch.utils import gen, mmio, profiling, rng

P30 = 1073741789
P61 = (1 << 61) - 1
P62 = 4611686018427387847
FIELDS = [("gf2", 2), ("narrow", P30), ("narrow", 2), ("narrow", 3),
          ("wide", P61), ("wide", P62)]


def host_draw(gen_, field, prime, count):
    """What the NumPy path draws (of either package's generator), in the
    kernel's flat output form."""
    if field == "gf2":
        bits = np.zeros(-(-count // 32) * 32, np.uint32)
        bits[:count] = gen_.fill_mod(count, 2)
        return gf2.pack_bits_np(bits.reshape(-1, 32)).view(np.int32)[:, 0]
    if field == "wide":
        return gen_.fill_mod64(count, prime).astype(np.int64)
    return gen_.fill_mod(count, prime).astype(np.int32)


def lane_draw(d, gen_, field, prime):
    """The mirror's draw through the plan `d` (as LaneDraw.block does)."""
    n_out = -(-d.count // 32) if field == "gf2" else d.count
    out = np.zeros(n_out, np.int64 if field == "wide" else np.int32)
    xoshiro.xoshiro_fill_np(d.jumps, *d.args(gen_.state, field, prime),
                            out)
    gen_.state = d.state_after(gen_.state)
    return out


@pytest.mark.parametrize("n", [32, 128, 256])
@pytest.mark.parametrize("field,prime", FIELDS)
def test_lanes_match_the_host_draw(field, prime, n, monkeypatch):
    """Two v0 blocks of 19 rows in a row, in 16 lanes: the same values and
    the same state as the host draw, as the JAX package's generator and as
    the sequential stream."""
    monkeypatch.setattr(rng, "LANES", 16)
    count = 19 * n
    d = xoshiro.LaneDraw(count, "cpu")
    assert d.m % 32 == 0 and d.lanes <= 16 and d.levels >= 1
    a, b, seq = (rng.Xoshiro256Plus() for _ in range(3))
    ref = jrng.Xoshiro256Plus()
    for _ in range(2):
        got = lane_draw(d, a, field, prime)
        np.testing.assert_array_equal(got, host_draw(b, field, prime, count))
        np.testing.assert_array_equal(got,
                                      host_draw(ref, field, prime, count))
        seq.fill_u64(count)
        assert a.state == b.state == seq.state
    assert a.next64() == b.next64() == ref.next64()


@pytest.mark.parametrize("count,lanes", [
    (1, 64),             # one value: one lane, no jump
    (5, 64),             # below the lanes: one lane of 32
    (1000, 7),           # not a multiple of 32 x lanes
    (50_003, 64),        # the last lane short, its last word partial
    (32 * 64, 64),       # every lane full
    (32 * 64 + 1, 64),   # one value past: m = 64, 33 lanes
    (32 * (1 << 14) + 1, 1 << 14),   # the same at the H100's lanes
])
@pytest.mark.parametrize("field,prime", [("gf2", 2), ("narrow", 65537),
                                         ("wide", P61)])
def test_lane_counts(field, prime, count, lanes, monkeypatch):
    monkeypatch.setattr(rng, "LANES", lanes)
    d = xoshiro.LaneDraw(count, "cpu")
    assert d.lanes <= lanes and (d.lanes - 1) * d.m < count <= d.lanes * d.m
    assert d.lanes == 1 or (d.lanes - 1) >> d.levels == 0
    seed = (0x9E3779B97F4A7C15, 3, 1 << 63, 12345)
    a, b = rng.Xoshiro256Plus(seed), rng.Xoshiro256Plus(seed)
    for _ in range(2):
        np.testing.assert_array_equal(lane_draw(d, a, field, prime),
                                      host_draw(b, field, prime, count))
        assert a.state == b.state


def test_jump_matrices_are_step_powers():
    """Column c of J_k is the state T^(m 2^k) steps after bit c alone."""
    m, levels = 64, 3
    J = rng.jump_columns(m, levels)
    assert J.shape == (levels, 256, 4) and J.dtype == np.uint64
    assert rng.jump_columns(m, levels) is J          # cached
    for k in range(levels):
        for c in (0, 63, 64, 200, 255):
            state = [0, 0, 0, 0]
            state[c // 64] = 1 << (c % 64)
            g = rng.Xoshiro256Plus(state)
            g.fill_u64(m << k)
            assert [int(w) for w in J[k, c]] == g.state


def kernel_matvec(cols, state) -> list:
    """One of the kernel's mat-vecs: the XOR of the columns (four u64
    words each) at the set bits of the 256-bit state."""
    out = [0, 0, 0, 0]
    for c in range(256):
        if (state[c // 64] >> (c % 64)) & 1:
            out = [o ^ int(w) for o, w in zip(out, cols[c])]
    return out


@pytest.mark.parametrize("lanes", [1, 2, 13, 64])
def test_lane_starts_are_the_kernels_products(lanes):
    """The host's shared products give each lane the state the kernel
    builds for it: the J_k of the set bits of its index, k = 0 first,
    applied one by one as column XORs; and T^(l m) steps of the stream."""
    m = 32
    J = rng.jump_columns(m, (lanes - 1).bit_length())
    seed = (0x9E3779B97F4A7C15, 3, 1 << 63, 12345)
    got = rng.lane_starts(seed, J, lanes)
    for lane in range(lanes):
        state = list(seed)
        for k in range(len(J)):
            if (lane >> k) & 1:
                state = kernel_matvec(J[k], state)
        assert [int(g[lane]) for g in got] == state
        g = rng.Xoshiro256Plus(seed)
        g.fill_u64(lane * m)
        assert g.state == state


@pytest.mark.parametrize("rows,n,field", [(500_000, 128, "gf2"),
                                          (100_000, 4, "narrow"),
                                          (100_000, 32, "narrow")])
def test_lane_plans_of_the_cells(rows, n, field):
    """The benchmark's v0 shapes at the default lanes: at most
    LANES lanes of a multiple of 32, at most 14 jumps a lane."""
    count = rows * n
    m, lanes = rng.lane_plan(count)
    assert m % 32 == 0 and lanes <= rng.LANES
    assert (lanes - 1) * m < count <= lanes * m
    assert (lanes - 1).bit_length() <= 14
    if field == "gf2":               # a lane owns whole words of a row
        assert m * n % 32 == 0


def test_field_codes_and_signature_match_the_kernel():
    src = (kernels.CSRC / "xoshiro_fill.cu").read_text()
    enum = re.search(r"enum \{ XF_GF2 = (\d), XF_NARROW = (\d), "
                     r"XF_WIDE = (\d) \}", src)
    assert [int(k) for k in enum.groups()] == [
        xoshiro.FIELD_CODES[f] for f in ("gf2", "narrow", "wide")]
    name, argtypes = kernels.SIGNATURES["xoshiro_fill"]
    assert name == "xoshiro_fill" and len(argtypes) == 13
    d = xoshiro.LaneDraw(1000, "cpu")
    args = d.args(rng.DEFAULT_SEED, "wide", P62)
    # jumps, *args, out, stream: every argument fits its C type
    assert len(args) == len(argtypes) - 3
    for t, a in zip(argtypes[1:-2], args):
        assert t(a).value == a


def _host_array(ptr: int, dtype, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype)
    ctype = {np.uint64: ctypes.c_uint64, np.int64: ctypes.c_int64,
             np.int32: ctypes.c_int32}[dtype]
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)),
                                 shape=(n,))


def emulated_launch(name, jumps_ptr, levels, s0, s1, s2, s3, count, m,
                    field, p, mu, out_ptr):
    """kernels.launch("xoshiro_fill", ...) on CPU tensors: the mirror reads
    the jumps and writes the block through the entry point's pointers."""
    assert name == "xoshiro_fill"
    jumps = _host_array(jumps_ptr, np.uint64, 1024 * levels).reshape(
        levels, 256, 4)
    wide = field == xoshiro.FIELD_CODES["wide"]
    n_out = -(-count // 32) if field == xoshiro.FIELD_CODES["gf2"] else count
    out = _host_array(out_ptr, np.int64 if wide else np.int32, n_out)
    xoshiro.xoshiro_fill_np(jumps, levels, s0, s1, s2, s3, count, m, field,
                            p, mu, out)


@pytest.mark.parametrize("solver,prime,n", [
    (BlockLanczosGF2, 2, 64), (BlockLanczos, P30, 3),
    (BlockLanczos, 2, 4), (BlockLanczosWide, P61, 2)])
def test_solvers_device_branch(solver, prime, n, monkeypatch):
    """initial_block's CUDA branch, twice: the NumPy branch's blocks, the
    span's device attribute, the counter and the wrapper's launches, as
    the solver's model counts them."""
    i, j, x = gen.random_sparse(90, 70, 5, seed=11)
    M = mmio.COOMatrix(90, 70, len(i), i, j,
                       (x % prime).astype(np.uint64 if prime > 1 << 31
                                          else np.uint32), prime)
    on_card, host = solver(M, n=n, device="cpu"), solver(M, n=n,
                                                         device="cpu")
    assert on_card._v0_draw is None        # CPU tensors keep the NumPy path
    monkeypatch.setattr(rng, "LANES", 8)
    on_card._v0_draw = xoshiro.LaneDraw(on_card.n_eff * n, "cpu")
    monkeypatch.setattr(kernels, "launch", emulated_launch)
    monkeypatch.setattr(kernels, "check_operands", lambda *a, **k: None)
    model = {BlockLanczos: lanczos, BlockLanczosGF2: lanczos_gf2,
             BlockLanczosWide: lanczos_wide}[solver]
    model.reset_launch_counts()
    with profiling.recording() as rec:
        for _ in range(2):
            got, want = on_card.initial_block(), host.initial_block()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert (got == want).all()
    assert on_card._rng.state == host._rng.state
    draws = [s for s in rec.spans if s.name == "v0.draw"]
    assert [s.attrs["device"] for s in draws] == ["cuda", "cpu"] * 2
    assert rec.counters == {"v0_draws_device": 2}
    assert model.launch_counts()["xoshiro_fill"] == 2
    model.reset_launch_counts()
    assert xoshiro.xoshiro_fill.launches == 0
    names = [s.name for s in rec.spans]      # the host branch's alone
    assert names.count("v0.pack") == names.count("v0.upload") == 2
