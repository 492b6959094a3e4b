"""The port's host utilities against the JAX package's copies, and the
package's import boundary.

  * xoshiro256+ stream, MatrixMarket reader/writer, generators (uniform
    and power-law) and checker give the same numbers and bytes as the JAX
    package's;
  * importing every module of block_lanczos_tpu_torch pulls in neither
    jax nor any module of block_lanczos_tpu (a subprocess guard);
  * without nvcc the kernel build raises instead of falling back;
  * a kernel built with other -D macros (the design measurements of
    utils/kernel_sweeps.py) is a library of its own, and that tool reads
    the semi_inverse kernel's timeline slots where the kernel writes them.
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import block_lanczos_tpu_torch
from block_lanczos_tpu.utils import gen as jgen
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu.utils import rng as jrng
from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.utils import checker, gen, mmio, rng

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("prime", [2, 3, 65537, 1073741789])
def test_xoshiro_stream_matches_jax(prime):
    a, b = rng.Xoshiro256Plus(), jrng.Xoshiro256Plus()
    np.testing.assert_array_equal(a.fill_mod(3000, prime),
                                  b.fill_mod(3000, prime))
    assert a.next64() == b.next64()
    seed = (1, 2, 3, 4)
    np.testing.assert_array_equal(
        rng.Xoshiro256Plus(seed).fill_mod(100, prime),
        jrng.Xoshiro256Plus(seed).fill_mod(100, prime))


@pytest.mark.parametrize("count,lanes", [(50_003, 64), (4096, 4096),
                                         (1000, 7)])
def test_xoshiro_lanes_match_jax(count, lanes, monkeypatch):
    """Long draws run side by side from jumped-ahead states: the same
    values and the same state after them as the sequential stream."""
    monkeypatch.setattr(rng, "LANES", lanes)
    a, b = rng.Xoshiro256Plus(), jrng.Xoshiro256Plus()
    for prime in (2, 65537):
        np.testing.assert_array_equal(a.fill_mod(count, prime),
                                      b.fill_mod(count, prime))
    assert a.next64() == b.next64()


def test_mmio_roundtrip_matches_jax(tmp_path):
    path = str(tmp_path / "m.mtx")
    i = np.array([0, 3, 2, 2, 4])
    j = np.array([1, 0, 2, 3, 4])
    x = np.array([5, -1, 1 << 31, -(1 << 31), 7])     # two's complement
    jmmio.write_coo_mtx(path, 5, 6, i, j, x)
    jpath = str(tmp_path / "j.mtx")
    mmio.write_coo_mtx(jpath, 5, 6, i, j, x)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for p in (2, 65537, 1073741789):
        got, want = mmio.load_mtx(path, p), jmmio.load_mtx(path, p)
        assert (got.nrows, got.ncols, got.nnz) == (want.nrows, want.ncols,
                                                   want.nnz)
        for a, b in ((got.i, want.i), (got.j, want.j), (got.x, want.x)):
            np.testing.assert_array_equal(a, b)
    chunks = list(mmio.iter_mtx_triplets(path, chunk=2))
    want_chunks = list(jmmio.iter_mtx_triplets(path, chunk=2))
    assert len(chunks) == len(want_chunks) == 3
    for c, w in zip(chunks, want_chunks):
        for a, b in zip(c, w):
            np.testing.assert_array_equal(a, b)


def test_kernel_writer_and_reader_match_jax(tmp_path):
    v = np.random.default_rng(0).integers(0, 1 << 30, (37, 3)).astype(
        np.uint32)
    mmio.write_kernel_mtx(str(tmp_path / "a.mtx"), v, 37, 3)
    jmmio.write_kernel_mtx(str(tmp_path / "b.mtx"), v, 37, 3)
    assert (tmp_path / "a.mtx").read_bytes() == (tmp_path / "b.mtx").read_bytes()
    nr, nc, data = mmio.read_array_mtx(str(tmp_path / "a.mtx"))
    assert (nr, nc) == (37, 3)
    np.testing.assert_array_equal(data, v.astype(np.int64))
    for bad in ("coordinate", "real"):
        text = (tmp_path / "a.mtx").read_text().replace(
            "array integer" if bad == "coordinate" else "integer",
            "coordinate integer" if bad == "coordinate" else bad, 1)
        (tmp_path / "c.mtx").write_text(text)
        with pytest.raises(ValueError):
            mmio.read_array_mtx(str(tmp_path / "c.mtx"))


def test_load_rejects_out_of_range_indices(tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text("%%MatrixMarket matrix coordinate integer general\n"
                    "3 3 2\n1 1 5\n4 2 1\n")
    with pytest.raises(ValueError, match="row index 4"):
        mmio.load_mtx(str(path), 65537)


def test_generator_matches_jax(tmp_path):
    for args in ((50, 40, 5, 3), (300, 200, 15, 42)):
        for a, b in zip(gen.random_sparse(*args), jgen.random_sparse(*args)):
            np.testing.assert_array_equal(a, b)
    gen.write_random_mtx(str(tmp_path / "a.mtx"), 30, 20, 4, seed=9)
    jgen.write_random_mtx(str(tmp_path / "b.mtx"), 30, 20, 4, seed=9)
    assert (tmp_path / "a.mtx").read_bytes() == (tmp_path / "b.mtx").read_bytes()


@pytest.mark.parametrize("args,alpha", [
    ((50, 40, 5, 3), 1.2), ((400, 300, 6, 11), 1.2),
    ((5000, 3000, 8, 11), 1.2), ((200, 1000, 4, 0), 0.8)])
def test_skewed_generator_matches_jax(args, alpha):
    """random_sparse_skewed: the JAX generator's COO, entry for entry."""
    got = gen.random_sparse_skewed(*args, alpha=alpha)
    want = jgen.random_sparse_skewed(*args, alpha=alpha)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checker_accepts_goldens_and_rejects_garbage():
    for name, prime, right in (("left_p65537_n4", 65537, False),
                               ("right_pbig_n2", 1073741789, True),
                               ("left_p2_n4", 2, False)):
        mtx = os.path.join(GOLDEN, f"{name}.mtx")
        kern = os.path.join(GOLDEN, f"{name}.kernel.mtx")
        assert checker.check_kernel_file(mtx, kern, prime, right=right)
        _, _, data = mmio.read_array_mtx(kern)
        bad = data.astype(np.uint32)
        bad[0, 0] = (bad[0, 0] + 1) % prime
        with pytest.raises(checker.CheckFailure):
            checker.check_kernel_block(mtx, bad, prime, right=right)
        with pytest.raises(checker.CheckFailure):
            checker.check_kernel_block(mtx, np.zeros_like(bad), prime,
                                       right=right)
        with pytest.raises(checker.CheckFailure):
            checker.check_kernel_block(mtx, np.full_like(bad, prime), prime,
                                       right=right)
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    kern = os.path.join(GOLDEN, "left_p65537_n4.kernel.mtx")
    assert checker.main(["--matrix", mtx, "--kernel", kern,
                         "--prime", "65537"]) == 0
    assert checker.main(["--matrix", mtx, "--kernel", kern,
                         "--prime", "65521"]) == 1


def test_package_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    mods = [m.name for m in pkgutil.walk_packages(
        block_lanczos_tpu_torch.__path__, "block_lanczos_tpu_torch.")]
    assert "block_lanczos_tpu_torch.utils.cli" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'block_lanczos_tpu' or m.startswith('block_lanczos_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_kernel_build_needs_nvcc(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present; the missing-compiler path is not "
                    "testable here")
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load_all()
    fields = {
        "spmv_ell", "gram_mod", "semi_inverse", "orthogonalize",
        "spmv_gf2", "gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2",
        "spmv_wide", "gram_wide", "semi_inverse_wide", "orthogonalize_wide"}
    # the mesh's collectives: a pack and a fold each, one source
    mesh = {"psum_mod_pack", "psum_mod_fold", "psum_mod_wide_pack",
            "psum_mod_wide_fold", "pxor_spread", "pxor_fold"}
    # v0 drawn on the card; GF(2)'s final step, final_unpack in gf2_final.cu
    setup = {"xoshiro_fill"}
    assert set(kernels.SIGNATURES) == fields | mesh | setup | {"final_unpack"}
    assert set(kernels.SOURCE_NAMES) == (fields | {"collectives"} | setup
                                         | {"gf2_final"})
    for name in kernels.SIGNATURES:
        src = kernels.SOURCES.get(name, name)
        assert (kernels.CSRC / f"{src}.cu").exists()
        assert f'extern "C" int {name}(' in (kernels.CSRC /
                                             f"{src}.cu").read_text()


def test_kernel_variant_builds_are_kept_apart():
    base = kernels._library_path("spmv_ell", "nvcc")
    assert kernels._library_path("spmv_ell", "nvcc", {}) == base
    variants = {kernels._library_path("spmv_ell", "nvcc", {"LAZY_FOLD": k})
                for k in (4, 16)}
    assert len(variants | {base}) == 3
    assert kernels._flags({"B": 1, "A": 2})[-2:] == ["-DA=2", "-DB=1"]
    assert kernels._flags({}) == list(kernels.NVCC_FLAGS)


def test_kernel_sweeps_timeline_slots_match_the_kernel():
    from block_lanczos_tpu_torch.utils import kernel_sweeps as ks
    src = (kernels.CSRC / "semi_inverse.cu").read_text()
    names = re.search(r"enum \{(.*?)SI_T_STEP1", src, re.S).group(1)
    names = [w.strip().removeprefix("SI_T_").lower()
             for w in names.split(",") if w.strip()]
    assert names == ["start", *ks.PHASES, "ns_start", "ns_end"]
    assert [ks.T_START, ks.T_END, ks.T_NS_START, ks.T_NS_END] == [
        names.index(k) for k in ("start", "end", "ns_start", "ns_end")]
    assert int(re.search(r"SI_T_STEP1 = (\d+)", src).group(1)) == ks.T_STEP1
    assert int(re.search(r"SI_T_NSUB = (\d+)", src).group(1)) == ks.T_NSUB
    assert int(re.search(r"#define SI_MAXN (\d+)", src).group(1)) == ks.T_MAXN
    assert "SI_T_STEP2 = SI_T_STEP1 + SI_MAXN" in src
    assert "SI_T_SUB = SI_T_STEP2 + SI_MAXN" in src
    assert "SI_T_SLOTS = SI_T_SUB + 5 * SI_T_NSUB" in src
    parts = re.findall(r"SI_STAMP_PART\(j, (\d)\);", src)
    assert [int(k) for k in parts] == list(range(len(ks.PARTS))) == [
        0, 1, 2, 3, 4]


def test_kernel_sweeps_gf2_timeline_slots_match_the_kernel():
    from block_lanczos_tpu_torch.ops import gf2
    from block_lanczos_tpu_torch.utils import kernel_sweeps as ks
    src = (kernels.CSRC / "semi_inverse_gf2.cu").read_text()
    names = re.search(r"enum \{(.*?)SI2_T_STEP1", src, re.S).group(1)
    names = [w.strip().removeprefix("SI2_T_").lower()
             for w in names.split(",") if w.strip()]
    stamped = {"winv": "winv_spliced", "checks": "checks_writes"}
    assert [stamped.get(k, k) for k in names] == [
        "start", *ks.PHASES2, "ns_start", "ns_end"]
    assert [ks.T2_START, ks.T2_END, ks.T2_NS_START, ks.T2_NS_END] == [
        names.index(k) for k in ("start", "end", "ns_start", "ns_end")]
    assert int(re.search(r"SI2_T_STEP1 = (\d+)", src).group(1)) \
        == ks.T2_STEP1
    assert ks.T2_MAXN == gf2.MAX_N
    assert "SI2_T_STEP2 = SI2_T_STEP1 + GF2_MAXN" in src
    assert "SI2_T_SLOTS = SI2_T_STEP2 + GF2_MAXN" in src
    for k in names[:9]:         # every phase is stamped
        assert f"SI2_STAMP(SI2_T_{k.upper()})" in src, k


@pytest.mark.parametrize("key,kernel,wrapper", [
    ("spmv_ell_kernel(int const*, ...)", "spmv_ell_kernel", "spmv_ell"),
    ("void spmv_ell_kernel<4>(int const*, ...)", "spmv_ell_kernel",
     "spmv_ell"),
    ("void gram_mod_kernel<4, 4>(int const*, ...)", "gram_mod_kernel",
     "gram_mod"),
    ("void gram_mod_mma_kernel<true>(int const*, ...)",
     "gram_mod_mma_kernel", "gram_mod"),
    ("gram_mod_tiles_kernel(int const*, ...)", "gram_mod_tiles_kernel",
     "gram_mod"),
    ("void orthogonalize_mma_kernel<2, true>(int*, ...)",
     "orthogonalize_mma_kernel", "orthogonalize"),
    ("orthogonalize_smem_kernel(int*, ...)", "orthogonalize_smem_kernel",
     "orthogonalize"),
    ("void semi_inverse_kernel<true>(int const*, ...)",
     "semi_inverse_kernel", "semi_inverse"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)",
     "at::native::vectorized_elementwise_kernel", None),
])
def test_profile_solve_maps_kernels_to_wrappers(key, kernel, wrapper):
    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.utils import profile_solve as ps
    assert ps.kernel_name(key) == kernel
    assert ps.wrapper_of(kernel, L.launch_counts()) == wrapper


def test_kernel_sweeps_macros_are_the_kernels():
    """Every -D macro the design sweeps set is one the kernel reads."""
    from block_lanczos_tpu_torch.utils import kernel_sweeps as ks
    for name, defines in ks._variants(ks.KERNELS):
        src = (kernels.CSRC / f"{name}.cu").read_text() + "".join(
            f.read_text() for f in kernels.CSRC.glob("*.cuh"))
        for macro in defines:   # read by a preprocessor conditional
            assert re.search(rf"^#if.*\b{macro}\b", src, re.M), \
                (name, macro)
