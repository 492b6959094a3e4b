"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` (four narrow-field kernels on `modp.cuh`, four
GF(2) kernels on `gf2.cuh`, four wide-field kernels on `modp64.cuh`, and
`collectives.cu`: the mesh's exact all-reduces, whose pack and fold halves
are six entry points of one source, `xoshiro_fill.cu`: the solvers'
initial block drawn on the card, and `gf2_final.cu`: the GF(2) solver's
final unpack and check) is compiled by nvcc, at first use,
into its own shared library with a plain C interface and loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The build goes into `build/kernels/` at the repository root, one nvcc
process per source, all started together.  The file name carries a hash of
the sources, the flags and the nvcc path, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A missing nvcc raises: nothing
falls back to the plain PyTorch versions.  `variant` runs a kernel built
with other `-D` macros for a block of code; only the design measurements
of `utils/kernel_sweeps.py` use it.

Every exported function takes device pointers and the CUDA stream as
`void*`, launches on that stream (PyTorch's current stream, read by
`current_stream`), does not synchronise, and returns `cudaGetLastError()`;
`launch` raises when that is not 0.  `bind` prepares one call of an entry
point (its ctypes arguments) for a caller that repeats it on the same
tensors: the mesh's collectives.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_ulonglong)

# exported C function -> (its name, its argtypes); the stream comes last.
# Each lives in csrc/<name>.cu unless SOURCES names another source.
SIGNATURES = {
    # cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y,
    # out_dim, out_rows, n, p, mu, stream
    "spmv_ell": ("spmv_ell", (_P, _P, _I, _L, _P, _P, _P, _P, _P,
                              _L, _L, _I, _U, _U, _P)),
    # v1, n1, v2, n2, w, b, N, p, mu, scratch, out, stream
    "gram_mod": ("gram_mod", (_P, _I, _P, _I, _P, _I, _L, _U, _U, _P, _P,
                              _P)),
    # grams, n, p, mu, check, winv, d, npiv, rhs, state, stream
    "semi_inverse": ("semi_inverse", (_P, _I, _U, _U, _I, _P, _P, _P, _P,
                                      _P, _P)),
    # v, p_blk, av, rhs, d, N, n, p, mu, state, stream
    "orthogonalize": ("orthogonalize", (_P, _P, _P, _P, _P, _L, _I, _U, _U,
                                        _P, _P)),
    # the bitsliced GF(2) kernels (blocks of W = n / 32 words a row)
    # cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows, W,
    # accumulate, stream
    "spmv_gf2": ("spmv_gf2", (_P, _P, _I, _L, _P, _P, _P, _P, _L, _L, _I,
                              _I, _P)),
    # v, av, N, W, scratch, out, stream
    "gram_gf2": ("gram_gf2", (_P, _P, _L, _I, _P, _P, _P)),
    # grams, n, check, winv, d, npiv, rhs, state, stream
    "semi_inverse_gf2": ("semi_inverse_gf2", (_P, _I, _I, _P, _P, _P, _P,
                                              _P, _P)),
    # v, p_blk, av, rhs, d, N, W, state, stream
    "orthogonalize_gf2": ("orthogonalize_gf2", (_P, _P, _P, _P, _P, _L, _I,
                                                _P, _P)),
    # the wide-field kernels (u64 residues; p, mu, pinv, r2 of GFpWide)
    # cols, vals, ell, ld, rowptr, sp_cols, sp_vals, narrow, x, y, out_dim,
    # out_rows, n, p, mu, pinv, r2, stream
    "spmv_wide": ("spmv_wide", (_P, _P, _I, _L, _P, _P, _P, _I, _P, _P, _L,
                                _L, _I, _U, _U, _U, _U, _P)),
    # v, av, n, N, p, mu, pinv, r2, scratch, out, stream
    "gram_wide": ("gram_wide", (_P, _P, _I, _L, _U, _U, _U, _U, _P, _P,
                                _P)),
    # grams, n, p, mu, pinv, r2, check, winv, d, npiv, rhs, state, stream
    "semi_inverse_wide": ("semi_inverse_wide", (_P, _I, _U, _U, _U, _U, _I,
                                                _P, _P, _P, _P, _P, _P)),
    # v, p_blk, av, rhs, d, N, n, p, mu, pinv, r2, state, stream
    "orthogonalize_wide": ("orthogonalize_wide", (_P, _P, _P, _P, _P, _L,
                                                  _I, _U, _U, _U, _U, _P,
                                                  _P)),
    # the mesh's exact all-reduces (csrc/collectives.cu), each a pack
    # before the transport's sum and a fold after it
    # x, payload, count, stream
    "psum_mod_pack": ("psum_mod_pack", (_P, _P, _L, _P)),
    # sums, int64 sums?, x, count, p, mu, stream
    "psum_mod_fold": ("psum_mod_fold", (_P, _I, _P, _L, _U, _U, _P)),
    # x, payload (two 31-bit halves), count, stream
    "psum_mod_wide_pack": ("psum_mod_wide_pack", (_P, _P, _L, _P)),
    # sums, halves?, x, count, p, mu, pinv, r2, stream
    "psum_mod_wide_fold": ("psum_mod_wide_fold", (_P, _I, _P, _L, _U, _U,
                                                  _U, _U, _P)),
    # x, payload, count, lanes, stream
    "pxor_spread": ("pxor_spread", (_P, _P, _L, _I, _P)),
    # sums, x, count, lanes, stream
    "pxor_fold": ("pxor_fold", (_P, _P, _L, _I, _P)),
    # v0 drawn on the card (ops/xoshiro.py::LaneDraw): jumps, levels,
    # s0, s1, s2, s3, count, m, field, p, mu, out, stream
    "xoshiro_fill": ("xoshiro_fill", (_P, _I, _U, _U, _U, _U, _L, _L, _I, _U,
                                      _U, _P, _P)),
    # GF(2)'s final step on the card (ops/gf2.py::final_unpack): v, tmp,
    # n_eff, m_eff, W, out, flags, stream
    "final_unpack": ("final_unpack", (_P, _P, _L, _L, _I, _P, _P, _P)),
}
# exported C function -> its source stem, where that is not its own name
SOURCES = {name: "collectives" for name in (
    "psum_mod_pack", "psum_mod_fold", "psum_mod_wide_pack",
    "psum_mod_wide_fold", "pxor_spread", "pxor_fold")}
SOURCES["final_unpack"] = "gf2_final"
# the source stems, each one library
SOURCE_NAMES = tuple(dict.fromkeys(SOURCES.get(n, n) for n in SIGNATURES))

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of block_lanczos_tpu_torch are "
            "built from source at first use (put the CUDA toolkit's bin/ on "
            "PATH), or run on the CPU with device='cpu'")
    return nvcc


def _flags(defines) -> list:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(defines.items()))]


def _library_path(name: str, nvcc: str, defines=None) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(defines or {})).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None, defines=None) -> dict:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc process each, in parallel, with `-D<macro>=<value>` for each
    item of `defines` (default none).  Returns {name: library path}."""
    names = list(SOURCE_NAMES if names is None else names)
    defines = defines or {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name, nvcc, defines) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *_flags(defines), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(names=None) -> str:
    """What ptxas says of each named source (default: all): registers,
    shared memory, spills.  Compiles a cubin per source with the build's
    target and -O3 plus `-Xptxas -v`, into BUILD_DIR, and returns the text."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    for name in list(SOURCE_NAMES if names is None else names):
        # the build's target, -std and -O3, minus -shared / -fPIC
        cmd = [nvcc, *NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
               "-I", str(CSRC), "-o", str(BUILD_DIR / f"{name}.cubin"),
               str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
        out.append(f"--- {name}\n{res.stdout}{res.stderr}")
    return "\n".join(out)


def load_all() -> float:
    """Build (where needed) and load every kernel; returns the seconds it
    took.  Later `launch` calls then find the libraries loaded."""
    t0 = time.perf_counter()
    with _lock:
        missing = [n for n in SOURCE_NAMES if n not in _loaded]
        if missing:
            for name, path in build(missing).items():
                _loaded[name] = _bind(name, path)
    return time.perf_counter() - t0


def _bind(name: str, path: Path) -> ctypes.CDLL:
    """Load source `name`'s library and declare each of its entry points."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES.values():
        if SOURCES.get(fn_name, fn_name) == name:
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.bl_error_string.argtypes = [ctypes.c_int]
    lib.bl_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def variant(name: str, **defines):
    """Within the block, `launch` runs the entry points of source `name`
    as built with `-D<macro>=<value>` for each keyword; the block gets the
    library (for entry points of such a build beyond SIGNATURES)."""
    lib = _bind(name, build([name], defines)[name])
    with _lock:
        saved = _loaded.get(name)
        _loaded[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if saved is None:
                del _loaded[name]
            else:
                _loaded[name] = saved


def _library(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        load_all()
        lib = _loaded[name]
    return lib


def check_operands(name: str, *tensors, dtype=torch.int32) -> None:
    """Raise unless every tensor is a contiguous `dtype` (default int32)
    tensor on one CUDA device: the kernels take raw pointers and check
    nothing themselves."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev \
                or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {dtype} tensors on "
                             f"one CUDA device (got {t.dtype} on {t.device})")


def current_stream() -> int:
    """The raw handle of PyTorch's current stream on the current device, read
    without building a torch.cuda.Stream object (the same handle as
    torch.cuda.current_stream().cuda_stream)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _refused(lib, name: str, rc: int):
    msg = lib.bl_error_string(rc).decode(errors="replace")
    return RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} "
                        f"({msg})")


def launch(name: str, *args) -> None:
    """Call the C entry point `name` on PyTorch's current stream and raise
    if the launch was refused."""
    lib = _library(SOURCES.get(name, name))
    rc = getattr(lib, SIGNATURES[name][0])(*args, current_stream())
    if rc != 0:
        raise _refused(lib, name, rc)


def bind(name: str, *args):
    """`launch(name, *args)` prepared once: the library and entry point
    looked up and the arguments converted to their ctypes here, so that a
    call of the returned function only reads the current stream and
    launches.  The caller keeps the tensors behind the pointers alive."""
    lib = _library(SOURCES.get(name, name))
    fn = getattr(lib, SIGNATURES[name][0])
    cargs = tuple(t(a) for t, a in zip(SIGNATURES[name][1], args))

    def call() -> None:
        rc = fn(*cargs, current_stream())
        if rc != 0:
            raise _refused(lib, name, rc)
    return call
