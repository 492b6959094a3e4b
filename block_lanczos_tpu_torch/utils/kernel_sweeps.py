"""Design measurements of the kernels on the card.

    python -m block_lanczos_tpu_torch.utils.kernel_sweeps
    python -m block_lanczos_tpu_torch.utils.kernel_sweeps --kernels gram_mod
    python -m block_lanczos_tpu_torch.utils.kernel_sweeps \
        --kernels spmv_gf2,gram_gf2 --matrix 3Mx2M

What chose the kernels' shapes, on the bench matrix (utils/gen.py's
BENCH_* configuration, the one chip_smoke.py and profile_solve use) unless
said otherwise, as torch.profiler's device time per launch; every
variant's outputs are first held equal to the default build's:
  * spmv_ell by direction (M^T v, with its spill; M tmp, without) at n = 4
    and n = 32;
  * spmv_ell's M^T v at n = 4 on a slab-only layout (ell = the longest row,
    no spill) against the hybrid layout: whether the spill holds warps back;
  * spmv_ell built with LAZY_FOLD in {4, 8, 16} and SPMV_THREADS in {128,
    256, 512}, at n = 4 and n = 32 (the mean of the two directions);
  * semi_inverse's CTA shape: the default build and builds with SI_WARPS =
    1 to 32, at n in {1, 2, 4, 8, 16, 32, 64} (the bench Grams at n = 4 and
    32, full-rank random ones elsewhere);
  * semi_inverse's timeline, built with SI_TIMELINE: thread 0's clock64()
    cycles for each phase of one launch, per pivot step, and for the parts
    of phase 2's first three steps, at the default CTA shape for n in {1,
    4, 8, 32, 64}.  The stamps themselves add a little to the launch;
  * gram_mod ([v | Av]^T Av) and orthogonalize at n in {4, 8, 16, 32, 64}
    as built, then built with their CTA shapes (GRAM_THREADS x
    GRAM_ROWS_PER_THREAD, ORTHO_THREADS x ORTHO_ROWS_PER_THREAD) at n = 4,
    with the n at which the tensor-core path takes over (GRAM_MMA_MIN_N,
    ORTHO_MMA_MIN_N) forced to each of 4, 8, 16, 32, 64, and with the
    shapes of EXTRA (gram_mod's rows per load round, rows per tensor-core
    stage and stages in flight; orthogonalize's warps per tensor-core CTA);
  * GF(2), on the bench or the 3M x 2M matrix mod 2 (--matrix): the tensor
    cores' binary mma.sync rate (mma_rate: m16n8k256 .and.popc);
    gram_gf2 at n in GF2_GRAM_NS on as many random rows as the matrix's
    longer side, as built and with other ring depths (GG_STAGES);
    spmv_gf2 per product in both directions at n = 128 and 256, in 1 to 4
    column bands (and which the solver picks from the card's L2), and
    unbanded with other (SPMV_GF2_CHUNK, SPMV_GF2_THREADS);
    orthogonalize_gf2 at n in GF2_GRAM_NS on as many random rows, as built
    (the binary tensor cores from OG_MMA_MIN_N) and as the builds of
    OG_VARIANTS: the CUDA-core kernel at every n, the tensor cores at every
    n;
  * semi_inverse_gf2 on full-rank random Grams at n in GF2_GRAM_NS, as
    built (one warp up to W = SI2_WARP_MAXW) and as the builds of
    SI2_VARIANTS (one thread a row at every n, SI2_WARP_MAXW = 0; the
    one-warp elimination up to W = 4 or 8), and the timelines of the
    default build and of the one-warp elimination up to W = 8 with
    SI2_TIMELINE at n in SI2_TIMELINE_NS: thread 0's clock64() cycles of
    each phase (phase 1, phase 2; the epilogue's winv and spliced rows, its
    two n x n products c = winv spliced and winv vtAv, its checks and
    writes) and per pivot step.
  * the wide field, on the bench matrix at 2^61 - 1: spmv_wide per
    direction at n = 4 on the narrow slab and on the u64 slab, as built and
    as the builds of WIDE_SPMV_VARIANTS (the gather-only floor, the vector
    width, the prefetch, chunk and CTA sizes), beside spmv_ell on the same
    entries at the narrow bench prime at n = 4 and 8; gram_wide at n in
    WIDE_GRAM_NS on the
    bench's rows as built and as the builds of WIDE_GRAM_VARIANTS (the
    shift classes at every n, ring depths, warps and stage rows, small
    folds), and the folded kernel's GW_TIMELINE at n in GW_TIMELINE_NS
    (where its time goes: the start spread, the row loop, the flush, the
    scratch adds, the finish; cycles a chunk, the share waiting);
    orthogonalize_wide at n in WIDE_NS as built and as the builds of
    WIDE_ORTHO_VARIANTS: the tensor cores from n = 1 and the row path up
    to n = 8 (the threshold OW_MMA_MIN_N), the tensor-core CTAs' warps;
    semi_inverse_wide on full-rank Grams at n in WIDE_NS, as built and as
    the builds of WIDE_SI_VARIANTS (the shared-memory elimination at
    n <= 4), the timelines of the default build and of the
    shared-memory elimination with SIW_TIMELINE at n in SIW_TIMELINE_NS
    (thread 0's clock64() cycles of each phase, of a pivot step in each
    phase and of the parts of phase 1's first steps: search, swap, update,
    barrier; the inverse's cycles and steps), and the inverse's step
    microbenchmark (SIW_STEP_BENCH: one thread, almost_inverse on
    STEP_BENCH_RESIDUES random residues, cycles a dependent step; its step
    count held to the NumPy mirror's).
  * pxor (K3) through its bound form (collectives.Pxor), at the 1 x 1 GF(2)
    mesh's payloads of bench-gf2-n128 (tmp, Av, the Grams: they and their
    planes fit the 50 MB L2, so the bytes bound at the HBM rate is no
    ceiling there) and at PXOR_BIG_WORDS words (past the L2), at every lane
    width (at PXOR_RANKS ranks): the spread and the fold, each beside its
    bytes bound (the default build only).
Each variant is an nvcc build of its own into build/kernels/ (all started
together); the solver never runs them.  Needs a CUDA device and nvcc;
prints one JSON line last.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPS = 30
FOLDS = (4, 8, 16)
THREADS = (128, 256, 512)
WARPS = (1, 2, 4, 8, 16, 32)
SI_NS = (1, 2, 4, 8, 16, 32, 64)
TIMELINE_NS = (1, 4, 8, 32, 64)
DENSE_NS = (4, 8, 16, 32, 64)
MMA_MIN_NS = (4, 8, 16, 32, 64)
GRAM_SHAPES = tuple((t, r) for t in (128, 256, 512) for r in (1, 4, 16))
ORTHO_SHAPES = tuple((t, r) for t in (128, 256, 512) for r in (1, 2, 4))
GRAM_MACROS = ("GRAM_THREADS", "GRAM_ROWS_PER_THREAD", "GRAM_MMA_MIN_N")
ORTHO_MACROS = ("ORTHO_THREADS", "ORTHO_ROWS_PER_THREAD", "ORTHO_MMA_MIN_N")
# (macro, values, n) beyond the CTA shape and the threshold: gram_mod's
# rows per row-path load round, its tensor-core path's rows per stage and
# stages in flight; orthogonalize's warps per tensor-core CTA
EXTRA = {"gram_mod": (("GRAM_UNROLL", (2, 8), (4,)),
                      ("GRAM_MMA_ROWS", (32, 64), (16, 32, 64)),
                      ("GRAM_MMA_STAGES", (3, 4), (16, 32, 64))),
         "orthogonalize": (("ORTHO_MMA_WARPS", (2, 4), (16, 32, 64)),)}
KERNELS = ("spmv_ell", "semi_inverse", "gram_mod", "orthogonalize",
           "spmv_gf2", "gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2",
           "spmv_wide", "gram_wide", "semi_inverse_wide",
           "orthogonalize_wide", "pxor")
WIDE_KERNELS = KERNELS[8:12]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
# pxor: group sizes that take each lane width (2, 4, 8, 16, 32), and a
# payload whose words alone (64 MB) outgrow the L2
PXOR_RANKS = (1, 3, 9, 129, 32769)
PXOR_BIG_WORDS = 1 << 24
# the wide field
# spmv_wide: the gather-only build (the same loads, the products XORed:
# the L2-sector floor), the vector width a thread takes (VW = 4 / 2 / 1:
# 1 / 2 / 4 threads a row at n = 4), chunk and CTA sizes, no register cap
# (the default holds 4 CTAs of 256 an SM)
WIDE_SPMV_VARIANTS = (
    {"SPMV_WIDE_GATHER_ONLY": 1}, {"SPMV_WIDE_VW": 4}, {"SPMV_WIDE_VW": 1},
    {"SPMV_WIDE_CHUNK": 2}, {"SPMV_WIDE_CHUNK": 8},
    {"SPMV_WIDE_THREADS": 128}, {"SPMV_WIDE_MIN_BLOCKS": 1})
# gram_wide: the shift classes at every n (GW_CLASS_MIN_N = 1)
# against the folded limbs up to n = 4; the folded layout's warps a CTA;
# the classes' rows a stage; recombinations every 64 / 128 rows
WIDE_GRAM_VARIANTS = (
    {"GW_CLASS_MIN_N": 1},
    {"GW_FOLDED_WARPS": 4}, {"GW_FOLDED_WARPS": 16}, {"GW_CLASS_ROWS": 64},
    {"GW_FOLDED_FOLD_ROWS": 64, "GW_CLASS_FOLD_ROWS": 128},
    {"GW_TIMELINE": 1})
WIDE_GRAM_NS = (1, 2, 4, 8, 16, 32, 64)
GW_TIMELINE_NS = (1, 2, 4)
# csrc/gram_wide.cu's GW_TIMELINE slots
GW_T = ("first", "last_start", "loop", "flush", "halves", "end",
        "loop_cycles", "wait_cycles", "chunks")
# builds that time a part of a kernel and compute something else: their
# outputs are not held to the default's
TIMING_ONLY = ("SPMV_WIDE_GATHER_ONLY",)
WIDE_NS = (1, 2, 3, 4, 8, 16, 32, 64)
# orthogonalize_wide: the tensor cores at every n (OW_MMA_MIN_N = 1) and
# the row path up to its largest n (= 9), beside the default threshold;
# 4-warp CTAs
WIDE_ORTHO_VARIANTS = (
    {"OW_MMA_MIN_N": 1}, {"OW_MMA_MIN_N": 9}, {"OW_MMA_WARPS": 4})
# semi_inverse_wide: the shared-memory elimination at n <= 4
# (SIW_REG_MAX_N = 0); the timelines of the default and of the
# shared-memory elimination; the inverse's step microbenchmark on this
# many residues
WIDE_SI_VARIANTS = ({"SIW_REG_MAX_N": 0},)
SIW_TIMELINES = ({"SIW_TIMELINE": 1}, {"SIW_TIMELINE": 1, "SIW_REG_MAX_N": 0})
SIW_STEP_BENCH = {"SIW_STEP_BENCH": 1}
STEP_BENCH_RESIDUES = 512
SIW_TIMELINE_NS = (1, 4, 16, 32, 64)
# csrc/semi_inverse_wide.cu's SIW_TIMELINE slots
(TW_START, TW_LOADED, TW_PHASE1, TW_P2INIT, TW_PHASE2, TW_SIG, TW_WINV,
 TW_CHECK, TW_END, TW_NS_START, TW_NS_END, TW_INV_START,
 TW_INV_END, TW_INV_STEPS) = range(14)
TW_STEP1, TW_MAXN, TW_NSUB = 16, 64, 3
TW_STEP2 = TW_STEP1 + TW_MAXN
TW_SUB = TW_STEP2 + TW_MAXN
TW_SLOTS = TW_SUB + 4 * TW_NSUB
PHASES_W = ("loaded", "phase1", "p2init", "phase2", "inverse_sig", "winv",
            "check", "rhs_end")
PARTS_W = ("search", "swap", "update", "barrier")
# GF(2): spmv_gf2's column bands and (SPMV_GF2_CHUNK, SPMV_GF2_THREADS)
# shapes; gram_gf2 at every width class and with GG_STAGES beside the
# default 2
GF2_BANDS = (1, 2, 3, 4)
GF2_SPMV_SHAPES = ((4, 128), (16, 128), (8, 64), (8, 256))
GF2_GRAM_NS = (32, 64, 128, 160, 256, 512)
GF2_GRAM_VARIANTS = (("GG_STAGES", 3), ("GG_STAGES", 4))
# orthogonalize_gf2 on the CUDA cores at every n and on the tensor cores at
# every n; semi_inverse_gf2
# with one thread a row at every n and with the one-warp elimination up to
# n = 128 or 256 (SI2_WARP); its timeline's widths
OG_VARIANTS = ({"OG_MMA_MIN_N": 1024}, {"OG_MMA_MIN_N": 32})
SI2_WARP = {"SI2_WARP_MAXW": 8}
SI2_VARIANTS = ({"SI2_WARP_MAXW": 0}, {"SI2_WARP_MAXW": 4}, SI2_WARP)
SI2_TIMELINE_NS = (32, 128, 256, 512)
# csrc/semi_inverse_gf2.cu's SI2_TIMELINE slots
(T2_START, T2_LOADED, T2_PHASE1, T2_P2INIT, T2_PHASE2, T2_WINV, T2_PRODUCTS,
 T2_CHECKS, T2_END, T2_NS_START, T2_NS_END) = range(11)
T2_STEP1, T2_MAXN = 16, 512
T2_STEP2 = T2_STEP1 + T2_MAXN
T2_SLOTS = T2_STEP2 + T2_MAXN
PHASES2 = ("loaded", "phase1", "p2init", "phase2", "winv_spliced",
           "products", "checks_writes", "end")
# operations of one binary m16n8k256 mma.sync (2 per multiply-add)
MMA_B1_OPS = 2 * 16 * 8 * 256
# csrc/semi_inverse.cu's SI_TIMELINE slots
(T_START, T_LOADED, T_PHASE1, T_P2INIT, T_PHASE2, T_WINV, T_CHECK, T_RHS,
 T_END, T_NS_START, T_NS_END) = range(11)
T_STEP1, T_MAXN, T_NSUB = 16, 64, 3
T_STEP2 = T_STEP1 + T_MAXN
T_SUB = T_STEP2 + T_MAXN
T_SLOTS = T_SUB + 5 * T_NSUB
PHASES = ("loaded", "phase1", "p2init", "phase2", "winv", "check", "rhs",
          "end")
PARTS = ("search", "swap", "update", "pivot product", "barrier")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, kernel: str, reps: int = REPS, sessions: int = 3) -> float:
    """Device time per launch of the CUDA kernel named `kernel`, averaged
    over the launches torch.profiler recorded in `reps` calls of fn.  The
    profiler has been seen to miss one launch of a session of very short
    kernels, and once to record none: a session that recorded fewer than
    4/5 of the launches is run again, up to `sessions` times, and then
    this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if kernel in e.key.split("(")[0]]
        seen = sum(e.count for e in evts)
        us = sum(e.device_time_total if hasattr(e, "device_time_total")
                 else e.cuda_time_total for e in evts)
        if seen >= reps * 4 // 5 and us > 0:
            return us / seen / 1e3
    raise AssertionError(f"the profiler recorded {seen} of {reps} {kernel} "
                         f"launches in each of {sessions} sessions")


def _equal(what, got, want) -> None:
    for a, b in zip(got, want):
        if not bool((a == b).all()):
            raise AssertionError(f"{what}: the variant's output differs")


def _rand(rng, rows, n, p, dev):
    import torch
    return torch.from_numpy(
        rng.integers(0, p, size=(rows, n), dtype=np.int64).astype(np.int32)
    ).to(dev)


def _full_rank_grams(rng, n, p, dev):
    """[U; U] for a symmetric n x n U = B B^T mod p, B of n + 2 columns."""
    import torch
    B = rng.integers(0, p, size=(n, n + 2), dtype=np.int64)
    U = np.zeros((n, n), np.int64)
    for k in range(n + 2):
        U = (U + np.outer(B[:, k], B[:, k]) % p) % p
    return torch.from_numpy(np.concatenate([U, U]).astype(np.int32)).to(dev)


def spmv_sweeps(s, M, rng, dev) -> dict:
    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import spmm
    p = s.f.p
    dirs = {"Mt*v": (s.first_op, s.np_rows, s.mp_rows),
            "M*tmp": (s.second_op, s.mp_rows, s.np_rows)}
    xs = {(d, n): _rand(rng, in_rows, n, p, dev)
          for d, (_, in_rows, _) in dirs.items() for n in (4, 32)}
    want = {k: spmm.spmv(dirs[k[0]][0], x, dirs[k[0]][2])
            for k, x in xs.items()}

    def timed(d, n):
        op, _, out_rows = dirs[d]
        x = xs[d, n]
        _equal(f"spmv_ell {d} n={n}", [spmm.spmv(op, x, out_rows)],
               [want[d, n]])
        return device_ms(lambda: spmm.spmv(op, x, out_rows),
                         "spmv_ell_kernel")

    out = {"by_direction": {f"{d} n={n}": timed(d, n)
                            for d in dirs for n in (4, 32)}}
    longest = int(np.bincount(M.j, minlength=M.ncols).max())
    slab_only = spmm.make_hybrid_op(s.f, M.j, M.i, M.x, M.ncols, M.nrows,
                                    ell=longest).to(dev)
    x = xs["Mt*v", 4]
    _equal("slab-only layout", [spmm.spmv(slab_only, x, s.mp_rows)],
           [want["Mt*v", 4]])
    out["layout"] = {
        "hybrid": {"ell": s.first_op.ell, "spill": s.first_op.spill_nnz,
                   "ms": timed("Mt*v", 4)},
        "slab_only": {"ell": longest, "spill": 0, "ms": device_ms(
            lambda: spmm.spmv(slab_only, x, s.mp_rows), "spmv_ell_kernel")}}
    del slab_only
    out["fold_threads"] = {}
    for f in FOLDS:
        for t in THREADS:
            with kernels.variant("spmv_ell", LAZY_FOLD=f, SPMV_THREADS=t):
                out["fold_threads"][f"fold={f} threads={t}"] = {
                    f"n={n}": statistics.mean(timed(d, n) for d in dirs)
                    for n in (4, 32)}
    return out


def _si_run(si_mod, g, p, dev):
    state = si_mod.new_state(dev)
    return [*si_mod.semi_inverse(g, p, state), state]


def semi_inverse_sweeps(grams_by_n, p, dev) -> dict:
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import semi_inverse as si_mod

    def timed(n):
        g = grams_by_n[n]
        _equal(f"semi_inverse n={n}", _si_run(si_mod, g, p, dev), want[n])
        st = si_mod.new_state(dev)
        return device_ms(lambda: si_mod.semi_inverse(g, p, st),
                         "semi_inverse_kernel")

    want = {n: _si_run(si_mod, g, p, dev) for n, g in grams_by_n.items()}
    cta = {f"n={n}": {"default": timed(n)} for n in SI_NS}
    for w in WARPS:
        with kernels.variant("semi_inverse", SI_WARPS=w):
            for n in SI_NS:
                if 32 * w >= n:
                    cta[f"n={n}"][f"warps={w}"] = timed(n)
    timeline = {}
    with kernels.variant("semi_inverse", SI_TIMELINE=1) as lib:
        lib.semi_inverse_stamps.argtypes = [ctypes.c_void_p]
        lib.semi_inverse_stamps.restype = ctypes.c_int
        for n in TIMELINE_NS:
            _equal(f"semi_inverse timeline n={n}",
                   _si_run(si_mod, grams_by_n[n], p, dev), want[n])
            torch.cuda.synchronize()
            st = (ctypes.c_longlong * T_SLOTS)()
            if lib.semi_inverse_stamps(ctypes.addressof(st)) != 0:
                raise RuntimeError("semi_inverse_stamps failed")
            timeline[f"n={n}"] = _timeline(list(st), n)
    return {"cta_warps": cta, "timeline": timeline}


def _dense_sweep(name, timed, shapes, macros, extra=()) -> dict:
    """A kernel's default build at every n of DENSE_NS, its CTA shapes at
    n = 4, the tensor-core threshold forced to each of MMA_MIN_NS, and each
    (macro, values, ns) of `extra`; macros names (threads per CTA, rows per
    thread, threshold)."""
    from block_lanczos_tpu_torch import kernels
    threads, rows, min_n = macros
    out = {"default": {f"n={n}": timed(n) for n in DENSE_NS}, "shape_n4": {},
           "mma_min_n": {}}
    for macro, values, ns in extra:
        for val in values:
            with kernels.variant(name, **{macro: val}):
                out[f"{macro}={val}"] = {f"n={n}": timed(n) for n in ns}
    for t, r in shapes:
        with kernels.variant(name, **{threads: t, rows: r}):
            out["shape_n4"][f"threads={t} rows={r}"] = timed(4)
    for m in MMA_MIN_NS:
        with kernels.variant(name, **{min_n: m}):
            out["mma_min_n"][f"min_n={m}"] = {f"n={n}": timed(n)
                                               for n in DENSE_NS}
    return out


def gram_sweeps(s, rng, dev) -> dict:
    from block_lanczos_tpu_torch.ops import dense
    p = s.f.p
    blocks = {n: (_rand(rng, s.np_rows, n, p, dev),
                  _rand(rng, s.np_rows, n, p, dev)) for n in DENSE_NS}
    want = {n: dense.gram_mod(v, av, av, p).clone()
            for n, (v, av) in blocks.items()}

    def timed(n):
        v, av = blocks[n]
        _equal(f"gram_mod n={n}", [dense.gram_mod(v, av, av, p)], [want[n]])
        return device_ms(lambda: dense.gram_mod(v, av, av, p), "gram_mod")

    return _dense_sweep("gram_mod", timed, GRAM_SHAPES, GRAM_MACROS,
                        EXTRA["gram_mod"])


def ortho_sweeps(s, rng, dev) -> dict:
    import torch

    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state
    p = s.f.p
    inputs = {}
    for n in DENSE_NS:
        rhs = torch.zeros((2 * n, 2 * n), dtype=torch.int32, device=dev)
        rhs[:n] = _rand(rng, n, 2 * n, p, dev)
        rhs[n:, :n] = _rand(rng, n, n, p, dev)
        d = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
        inputs[n] = (*(_rand(rng, s.np_rows, n, p, dev) for _ in range(3)),
                     rhs, d)

    def once(n):
        v, pb, av, rhs, d = inputs[n]
        vk, pk, st = v.clone(), pb.clone(), new_state(dev)
        L.orthogonalize(vk, pk, av, rhs, d, p, st)
        return [vk, pk, st]

    want = {n: once(n) for n in DENSE_NS}

    def timed(n):
        _equal(f"orthogonalize n={n}", once(n), want[n])
        v, pb, av, rhs, d = inputs[n]
        vk, pk, st = v.clone(), pb.clone(), new_state(dev)
        return device_ms(lambda: L.orthogonalize(vk, pk, av, rhs, d, p, st),
                         "orthogonalize")

    return _dense_sweep("orthogonalize", timed, ORTHO_SHAPES, ORTHO_MACROS,
                        EXTRA["orthogonalize"])


def mma_rate(target_ms: float = 20.0) -> float:
    """Operations per second of the tensor cores' binary mma.sync (the
    m16n8k256 .and.popc of gram_gf2) on the card, as gram_gf2_rate measures
    them (csrc/gram_gf2.cu).  Four CTAs of 8 warps per SM; the round count is scaled so that a launch takes
    about target_ms; the median of 3 launches (CUDA events)."""
    import torch

    from block_lanczos_tpu_torch import kernels
    lib = kernels._library("gram_gf2")
    fn = lib.gram_gf2_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    threads = 256

    def timed(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(blocks, threads, iters, sink.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        end.record()
        if rc != 0:
            raise RuntimeError(f"gram_gf2_rate failed to launch: error {rc}")
        end.synchronize()
        return start.elapsed_time(end)

    timed(4)
    iters = max(16, int(16 * target_ms / max(timed(16), 1e-3)))
    ms = statistics.median(timed(iters) for _ in range(3))
    ops = blocks * (threads // 32) * iters * 8 * MMA_B1_OPS
    return ops / (ms / 1e3)


def _gf2_matrix(name: str):
    """(i, j, nrows, ncols) of the odd entries of profile_solve's matrix
    `name` mod 2."""
    from block_lanczos_tpu_torch.utils.profile_solve import _matrix
    M = _matrix(name, 2)
    odd = (M.x & 1) == 1
    return M.i[odd], M.j[odd], M.nrows, M.ncols


def spmv_gf2_sweeps(coo, rng, dev) -> dict:
    """spmv_gf2's device ms per product (all bands) by direction, n = 128
    and 256, column bands (GF2_BANDS; `auto` records what BlockLanczosGF2
    picks on this card) and, unbanded, CTA shape."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos_gf2 as G
    i, j, nrows, ncols = coo
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    out = {"l2_bytes": l2, "auto": {}}
    for d, (oi, ii, od, idim) in {"Mt*v": (j, i, ncols, nrows),
                                  "M*tmp": (i, j, nrows, ncols)}.items():
        xs = {n: torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(idim, n // 32), dtype=np.int64
        ).astype(np.int32)).to(dev) for n in (128, 256)}
        want = {}
        for n in xs:
            out["auto"][f"{d} n={n}"] = G.choose_bands(idim, n // 32, l2)
        for bands in GF2_BANDS:
            op = tuple(b.to(dev) for b in G.make_gf2_bands(
                oi, ii, od, idim, bands))
            for n, x in xs.items():
                def product():
                    return G.spmv_gf2(op, x, od)
                y = product()
                if n in want:
                    _equal(f"spmv_gf2 {d} n={n} bands={bands}", [y],
                           [want[n]])
                else:
                    want[n] = y.clone()
                key = f"{d} n={n} bands={bands}"
                out[key] = device_ms(product, "spmv_gf2_kernel") * bands
                if bands == 1:
                    for c, t in GF2_SPMV_SHAPES:
                        with kernels.variant("spmv_gf2", SPMV_GF2_CHUNK=c,
                                             SPMV_GF2_THREADS=t):
                            _equal(key, [product()], [want[n]])
                            out[f"{key} chunk={c} threads={t}"] = device_ms(
                                product, "spmv_gf2_kernel")
            del op
            torch.cuda.empty_cache()
    return out


def gram_gf2_sweeps(rows, rng, dev) -> dict:
    """gram_gf2's device ms per launch at every n of GF2_GRAM_NS on `rows`
    random rows, as built and as each build of GF2_GRAM_VARIANTS (held
    equal to the default build); and the binary mma.sync's measured rate."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import gf2
    out = {"b1_ops_per_s": mma_rate()}
    for n in GF2_GRAM_NS:
        v, av = (torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(rows, n // 32), dtype=np.int64
        ).astype(np.int32)).to(dev) for _ in range(2))
        want = gf2.gram_gf2(v, av).clone()
        out[f"n={n}"] = device_ms(lambda: gf2.gram_gf2(v, av),
                                  "gram_gf2_kernel")
        for macro, val in GF2_GRAM_VARIANTS:
            with kernels.variant("gram_gf2", **{macro: val}):
                key = f"n={n} {macro}={val}"
                _equal(f"gram_gf2 {key}", [gf2.gram_gf2(v, av)], [want])
                out[key] = device_ms(lambda: gf2.gram_gf2(v, av),
                                     "gram_gf2_kernel")
    return out


def ortho_gf2_sweeps(rows, rng, dev) -> dict:
    """orthogonalize_gf2's device ms per launch at every n of GF2_GRAM_NS on
    `rows` random rows (a right-hand side with the zero block, mixed d, a
    running state), as built and as each build of OG_VARIANTS (held equal
    to the default build)."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos_gf2 as G
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    def words(r, W):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=(r, W), dtype=np.int64
        ).astype(np.int32)).to(dev)

    out = {}
    for n in GF2_GRAM_NS:
        W = n // 32
        v, pb, av = (words(rows, W) for _ in range(3))
        rhs = words(2 * n, 2 * W)
        rhs[n:, W:] = 0
        d = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)

        def once():
            vk, pk, st = v.clone(), pb.clone(), new_state(dev)
            G.orthogonalize_gf2(vk, pk, av, rhs, d, st)
            return [vk, pk, st]

        def timed():
            vk, pk, st = v.clone(), pb.clone(), new_state(dev)
            return device_ms(lambda: G.orthogonalize_gf2(vk, pk, av, rhs, d,
                                                         st),
                             "orthogonalize_gf2")

        want = once()
        out[f"n={n}"] = timed()
        for defines in OG_VARIANTS:
            key = f"n={n} " + " ".join(f"{k}={v}" for k, v in defines.items())
            with kernels.variant("orthogonalize_gf2", **defines):
                _equal(f"orthogonalize_gf2 {key}", once(), want)
                out[key] = timed()
        del v, pb, av
        torch.cuda.empty_cache()
    return out


def _full_rank_gf2_grams(rng, n, dev):
    """[U ; UA], U = L L^T over GF(2) with L unit lower triangular (every
    pivot step finds a pivot), UA symmetric; (2n, n/32) words."""
    import torch

    from block_lanczos_tpu_torch.ops import gf2
    L = np.tril(rng.integers(0, 2, size=(n, n)), -1) + np.eye(n, dtype=int)
    C = rng.integers(0, 2, size=(n, n))
    w = gf2.pack_bits_np(np.concatenate([(L @ L.T) % 2, (C @ C.T) % 2]))
    return torch.from_numpy(w.view(np.int32)).to(dev)


def semi_inverse_gf2_sweeps(rng, dev) -> dict:
    """semi_inverse_gf2's device ms per launch at every n of GF2_GRAM_NS, as
    built and as each build of SI2_VARIANTS, each held equal to the default
    build; and the timelines of the default build and of the one-warp
    elimination up to n = 256 (SI2_WARP) at SI2_TIMELINE_NS."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops import gf2
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    grams = {n: _full_rank_gf2_grams(rng, n, dev) for n in GF2_GRAM_NS}

    def run(n):
        st = new_state(dev)
        return [*(t.clone() for t in gf2.semi_inverse_gf2(grams[n], st)), st]

    def timed(n):
        _equal(f"semi_inverse_gf2 n={n}", run(n), want[n])
        st = new_state(dev)
        return device_ms(lambda: gf2.semi_inverse_gf2(grams[n], st),
                         "semi_inverse_gf2")

    want = {n: run(n) for n in GF2_GRAM_NS}
    out = {"default": {f"n={n}": timed(n) for n in GF2_GRAM_NS}}
    for defines in SI2_VARIANTS:
        with kernels.variant("semi_inverse_gf2", **defines):
            out[" ".join(f"{k}={v}" for k, v in defines.items())] = {
                f"n={n}": timed(n) for n in GF2_GRAM_NS}
    for key, extra in (("timeline", {}), ("timeline_warp", SI2_WARP)):
        out[key] = {}
        with kernels.variant("semi_inverse_gf2", SI2_TIMELINE=1,
                             **extra) as lib:
            lib.semi_inverse_gf2_stamps.argtypes = [ctypes.c_void_p]
            lib.semi_inverse_gf2_stamps.restype = ctypes.c_int
            for n in SI2_TIMELINE_NS:
                _equal(f"semi_inverse_gf2 timeline n={n}", run(n), want[n])
                torch.cuda.synchronize()
                st = (ctypes.c_longlong * T2_SLOTS)()
                if lib.semi_inverse_gf2_stamps(ctypes.addressof(st)) != 0:
                    raise RuntimeError("semi_inverse_gf2_stamps failed")
                out[key][f"n={n}"] = _timeline2(list(st), n)
    return out


def _timeline2(st, n) -> dict:
    """semi_inverse_gf2's SI2_TIMELINE stamps: cycles by phase and the mean
    cycles of a pivot step in each phase."""
    cycles = st[T2_END] - st[T2_START]
    ghz = cycles / max(st[T2_NS_END] - st[T2_NS_START], 1)
    marks = [st[T2_START + 1 + k] for k in range(len(PHASES2))]
    phases = dict(zip(PHASES2, np.diff([st[T2_START], *marks]).tolist()))
    steps = {}
    for name, first, end in (("phase1", T2_STEP1, T2_PHASE1),
                             ("phase2", T2_STEP2, T2_PHASE2)):
        starts = [st[first + j] for j in range(n)] + [st[end]]
        steps[name] = statistics.mean(np.diff(starts).tolist())
    return {"ghz": ghz, "cycles": cycles, "phases": phases,
            "cycles_per_step": steps}


def _timeline(st, n) -> dict:
    cycles = st[T_END] - st[T_START]
    ghz = cycles / max(st[T_NS_END] - st[T_NS_START], 1)
    marks = [st[T_START + 1 + k] for k in range(len(PHASES))]
    phases = dict(zip(PHASES, np.diff([st[T_START], *marks]).tolist()))

    def steps(first, end):
        starts = [st[first + j] for j in range(n)] + [end]
        return np.diff(starts).tolist()

    parts = []
    for j in range(min(n, T_NSUB)):
        at = [st[T_STEP2 + j], *(st[T_SUB + 5 * j + k] for k in range(5))]
        parts.append(dict(zip(PARTS, np.diff(at).tolist())))
    return {"ghz": ghz, "cycles": cycles, "phases": phases,
            "phase1_steps": steps(T_STEP1, st[T_PHASE1]),
            "phase2_steps": steps(T_STEP2, st[T_PHASE2]),
            "phase2_parts": parts}


def _variants(names) -> list:
    """(kernel, defines) of every build the named sweeps use."""
    out = []
    if "spmv_ell" in names:
        out += [("spmv_ell", {"LAZY_FOLD": f, "SPMV_THREADS": t})
                for f in FOLDS for t in THREADS]
    if "semi_inverse" in names:
        out += [("semi_inverse", {"SI_WARPS": w}) for w in WARPS]
        out += [("semi_inverse", {"SI_TIMELINE": 1})]
    for name, macros, shapes in (("gram_mod", GRAM_MACROS, GRAM_SHAPES),
                                 ("orthogonalize", ORTHO_MACROS,
                                  ORTHO_SHAPES)):
        if name in names:
            out += [(name, {macros[0]: t, macros[1]: r}) for t, r in shapes]
            out += [(name, {macros[2]: m}) for m in MMA_MIN_NS]
    for name, extra in EXTRA.items():
        if name in names:
            out += [(name, {macro: val}) for macro, values, _ in extra
                    for val in values]
    if "spmv_gf2" in names:
        out += [("spmv_gf2", {"SPMV_GF2_CHUNK": c, "SPMV_GF2_THREADS": t})
                for c, t in GF2_SPMV_SHAPES]
    if "gram_gf2" in names:
        out += [("gram_gf2", {m: v}) for m, v in GF2_GRAM_VARIANTS]
    if "semi_inverse_gf2" in names:
        out += [("semi_inverse_gf2", d) for d in SI2_VARIANTS]
        out += [("semi_inverse_gf2", {"SI2_TIMELINE": 1}),
                ("semi_inverse_gf2", {"SI2_TIMELINE": 1, **SI2_WARP})]
    if "orthogonalize_gf2" in names:
        out += [("orthogonalize_gf2", d) for d in OG_VARIANTS]
    if "spmv_wide" in names:
        out += [("spmv_wide", d) for d in WIDE_SPMV_VARIANTS]
    if "gram_wide" in names:
        out += [("gram_wide", d) for d in WIDE_GRAM_VARIANTS]
    if "orthogonalize_wide" in names:
        out += [("orthogonalize_wide", d) for d in WIDE_ORTHO_VARIANTS]
    if "semi_inverse_wide" in names:
        out += [("semi_inverse_wide", d) for d in
                (*WIDE_SI_VARIANTS, *SIW_TIMELINES, SIW_STEP_BENCH)]
    return out


def events_ms(fn, reps: int = REPS) -> float:
    """Time per call of fn by CUDA events over `reps` calls back to back
    (a launch's host cost included where the kernel is shorter)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pxor_sweeps(shapes, rng, dev) -> dict:
    """K3's spread and fold, ms per launch each, on random words of each of
    `shapes` at every lane width: {"L=.. RxW": {"spread": ms, "fold": ms,
    "bound": ms, "timer": ...}}, the bound the bytes of one pass (4 + 4 L a
    word, a spread's and a fold's) at the HBM rate.  Device time from
    torch.profiler; where it records no launch of the kernel, CUDA events
    over the kernel's launches back to back ("timer": "events").  The
    words come back from a spread and fold of one rank's payload, which is
    checked."""
    import torch

    from block_lanczos_tpu_torch.parallel import collectives as C
    out = {}
    for shape in shapes:
        x0 = torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, size=shape, dtype=np.int64
        ).astype(np.int32)).to(dev)
        for ranks in PXOR_RANKS:
            lanes = C.pxor_lanes(ranks)
            key = f"L={lanes} {shape[0]}x{shape[1]}"
            x = x0.clone()
            b = C.Pxor(x, ranks=ranks)

            def pair():     # one rank's payload: x comes back
                b.fold(b.pack(x), x)
            pair()
            _equal(f"pxor {key}", [x], [x0])
            row = out[key] = {"timer": "profiler"}
            try:
                for k in ("spread", "fold"):
                    row[k] = device_ms(pair, f"pxor_{k}_kernel")
            except AssertionError:
                row.update(timer="events",
                           spread=events_ms(lambda: b.pack(x)),
                           fold=events_ms(lambda: b.fold(b.payload, x)))
            row["bound"] = ((4 + 4 * lanes) * x0.numel()
                            / HBM_BYTES_PER_S * 1e3)
            print(f"  pxor {key}: spread {row['spread']:.4f} fold "
                  f"{row['fold']:.4f} (bound {row['bound']:.4f} each; "
                  f"{row['timer']})", flush=True)
            del b, x
    return out


def _key(defines) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(defines.items()))


def wide_sweeps(names, rng, dev) -> dict:
    """The wide kernels on the bench matrix at 2^61 - 1 (module docstring);
    every variant's output held equal to the default build's but for the
    timing-only builds (TIMING_ONLY)."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos_wide as LW
    from block_lanczos_tpu_torch.ops import wide_ops as wo
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state
    from block_lanczos_tpu_torch.utils import gen
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix

    i, j, x = gen.random_sparse(gen.BENCH_NROWS, gen.BENCH_NCOLS,
                                gen.BENCH_DENSITY, gen.BENCH_SEED)
    p = gen.WIDE_BENCH_PRIME
    M = COOMatrix(gen.BENCH_NROWS, gen.BENCH_NCOLS, len(x),
                  i.astype(np.int32), j.astype(np.int32),
                  x.astype(np.uint64), p)
    s = LW.BlockLanczosWide(M, n=4, device=dev)
    f = s.f

    def rand(rows, n):
        return torch.from_numpy(rng.integers(0, 1 << 62, (rows, n),
                                             dtype=np.int64) % p).to(dev)

    def variants(name, fns, kernel, builds):
        """{build: {case: ms}} for the default build and each of `builds`
        (defines) of `name`, fns = {case: (call, want)}, each printed as it
        is measured.  A variant whose output differs is recorded and not
        timed; the sweep raises once every build has run."""
        out = {"default": {k: device_ms(fn, kernel)
                           for k, (fn, _) in fns.items()}}
        print(f"  {name} default: " + ", ".join(
            f"{k} {ms:.4f}" for k, ms in out["default"].items()), flush=True)
        for d in builds:
            with kernels.variant(name, **d):
                try:
                    for k, (fn, want) in fns.items():
                        if not set(d) & set(TIMING_ONLY):
                            _equal(f"{name} {_key(d)} {k}", [fn()], [want])
                except AssertionError as e:
                    failed.append(str(e))
                    print(f"  {e}", flush=True)
                    continue
                out[_key(d)] = {k: device_ms(fn, kernel)
                                for k, (fn, _) in fns.items()}
            print(f"  {name} {_key(d)}: " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in out[_key(d)].items()),
                flush=True)
        return out

    failed = []

    res = {}
    if "spmv_wide" in names:
        fns = {}
        for d, (op, in_rows, out_rows) in {
                "Mt*v": (s.first_op, s.np_rows, s.mp_rows),
                "M*tmp": (s.second_op, s.mp_rows, s.np_rows)}.items():
            xv = rand(in_rows, 4)
            # the bench's slab (narrow: its values are below 2^20) and the
            # u64 slab of the same operator
            for slab, o in (("narrow", op), ("u64", wo.u64_slab(op))):
                call = (lambda o=o, xv=xv, out_rows=out_rows:
                        wo.spmv_wide(f, o, xv, out_rows))
                fns[f"{d} n=4 {slab}"] = (call, call())
        res["spmv_wide"] = variants("spmv_wide", fns, "spmv_wide_kernel",
                                    WIDE_SPMV_VARIANTS)
        # spmv_ell on the same entries at the narrow bench prime: the same
        # sectors of x gathered at n = 4 (16-byte rows), the same row bytes
        # at n = 8
        from block_lanczos_tpu_torch.models import lanczos as L
        from block_lanczos_tpu_torch.ops import spmm
        Mn = COOMatrix(M.nrows, M.ncols, M.nnz, M.i, M.j,
                       (M.x % gen.BENCH_PRIME).astype(np.uint32),
                       gen.BENCH_PRIME)
        sn = L.BlockLanczos(Mn, n=4, device=dev)
        ell = {}
        for d, (op, in_rows, out_rows) in {
                "Mt*v": (sn.first_op, sn.np_rows, sn.mp_rows),
                "M*tmp": (sn.second_op, sn.mp_rows, sn.np_rows)}.items():
            # n = 8: x rows of 32 bytes, as wide n = 4 gathers them
            for n in (4, 8):
                xn = (rand(in_rows, n) % gen.BENCH_PRIME).to(torch.int32)
                ell[f"{d} n={n}"] = device_ms(
                    lambda op=op, xn=xn, out_rows=out_rows:
                    spmm.spmv(op, xn, out_rows), "spmv_ell_kernel")
        res["spmv_wide"]["spmv_ell"] = ell
    if "gram_wide" in names:
        fns = {}
        for n in WIDE_GRAM_NS:
            v, av = rand(s.np_rows, n), rand(s.np_rows, n)
            call = lambda v=v, av=av: wo.gram_wide(v, av, f)  # noqa: E731
            fns[f"n={n}"] = (call, call().clone())
        # gram_wide_folded_kernel or gram_wide_class_kernel
        res["gram_wide"] = variants("gram_wide", fns, "gram_wide_",
                                    WIDE_GRAM_VARIANTS)
        timeline = {}
        with kernels.variant("gram_wide", GW_TIMELINE=1) as lib:
            lib.gram_wide_stamps.argtypes = [ctypes.c_void_p]
            lib.gram_wide_stamps.restype = ctypes.c_int
            st = (ctypes.c_longlong * len(GW_T))()
            for n in GW_TIMELINE_NS:
                fn = fns[f"n={n}"][0]
                fn()
                torch.cuda.synchronize()
                for _ in range(2):   # reset, then the run's stamps
                    if lib.gram_wide_stamps(ctypes.addressof(st)) != 0:
                        raise RuntimeError("gram_wide_stamps failed")
                    if _ == 0:
                        fn()
                        torch.cuda.synchronize()
                timeline[f"n={n}"] = _timeline_gram(list(st))
        res["gram_wide"]["timeline"] = timeline
        for k, t in timeline.items():
            print(f"  gram_wide timeline {k}: {json.dumps(t)}", flush=True)
    if "orthogonalize_wide" in names:
        fns = {}
        for n in WIDE_NS:
            v, pb, av = (rand(s.np_rows, n) for _ in range(3))
            rhs = rand(2 * n, 2 * n)
            rhs[n:, n:] = 0
            d = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)
                                 ).to(dev)

            def call(v=v, pb=pb, av=av, rhs=rhs, d=d):
                vk, pk = v.clone(), pb.clone()
                LW.orthogonalize_wide(vk, pk, av, rhs, d, f, new_state(dev))
                return torch.cat([vk, pk], 1)
            fns[f"n={n}"] = (call, call())
        # orthogonalize_wide_row_kernel or orthogonalize_wide_mma_kernel
        res["orthogonalize_wide"] = variants(
            "orthogonalize_wide", fns, "orthogonalize_wide_",
            WIDE_ORTHO_VARIANTS)
    if "semi_inverse_wide" in names:
        fns, grams = {}, {}
        for n in WIDE_NS:
            B = rng.integers(0, 1 << 62, (n, n + 2)).astype(object) % p
            U = torch.from_numpy(((B @ B.T) % p).astype(np.int64)).to(dev)
            grams[n] = g = torch.cat([U, U])

            def call(g=g):
                st = new_state(dev)
                out = wo.semi_inverse_wide(g, f, st)
                return torch.cat([t.flatten().long() for t in (*out, st)])
            fns[f"n={n}"] = (call, call())
        res["semi_inverse_wide"] = variants(
            "semi_inverse_wide", fns, "semi_inverse_wide_kernel",
            WIDE_SI_VARIANTS)
        for d in SIW_TIMELINES:
            timeline = {}
            with kernels.variant("semi_inverse_wide", **d) as lib:
                lib.semi_inverse_wide_stamps.argtypes = [ctypes.c_void_p]
                lib.semi_inverse_wide_stamps.restype = ctypes.c_int
                for n in SIW_TIMELINE_NS:
                    call, want = fns[f"n={n}"]
                    _equal(f"semi_inverse_wide {_key(d)} n={n}", [call()],
                           [want])
                    torch.cuda.synchronize()
                    st = (ctypes.c_longlong * TW_SLOTS)()
                    if lib.semi_inverse_wide_stamps(ctypes.addressof(st)):
                        raise RuntimeError("semi_inverse_wide_stamps failed")
                    timeline[f"n={n}"] = _timeline_wide(list(st), n)
            res["semi_inverse_wide"][f"timeline {_key(d)}"] = timeline
        res["semi_inverse_wide"]["step_bench"] = siw_step_bench(
            kernels, rng, p, dev)
    if failed:
        raise AssertionError("; ".join(failed))
    return res


def siw_step_bench(kernels, rng, p, dev) -> dict:
    """The inverse's dependent step, apart from the kernel: one thread runs
    almost_inverse on STEP_BENCH_RESIDUES random residues (the
    SIW_STEP_BENCH build); cycles a step, the steps held to the mirror's."""
    import torch

    from block_lanczos_tpu_torch.ops.gfp_wide import almost_inverse_np
    a = rng.integers(1, p, STEP_BENCH_RESIDUES, dtype=np.int64)
    steps_np = sum(almost_inverse_np(p, int(x))[2] for x in a)
    at = torch.from_numpy(a).to(dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    with kernels.variant("semi_inverse_wide", **SIW_STEP_BENCH) as lib:
        fn = lib.semi_inverse_wide_step_bench
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn(at.data_ptr(), len(a), p, out.data_ptr())   # warm-up
        torch.cuda.synchronize()
        if fn(at.data_ptr(), len(a), p, out.data_ptr()) != 0:
            raise RuntimeError("semi_inverse_wide_step_bench failed")
        torch.cuda.synchronize()
    cycles, steps, _ = out.tolist()
    if steps != steps_np:
        raise AssertionError(f"step bench: {steps} steps on the card, "
                             f"{steps_np} in the mirror")
    return {"residues": len(a), "steps": steps, "cycles": cycles,
            "cycles_per_step": cycles / steps}


def _timeline_gram(st) -> dict:
    """gram_wide's GW_TIMELINE stamps (folded limbs): ns from the first
    CTA's start to the last CTA's start, to the last warp's end of the row
    loop, of its flush, to the last CTA's scratch adds and to the end; the
    loop's cycles a chunk of 32 rows and the share of them spent waiting on
    the cp.async ring."""
    t = dict(zip(GW_T, st))
    marks = ("last_start", "loop", "flush", "halves", "end")
    out = {f"{k}_ns": t[k] - t["first"] for k in marks}
    out["cycles_per_chunk"] = t["loop_cycles"] / max(t["chunks"], 1)
    out["wait_share"] = t["wait_cycles"] / max(t["loop_cycles"], 1)
    return out


def _timeline_wide(st, n) -> dict:
    """semi_inverse_wide's SIW_TIMELINE stamps: cycles by phase (phase 2's
    span is ~0 where phase 1 found every pivot), the mean cycles of a
    phase-1 pivot step and the parts of its first steps (search, swap,
    update, barrier), the inverse's cycles, its steps and its cycles a
    step."""
    cycles = st[TW_END] - st[TW_START]
    ghz = cycles / max(st[TW_NS_END] - st[TW_NS_START], 1)
    marks = [st[TW_START + 1 + k] for k in range(len(PHASES_W))]
    phases = dict(zip(PHASES_W, np.diff([st[TW_START], *marks]).tolist()))
    starts = [st[TW_STEP1 + j] for j in range(n)] + [st[TW_PHASE1]]
    parts = []
    for j in range(min(n, TW_NSUB)):
        at = [st[TW_STEP1 + j], *(st[TW_SUB + 4 * j + k] for k in range(4))]
        parts.append(dict(zip(PARTS_W, np.diff(at).tolist())))
    inverse = st[TW_INV_END] - st[TW_INV_START]
    return {"ghz": ghz, "cycles": cycles, "phases": phases,
            "cycles_per_step": statistics.mean(np.diff(starts).tolist()),
            "step_parts": parts, "inverse_cycles": inverse,
            "inverse_steps": st[TW_INV_STEPS],
            "cycles_per_inverse_step": inverse / max(st[TW_INV_STEPS], 1)}


def _print_dense(name, res) -> None:
    print(f"  {name} default: " + ", ".join(
        f"{k} {ms:.4f}" for k, ms in res["default"].items()))
    for k, ms in res["shape_n4"].items():
        print(f"  {name} n=4 {k}: {ms:.4f}")
    for k, by_n in [*res["mma_min_n"].items(),
                    *((k, v) for k, v in res.items() if "=" in k)]:
        print(f"  {name} {k}: " + ", ".join(
            f"{nk} {ms:.4f}" for nk, ms in by_n.items()))


def main(argv=None) -> int:
    import argparse

    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.ops import dense, spmm
    from block_lanczos_tpu_torch.utils import gen
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ", ".join(KERNELS))
    ap.add_argument("--matrix", choices=("bench", "3Mx2M"), default="bench",
                    help="the GF(2) sweeps' matrix, mod 2 (the narrow ones "
                         "run on the bench matrix)")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not set(names) <= set(KERNELS):
        raise SystemExit(f"--kernels takes a subset of {KERNELS}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweeps needs a CUDA device")
    card = _card()
    dev = torch.device("cuda")
    variants = _variants(names)
    with ThreadPoolExecutor(max(1, len(variants))) as pool:
        list(pool.map(lambda v: kernels.build([v[0]], v[1]), variants))
    kernels.load_all()

    rng = np.random.default_rng(7)
    res = {"card": card}
    print(f"card: {card}; device ms per launch (torch.profiler, {REPS} "
          f"launches)")
    if "gram_gf2" in names:
        coo = _gf2_matrix(args.matrix)
        rows = coo[2] if coo[2] > coo[3] else coo[3]
        res["gram_gf2"] = gg = gram_gf2_sweeps(rows, rng, dev)
        print(f"  binary mma.sync rate (gram_gf2_rate): "
              f"{gg['b1_ops_per_s'] / 1e12:.1f} TOP/s")
        print(f"  gram_gf2 on {rows} rows ({args.matrix}): " + ", ".join(
            f"{k} {ms:.4f}" for k, ms in gg.items() if k.startswith("n=")))
    if "orthogonalize_gf2" in names:
        if "gram_gf2" not in names:
            coo = _gf2_matrix(args.matrix)
            rows = coo[2] if coo[2] > coo[3] else coo[3]
        res["orthogonalize_gf2"] = og = ortho_gf2_sweeps(rows, rng, dev)
        print(f"  orthogonalize_gf2 on {rows} rows ({args.matrix}): "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in og.items()))
    if "semi_inverse_gf2" in names:
        res["semi_inverse_gf2"] = si2 = semi_inverse_gf2_sweeps(rng, dev)
        _print_semi_inverse_gf2(si2)
    if "spmv_gf2" in names:
        if not {"gram_gf2", "orthogonalize_gf2"} & set(names):
            coo = _gf2_matrix(args.matrix)
        res["spmv_gf2"] = sg = spmv_gf2_sweeps(coo, rng, dev)
        print(f"  spmv_gf2 ({args.matrix}, L2 {sg['l2_bytes']} B, "
              f"auto bands {sg['auto']}), ms per product: " + ", ".join(
                  f"{k} {ms:.4f}" for k, ms in sg.items()
                  if k not in ("l2_bytes", "auto")))
    if "pxor" in names:
        from block_lanczos_tpu_torch.models.lanczos_gf2 import BlockLanczosGF2
        from block_lanczos_tpu_torch.utils.profile_solve import _matrix
        g = BlockLanczosGF2(_matrix("bench", 2), n=128, device=dev)
        W = g.W
        shapes = ((g.mp_rows, W), (g.np_rows, W), (2 * 128, W),
                  (PXOR_BIG_WORDS // W, W))
        del g
        res["pxor"] = pxor_sweeps(shapes, rng, dev)
    if set(names) & set(WIDE_KERNELS):
        wide = wide_sweeps(names, rng, dev)
        res.update(wide)
        for name, builds in wide.items():
            for build, by_case in builds.items():
                if build.startswith("timeline"):
                    for k, t in by_case.items():
                        print(f"  {name} {build} {k}: {json.dumps(t)}",
                              flush=True)
                    continue
                if build == "step_bench":
                    print(f"  {name} step_bench: {json.dumps(by_case)}",
                          flush=True)
                    continue
                print(f"  {name} {build}: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in by_case.items()),
                    flush=True)
    if not set(names) & {"spmv_ell", "semi_inverse", "gram_mod",
                         "orthogonalize"}:
        print(json.dumps(res))
        return 0
    i, j, x = gen.random_sparse(gen.BENCH_NROWS, gen.BENCH_NCOLS,
                                gen.BENCH_DENSITY, gen.BENCH_SEED)
    M = COOMatrix(gen.BENCH_NROWS, gen.BENCH_NCOLS, len(x),
                  i.astype(np.int32), j.astype(np.int32),
                  (x % gen.BENCH_PRIME).astype(np.uint32), gen.BENCH_PRIME)
    s = L.BlockLanczos(M, n=4, device=dev)
    p = s.f.p
    if "spmv_ell" in names:
        res["spmv_ell"] = sp = spmv_sweeps(s, M, rng, dev)
        for k, ms in sp["by_direction"].items():
            print(f"  spmv_ell {k}: {ms:.4f}")
        for k, lay in sp["layout"].items():
            print(f"  spmv_ell Mt*v n=4 {k} layout (ell {lay['ell']}, spill "
                  f"{lay['spill']}): {lay['ms']:.4f}")
        for k, by_n in sp["fold_threads"].items():
            print(f"  spmv_ell {k}: " + ", ".join(
                f"{nk} {ms:.4f}" for nk, ms in by_n.items()))
    if "semi_inverse" in names:
        grams_by_n = {}
        for n in SI_NS:
            if n in (4, 32):
                v = _rand(rng, s.np_rows, n, p, dev)
                av = spmm.spmv(s.second_op,
                               spmm.spmv(s.first_op, v, s.mp_rows), s.np_rows)
                grams_by_n[n] = dense.gram_mod(v, av, av, p)
            else:
                grams_by_n[n] = _full_rank_grams(rng, n, p, dev)
        res["semi_inverse"] = si = semi_inverse_sweeps(grams_by_n, p, dev)
        _print_semi_inverse(si)
    if "gram_mod" in names:
        res["gram_mod"] = gram_sweeps(s, rng, dev)
        _print_dense("gram_mod", res["gram_mod"])
    if "orthogonalize" in names:
        res["orthogonalize"] = ortho_sweeps(s, rng, dev)
        _print_dense("orthogonalize", res["orthogonalize"])
    print(json.dumps(res))
    return 0


def _print_semi_inverse_gf2(si) -> None:
    for key, by_n in si.items():
        if not key.startswith("timeline"):
            print(f"  semi_inverse_gf2 {key}: " + ", ".join(
                f"{nk} {ms:.4f}" for nk, ms in by_n.items()))
    for key in ("timeline", "timeline_warp"):
        for nk, tl in si[key].items():
            print(f"  semi_inverse_gf2 {key} {nk}: {tl['cycles']} cycles at "
                  f"{tl['ghz']:.3f} GHz; " + ", ".join(
                      f"{k} {c}" for k, c in tl["phases"].items())
                  + "; cycles a pivot step: " + ", ".join(
                      f"{k} {c:.1f}" for k, c in
                      tl["cycles_per_step"].items()))


def _print_semi_inverse(si) -> None:
    for nk, by_w in si["cta_warps"].items():
        print(f"  semi_inverse {nk}: " + ", ".join(
            f"{w} {ms:.4f}" for w, ms in by_w.items()))
    for nk, tl in si["timeline"].items():
        print(f"  semi_inverse timeline {nk}: {tl['cycles']} cycles at "
              f"{tl['ghz']:.3f} GHz; " + ", ".join(
                  f"{k} {c}" for k, c in tl["phases"].items()))
        for ph in ("phase1_steps", "phase2_steps"):
            if tl[ph]:
                print(f"    {ph}: mean {statistics.mean(tl[ph]):.0f} cycles "
                      f"(first {tl[ph][:3]})")
        for j, parts in enumerate(tl["phase2_parts"]):
            print(f"    phase 2 step {j}: " + ", ".join(
                f"{k} {c}" for k, c in parts.items()))


if __name__ == "__main__":
    raise SystemExit(main())
