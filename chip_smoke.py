#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  Phases, each of which raises (non-zero exit) on
failure:

  0. print the card's name and power limit; require CUDA;
  1. build the CUDA kernels from block_lanczos_tpu_torch/csrc/ (four
     narrow-field, four bitsliced GF(2), four wide-field, the mesh's
     collectives, xoshiro_fill, v0 on the card, and gf2_final, GF(2)'s
     final step), and two builds
     that phase 2 uses beside them (gram_wide recombining every 64 / 128
     rows; spmv_wide's gather-only floor);
  2. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes (the bench matrix, n = 4 and n = 32) and at edge
     shapes (p = 2 and 3, n = 1, an empty spill, one long spill row, N not a
     multiple of the block, singular and zero Grams; for spmv_ell the lazy
     sums' worst case, every value and x at p - 1 on rows longer than the
     fold in slab and spill, at every vector width n in {1, 2, 3, 4, 8, 32,
     64} and off 16-byte alignment; for semi_inverse full rank up to n = 64,
     n = 1, 31, 33, p = 2 and 3, a failing check; for gram_mod and
     orthogonalize every n in {1, 3, 4, 8, 16, 31, 32, 33, 64}, on either
     side of their tensor-core thresholds, every residue p - 1 (for
     gram_mod over more than one tensor-core fold of 8192 rows a CTA),
     N = 1 and N a multiple of no tile, misaligned views; gram_mod with V2
     that is W, another block or None; orthogonalize with d all 0, all 1
     and mixed under running, stopped, failed-invariant and frozen
     states); then the GF(2) kernels on the bench matrix mod 2 at n = 128
     and 256 in both directions and at n = 32, 64, 160 and 512 (slabs wider
     than 32, an empty spill, one long spill row, rows a multiple of no
     CTA, all-ones x and bit 31 set everywhere, misaligned views; for
     spmv_gf2 2, 3 and 7 column bands, some empty, and a 96 MB x past the
     L2 in one band and in the solver's bands; for gram_gf2 every W = 1 ..
     16 at N = 1, 255, 256, 257 and 20011; zero, singular and full-rank
     Grams, a failing invariant, the check off, non-symmetric Grams whose
     phase-2 pivots differ from phase 1's, on either side of the one-warp
     elimination's last width (n = 64, 96); d all 0, all 1 and mixed under
     running, stopped, failed and frozen states, N = 0, 1, 31, 32, 33 about
     the tensor-core tile of 32 rows, all ones, either side of the
     tensor-core threshold (n = 32, 64); orthogonalize_gf2 timed at 3M rows
     too): exact equality,
     since the arithmetic is exact; time each (CUDA events, median), and
     print the binary tensor cores' measured rate (gram_gf2_rate: the
     m16n8k256 .and.popc mma.sync of gram_gf2), gram_mod's and
     orthogonalize's n = 32 times and bounds beside the card, and the GF(2)
     kernels' n = 128 times, bounds (the GF(2) products' at the measured
     binary rate, n = 256's too) and library yardsticks (torch._int_mm of
     the unpacked bits for gram_gf2 and orthogonalize_gf2); then the wide
     kernels (u64 residues) at 2^30 + 3, 2^61 - 1 and 4611686018427387847,
     every n in {1, 2, 3, 4, 8, 16, 32, 64}: spmv_wide on the bench
     operators at 2^61 - 1 (timed at n = 4, on the narrow slab of int32
     signed coefficients and on the u64 slab, beside the gather-only build:
     the L2-sector floor) and on an edge matrix with a long spill row, with
     full-range and small signed coefficients, each on its default slab and
     on the u64 slab, signed coefficients +-1 and +-(2^31 - 1) against
     x = 0 and p - 1, the lazy sums' worst case (every value and x at
     p - 1, rows longer than the fold in slab and spill) on both slabs,
     aligned and not, a zero x, an empty spill; gram_wide at the bench's
     rows (timed at n = 4 and 32, and all p - 1), 2,500,003 rows of p - 1
     at n = 4 and 32, both sides of the shift classes' threshold (n = 4 /
     8), N = 0 and 1, zero blocks, and again with recombinations every 64 /
     128 rows; semi_inverse_wide on the bench's
     Grams (timed at n = 4 and 32), full-rank, rank-deficient and zero
     Grams on either side of the one-warp register elimination (n <= 4),
     one whose phase-2 pivots differ from phase 1's (d != d1), a failing
     check, the check off, a frozen state, Grams whose pivots' product is
     1, p - 1 or a power of two (the binary inverse's edges);
     orthogonalize_wide at the bench's rows (timed at n = 4 and 32) and,
     on either side of its tensor-core threshold, with d all 0, all 1 and
     mixed under running, stopped, failed and frozen states, all residues
     and rhs p - 1 (at n = 64 the s32 worst case of the limb sums), N = 1,
     15, 16, 17 about the 16-row tile, misaligned views; then
     xoshiro_fill (v0 drawn on the card) against the host draw, bit for
     bit, twice in a row from one generator whose host-advanced state must
     equal the NumPy draw's, at the benchmark's v0 shapes (GF(2) 500,000 x
     128, narrow 100,000 x 4 and x 32), a wide one at 2^61 - 1 and a count
     below the kernel's lanes, each timed; then final_unpack (GF(2)'s
     final step on the card) against its NumPy mirror, bit for bit, with
     tmp, without it and on tmp alone, padding rows of random words, at
     n = 32, 128, 512 and the GF(2) cell's 500,000 x 128, timed there beside
     the host path it replaces;
  3. solve the 9 goldens on the card (left_p2_n32 through the GF(2)
     solver): every kernel file must be byte-identical to its golden;
  4. the main path at full size: generate the bench matrix (300000 x
     200000, 15 nnz/row, seed 42), write it and load it through the port's
     mmio, and solve it with p = 1073741789, n = 4, left kernel, invariant
     checks on; the final check and the port's checker must pass, and the
     launch counts (reset just before, read just after) must show that
     every kernel ran;
  5. a timed block of 100 iterations at n = 32 on the same matrix, whose
     launch counts (reset just before, read just after) must show that
     every kernel ran in every iteration;
  6. the GF(2) slice at full size: the bench matrix mod 2 solved by
     BlockLanczosGF2 at n = 128, left kernel, invariant checks on, to
     convergence; a failed final check is salvaged (at least one verified
     vector required); the kernel written must pass the port's checker at
     p = 2, and the launch counts must show every GF(2) kernel in every
     iteration;
  7. 50 iterations of BlockLanczosGF2(n=64, dedup=False), of the same
     solver on operators split into 2 column bands each (one spmv_gf2
     launch a band), and of the narrow BlockLanczos at p = 2, n = 64 (its
     CUDA kernels), each from its own xoshiro v0 (the same bits): the
     unpacked v and p must be equal;
  8. a timed block of 100 GF(2) iterations at n = 256, with launch counts;
  9. the wide slice at full size: the bench matrix file loaded at
     p = 2^61 - 1 through the wide loader and solved by BlockLanczosWide at
     n = 4, left kernel, invariant checks on, to convergence (the JAX
     bench's wide cell, bench.py:124-140 and 471-473, whole); the final
     check and the port's wide checker on the kernel file must pass, and
     the launch counts must show every wide kernel in every iteration;
  10. 50 iterations of BlockLanczosWide and of the narrow BlockLanczos at
     the narrow bench prime, n = 4, each from its own xoshiro v0: v and p
     must be equal;
  12. the mesh's three collectives (csrc/collectives.cu: psum_mod,
     psum_mod_wide, pxor), through the sharded solvers' bound forms
     (PsumMod, PsumModWide, Pxor: prepared launches) on aligned tensors and
     misaligned views, against their plain versions: the folds fed sums
     of R = 1, 2, 3, 4, 15, 16 and 255 ranks' partials made on the card
     (random, every partial p - 1, every word all ones or bit 31 alone), at
     2, 3, 65537, 2^30 - 35 and the bench prime, and at 2^30 + 3, 2^61 - 1
     and 4611686018427387847, at the mesh's shapes, an edge shape (pxor:
     n % 4 != 0, padded planes whose padding stays zeros) and empty
     tensors, also against the exact sums (Python ints for psum_mod_wide,
     the XOR of the words for pxor); the packs and spreads likewise, each
     bound form refusing any tensor but its own;
     each timed at the 1-rank payload through the bound form, the path the
     solvers' step runs (CUDA events: the median of single calls, and back
     to back, a call) with its bound and, for psum_mod and psum_mod_wide,
     torch.remainder; each also at the 4-rank payloads (int64; 31-bit
     halves; 4-bit lanes), pack and fold, with their bounds;
  13. the mesh path at full size on a 1-rank NCCL group: the three sharded
     solvers (parallel/) on a 1 x 1 grid solve bench-n4, bench-gf2-n128 and
     bench-wide-p61-n4 whole; each kernel must equal the single-device
     solve's (phases 4, 6, 9) and pass the checker, the launch counts
     (reset just before, read just after each solve) must show every
     kernel of the field and its collective three times an iteration; the
     transport's 1-rank all_reduce is timed on its own;
  14. a 2 x 2 and a 4 x 1 grid of 4 ranks over gloo, all on the one card
     (spawned by parallel/launch.py; the 4 x 1 grid's axis of 4 takes K1's
     int64 payload, K2's halves and K3's 4-bit lanes): 200 iterations of
     each field at the bench size on each; v and p must equal the
     single-device solvers' after 200 iterations (a check of the mesh,
     not a multi-GPU speed; phase 16's overlap solves follow in the same
     world);
  15. checkpoints (utils/checkpoint.py, the JAX package's on-disk form;
     the CLI's round trip below runs beside the rest, in processes of its
     own):
     the solves of phases 4, 6 and 9 and phase 13's narrow mesh solve each
     save their state at their first block boundary past half their
     expected iterations (CheckpointManager.request_save; the save's
     seconds are taken out of their ms/iter); each is loaded and resumed to
     convergence in a fresh solver, whose kernel file must be
     byte-identical to the uninterrupted one's and pass the checker, with
     every kernel of the field launched (counts reset just before, read
     just after); phase 13's checkpoint also ends at phase 4's file on one
     device, and its first RESUME_ITERS iterations on phase 14's 2 x 2
     grid equal one device's; phase 14's 2 x 2 wide solve saves at its
     middle on the root's request alone (every rank must follow it), and
     that checkpoint resumed to MESH_ITERS on one device and on the 4 x 1
     grid equals the uninterrupted solve; the CLI, `--checkpoint 0
     --sync-every 1` on a 30000 x 20000 matrix, gets SIGTERM after its
     first save line and must exit 143, then `--load-checkpoint` runs to
     the end and the checker passes; the seconds a save and a load take
     and the bytes of each checkpoint are printed beside the card;
  16. comm/compute overlap (the sharded solvers' overlap=True: each SpMV
     in two row chunks, chunk A's all-reduce in flight during chunk B's
     SpMV) on a 1 x 1 NCCL grid: bench-gf2-n128 whole (its kernel file
     byte-identical to phase 6's, checker OK), bench-n4 and
     bench-wide-p61-n4 to 4096 iterations (v and p equal to the one-device
     solvers' there); the launch counts (reset just before, read just
     after each solve) must show every chunk's SpMV (twice phase 13's
     rate), five collective folds and one of each other kernel an
     iteration; each ms/iter printed beside phase 13's; in phase 14's
     world the three fields again with overlap on the 2 x 2 grid, 200
     iterations, v and p equal to one device's; utils/profiling.py's
     trace of 10 iterations of bench-n4, which must name the spmv_ell
     kernel and hold the solve.loop span;
  11. last: print the kernels JSON line (sixteen kernels), the card line,
     and the result line.

Scratch files go to build/chip_smoke/ in the checkout.  Design
measurements (the kernels' shapes and layouts) are in
block_lanczos_tpu_torch/utils/kernel_sweeps.py, not here.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published peak
BOOST_HZ = 1.98e9           # the H100 SXM's boost clock
# Integer multiply-adds run on the CUDA cores: the CUDA C++ Programming
# Guide's throughput table gives 64 32-bit integer multiply(-add)s per clock
# per SM for compute capability 9.0, on 132 SMs.  CUDA-core work is counted
# in such multiply-adds (IMAD, IMAD.WIDE), one operation each.
INT_MAD_PER_S = 64 * 132 * BOOST_HZ
# The tensor-core paths (n >= the kernels' threshold) do 16 u8 limb
# products per residue product, counted against the published int8 rate.
INT8_TC_OPS_PER_S = 1979e12
# The GF(2) kernels' bitwise work: 64 32-bit logical operations (LOP3, which
# does a mask-and-XOR in one) per SM per clock, on 132 SMs at the H100
# SXM's 1.98 GHz boost clock.
LOP3_OPS_PER_S = 64 * 132 * BOOST_HZ
MAIN_NS = (1, 3, 4, 8, 16, 31, 32, 33, 64)
EDGE_ROWS = 20_011          # a multiple of no tile, CTA or fold size
FOLD_ROWS = 2_500_003       # > 8192 rows per CTA: crosses the tensor-core fold
ORTHO_3M_ROWS = 3_000_000   # the 3Mx2M cell's rows: v, p, Av past the L2
TIMING_REPS = 30
GOLDEN = os.path.join(ROOT, "tests", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")
DEVICE = "cuda"
# xoshiro_fill's shapes (field, prime, rows, n): the benchmark cells' v0
# (GF(2) 500,000 x 128; narrow 100,000 x 4 and x 32), a wide one at
# 2^61 - 1, and one whose count is below the kernel's lanes
XOSHIRO_SHAPES = (("gf2", 2, 500_000, 128), ("narrow", 1073741789, 100_000, 4),
                  ("narrow", 1073741789, 100_000, 32),
                  ("wide", (1 << 61) - 1, 100_000, 4),
                  ("narrow", 65537, 37, 4))
# 32-bit integer instructions a draw needs at least: the xoshiro256+ step on
# four u64 words (an add, a rotate and an add for the output; a shift, four
# XORs and a rotate for the state), each two 32-bit halves
XOSHIRO_OPS_PER_DRAW = 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, reps=TIMING_REPS) -> float:
    """Median of `reps` single-call CUDA-event timings, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def per_launch_ms(fn, launches=50, reps=5) -> float:
    """Median over `reps` of CUDA-event ms around `launches` back-to-back
    calls, per call: the host's launch cost hidden behind the device's."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def max_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_err = 0
        self.cases = 0
        self.ms = self.plain_ms = self.bound_ms = self.bound_by = None
        self.library_ms = None
        self.note = None
        self.extra = {}     # further measured numbers, by key

    def agree(self, what, got, want):
        err = max_err(got, want)
        self.max_err = max(self.max_err, err)
        self.cases += 1
        if err != 0:
            raise AssertionError(f"{self.name} disagrees with its plain "
                                 f"version on {what}: max |err| = {err}")

    def as_json(self, launches):
        row = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "launches": launches,
               "max_abs_err": self.max_err, "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": self.bound_by, "library_ms": self.library_ms}
        row.update(self.extra)
        if self.note:
            row["note"] = self.note
        return row

    def set_bound(self, nbytes, nops, ops_per_s=INT_MAD_PER_S):
        self.bound_ms, self.bound_by = bound(nbytes, nops, ops_per_s)
        return self.bound_ms


def bound(nbytes, nops, ops_per_s=INT_MAD_PER_S):
    """The least time for the work, and what sets it: the larger of its
    bytes over the memory rate and its operations over their peak rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / ops_per_s * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def rand_block(rng, rows, n, p, device):
    import torch
    return torch.from_numpy(
        rng.integers(0, p, size=(rows, n), dtype=np.int64).astype(np.int32)
    ).to(device)


def low_rank_sym(rng, n, rank, p):
    """A symmetric n x n residue matrix B B^T mod p of rank <= rank,
    accumulated one reduced outer product at a time (no int64 overflow)."""
    B = rng.integers(0, p, size=(n, rank), dtype=np.int64)
    U = np.zeros((n, n), np.int64)
    for k in range(rank):
        U = (U + np.outer(B[:, k], B[:, k]) % p) % p
    return U


def skewed(t, skew=1):
    """A copy of t whose storage starts `skew` int32 words past a 16-byte
    boundary (so the kernels must take their scalar paths)."""
    import torch
    flat = torch.empty(t.numel() + skew, dtype=t.dtype, device=t.device)
    view = flat[skew:].view(t.shape)
    view.copy_(t)
    return view


def full_block(rows, n, value, device):
    import torch
    return torch.full((rows, n), value, dtype=torch.int32, device=device)


def gram_bound(N, n, mma):
    """[v | Av]^T Av with V2 = W: v and Av read once, G written; N 2n n
    multiply-adds (16 u8 limb products each on the tensor cores)."""
    nbytes = 4 * (2 * N * n + 2 * n * n)
    macs = N * 2 * n * n
    return (bound(nbytes, 2 * 16 * macs, INT8_TC_OPS_PER_S) if mma
            else bound(nbytes, macs))


def ortho_bound(N, n, mma):
    """v, p, Av read, v and p written, rhs and d read; 3 n^2 multiply-adds
    per row (2n for a v' column, n for a p' column)."""
    nbytes = 4 * (5 * N * n + 3 * n * n + n + 4)
    macs = 3 * N * n * n
    return (bound(nbytes, 2 * 16 * macs, INT8_TC_OPS_PER_S) if mma
            else bound(nbytes, macs))


def check_gram(rec, rng, p, rows, dev):
    """gram_mod against gram_mod_plain: the main path's [v | Av]^T Av and
    V2 != W and V2 = None at every n of MAIN_NS (on either side of the
    tensor-core threshold), the worst case (every residue p - 1) across
    the lazy folds and the tensor-core fold, small primes, N = 1, odd
    shapes and misaligned views.  Times n = 4 and n = 32 at `rows` rows
    and returns {n: (ms, plain_ms, (bound_ms, bound_by))}."""
    from block_lanczos_tpu_torch.ops import dense

    def case(what, V1, V2, W, pe):
        rec.agree(what, dense.gram_mod(V1, V2, W, pe),
                  dense.gram_mod_plain(V1, V2, W, pe))

    timed = {}
    for n in MAIN_NS:
        N = rows if n in (4, 32) else EDGE_ROWS
        v, av = rand_block(rng, N, n, p, dev), rand_block(rng, N, n, p, dev)
        case(f"[v|Av]^T Av n={n} N={N}", v, av, av, p)
        case(f"V2 != W n={n} N={N}", v, rand_block(rng, N, n, p, dev), av, p)
        case(f"V2 = None n={n} N={N}", v, None, av, p)
        if n in (4, 32):
            ms = median_ms(lambda: dense.gram_mod(v, av, av, p))
            plain = median_ms(lambda: dense.gram_mod_plain(v, av, av, p),
                              reps=3)
            timed[n] = (ms, plain,
                        gram_bound(N, n, n >= dense.GRAM_MMA_MIN_N))
    for n, N in ((4, EDGE_ROWS), (8, EDGE_ROWS), (16, FOLD_ROWS),
                 (32, FOLD_ROWS)):
        full = full_block(N, n, p - 1, dev)
        case(f"all p-1 n={n} N={N}", full, full, full, p)
        case(f"all p-1 V2 != W n={n} N={N}", full, full.clone(), full, p)
        del full
    for pe in (2, 3, 65537):
        for n in (1, 4, 32):
            v = rand_block(rng, EDGE_ROWS, n, pe, dev)
            av = rand_block(rng, EDGE_ROWS, n, pe, dev)
            case(f"p={pe} n={n}", v, av, av, pe)
            full = full_block(EDGE_ROWS, n, pe - 1, dev)
            case(f"all p-1 p={pe} n={n}", full, full, full, pe)
    for n in (1, 3, 4, 32, 64):
        v, av = rand_block(rng, 1, n, p, dev), rand_block(rng, 1, n, p, dev)
        case(f"N=1 n={n}", v, av, av, p)
    for n in (4, 8, 32):
        v = skewed(rand_block(rng, EDGE_ROWS, n, p, dev))
        av = skewed(rand_block(rng, EDGE_ROWS, n, p, dev))
        case(f"misaligned n={n}", v, av, av, p)
        case(f"misaligned V2 != W n={n}", v, skewed(av), av, p)
    for N, n1, n2, b, pe in ((1, 1, 1, 1, p), (1001, 4, 4, 4, 2),
                             (70_001, 8, 8, 8, 3), (9_001, 40, 0, 32, p),
                             (4097, 1, 0, 1, 65537), (5003, 20, 12, 17, p),
                             (333, 64, 64, 64, p), (777, 3, 5, 2, p),
                             (2001, 6, 6, 6, p), (3001, 5, 0, 5, 3)):
        V1 = rand_block(rng, N, n1, pe, dev)
        V2 = rand_block(rng, N, n2, pe, dev) if n2 else None
        W = rand_block(rng, N, b, pe, dev)
        case(f"N={N} a={n1 + n2} b={b} p={pe}", V1, V2, W, pe)
    return timed


def check_ortho(rec, rng, p, rows, dev, si_mod, L, grams_by_n):
    """orthogonalize against orthogonalize_plain: the main path's n = 4 and
    32 with a real, rank-deficient semi_inverse right-hand side, running
    and halted; every n of MAIN_NS with d all 0, all 1 and mixed, under a
    running, halted (stop), failed-invariant and frozen state; the worst
    case (every residue p - 1), small primes, N = 1 and misaligned views.
    v and p rows differ, so a row written before another thread read it
    would show.  Times n = 4 and n = 32 at `rows` rows and returns
    {n: (ms, plain_ms, (bound_ms, bound_by))}."""
    import torch

    def case(what, v, pb, av, rhs, d, pe, state, skew=0):
        st_k = torch.tensor(state, dtype=torch.int32, device=dev)
        st_p = st_k.clone()
        vk = skewed(v, skew) if skew else v.clone()
        pk = skewed(pb, skew) if skew else pb.clone()
        avk = skewed(av, skew) if skew else av
        vp, pp = v.clone(), pb.clone()
        L.orthogonalize(vk, pk, avk, rhs, d, pe, st_k)
        L.orthogonalize_plain(vp, pp, av, rhs, d, pe, st_p)
        rec.agree(what + " v", vk, vp)
        rec.agree(what + " p", pk, pp)
        rec.agree(what + " state", st_k, st_p)
        if state[0] or not state[1]:
            rec.agree(what + " frozen v", vk, v)
            rec.agree(what + " frozen p", pk, pb)

    def rhs_block(n, pe, value=None):
        """[[top], [bottom-left, 0]] as semi_inverse lays it out."""
        rhs = torch.zeros((2 * n, 2 * n), dtype=torch.int32, device=dev)
        if value is None:
            rhs[:n] = rand_block(rng, n, 2 * n, pe, dev)
            rhs[n:, :n] = rand_block(rng, n, n, pe, dev)
        else:
            rhs[:n] = value
            rhs[n:, :n] = value
        return rhs

    def d_of(kind, n):
        d = {"0": np.zeros(n), "1": np.ones(n),
             "mixed": rng.integers(0, 2, n)}[kind]
        if kind == "mixed" and n > 1:
            d[:2] = (0, 1)
        return torch.from_numpy(d.astype(np.int32)).to(dev)

    running, halted, inv_fail, frozen = ([0, 1, 0, 0], [1, 1, 0, 0],
                                         [0, 0, 0, 0], [1, 1, 5, 1])
    timed = {}
    for n in (4, 32):
        v, av, _ = grams_by_n[n]
        pb = rand_block(rng, v.shape[0], n, p, dev)
        U = low_rank_sym(rng, n, n - 1, p)
        grams = torch.from_numpy(
            np.concatenate([U, U]).astype(np.int32)).to(dev)
        si = si_mod.semi_inverse(grams, p, si_mod.new_state(dev))
        assert int(si.d.sum()) < n, "expected a rank-deficient d"
        for state in (running, halted):
            case(f"bench n={n} state={state}", v, pb, av, si.rhs, si.d, p,
                 state)
        st = si_mod.new_state(dev)
        vk, pk = v.clone(), pb.clone()
        ms = median_ms(
            lambda: L.orthogonalize(vk, pk, av, si.rhs, si.d, p, st))
        plain = median_ms(
            lambda: L.orthogonalize_plain(vk, pk, av, si.rhs, si.d, p,
                                          si_mod.new_state(dev)), reps=3)
        timed[n] = (ms, plain,
                    ortho_bound(v.shape[0], n, n >= L.ORTHO_MMA_MIN_N))
    for n in MAIN_NS:
        v, pb, av = (rand_block(rng, EDGE_ROWS, n, p, dev) for _ in range(3))
        rhs = rhs_block(n, p)
        for kind in ("0", "1", "mixed"):
            states = (running, halted, inv_fail, frozen) \
                if kind == "mixed" else (running,)
            for state in states:
                case(f"n={n} d={kind} state={state}", v, pb, av, rhs,
                     d_of(kind, n), p, state)
    for n in (1, 4, 8, 16, 32, 64):
        full = full_block(EDGE_ROWS, n, p - 1, dev)
        case(f"all p-1 n={n}", full, full, full, rhs_block(n, p, p - 1),
             d_of("mixed", n), p, running)
    for pe in (2, 3, 65537):
        for n in (1, 4, 32):
            v, pb, av = (rand_block(rng, EDGE_ROWS, n, pe, dev)
                         for _ in range(3))
            case(f"p={pe} n={n}", v, pb, av, rhs_block(n, pe),
                 d_of("mixed", n), pe, running)
    for n in (1, 3, 4, 32, 64):
        v, pb, av = (rand_block(rng, 1, n, p, dev) for _ in range(3))
        case(f"N=1 n={n}", v, pb, av, rhs_block(n, p), d_of("mixed", n), p,
             running)
    for n in (3, 4, 8, 32):
        v, pb, av = (rand_block(rng, EDGE_ROWS, n, p, dev) for _ in range(3))
        case(f"misaligned n={n}", v, pb, av, rhs_block(n, p),
             d_of("mixed", n), p, running, skew=1)
    return timed


# ---------------------------------------------------------------------------
# The bitsliced GF(2) kernels
# ---------------------------------------------------------------------------

GF2_EDGE_NS = (32, 64, 160, 512)   # W = 1, 2, 5 (no power of two), 16


def rand_words(rng, rows, W, device):
    """(rows, W) words with every bit random, bit 31 included."""
    import torch
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(rows, W),
                                         dtype=np.int64).astype(np.int32)
                            ).to(device)


def gf2_grams(rng, n, rank, device, full=False):
    """[U ; UA] as (2n, n/32) words: U symmetric of rank <= rank (B B^T with
    B n x rank), or of full rank (L L^T, L unit lower triangular) when
    `full`; UA symmetric."""
    import torch
    from block_lanczos_tpu_torch.ops import gf2
    if full:
        L = np.tril(rng.integers(0, 2, size=(n, n)), -1) + np.eye(n, dtype=int)
        U = (L @ L.T) % 2
    else:
        B = rng.integers(0, 2, size=(n, rank))
        U = (B @ B.T) % 2
    C = rng.integers(0, 2, size=(n, n))
    UA = (C @ C.T) % 2
    w = gf2.pack_bits_np(np.concatenate([U, UA])).view(np.int32)
    return torch.from_numpy(w).to(device)


def gf2_spmv_bound(ops, W, out_rows):
    """Over the bands `ops`: column indices of the true nonzeros, the valid
    words and rowptr read, x read once, y written once; one word XOR per
    nonzero and word."""
    nnz = sum(b.nnz for b in ops)
    nbytes = 4 * (nnz + sum(b.valid.numel() + b.out_dim + 1 for b in ops)
                  + ops[0].in_dim * W + out_rows * W)
    return bound(nbytes, nnz * W, LOP3_OPS_PER_S)


def gf2_gram_bound(N, n, ops_per_s):
    """v and Av read once, G written; 2n x n bit multiply-adds per row
    (2 operations each) on the binary tensor cores, at ops_per_s (the rate
    gram_gf2_rate measures)."""
    W = n // 32
    return bound(4 * (2 * N * W + 2 * n * W), 2 * N * 2 * n * n, ops_per_s)


def gf2_ortho_bound(N, n, ops_per_s):
    """v, p, Av read, v and p written, rhs and d read; 3 n^2 bit
    multiply-adds per row (the p rows' right half of rhs is zero), as on
    the binary tensor cores at ops_per_s."""
    W = n // 32
    return bound(4 * (5 * N * W + 4 * n * W + n + 4), 2 * N * 3 * n * n,
                 ops_per_s)


def int_mm_parity(A01, B01):
    """The library yardstick of the GF(2) products: torch._int_mm of 0/1
    int8 matrices, kept mod 2."""
    import torch
    return torch._int_mm(A01, B01) & 1


def check_spmv_gf2(rec, rng, dev, G, sg):
    """spmv_gf2 against spmv_gf2_plain: the bench operators mod 2 in both
    directions at n = 128 and 256; every edge width (W = 1, 2, 5, 16) on a
    second matrix, both directions; forced slabs wider than 32 (two and
    three valid words), an empty spill, one long spill row, out_dim a
    multiple of no CTA, all-ones x, bit 31 set everywhere, x and y off
    their 16-byte alignment; 2, 3 and 7 column bands (some empty); x past
    the L2 (96 MB) in one band and in the solver's bands.  Times n = 128
    (the mean of the directions)."""
    import torch
    from block_lanczos_tpu_torch.utils import gen

    def case(what, ops, x, out_rows, out=None):
        rec.agree(what, G.spmv_gf2(ops, x, out_rows, out=out),
                  G.spmv_gf2_plain(ops, x, out_rows))

    def bands_on(*args):
        return tuple(b.to(dev) for b in G.make_gf2_bands(*args))

    ms, plain, bounds = [], [], []
    for n in (128, 256):
        W = n // 32
        for name, op, in_rows, out_rows in (
                ("Mt*v", sg.first_op, sg.np_rows, sg.mp_rows),
                ("M*tmp", sg.second_op, sg.mp_rows, sg.np_rows)):
            x = rand_words(rng, in_rows, W, dev)
            case(f"bench {name} n={n}", op, x, out_rows)
            if n == 128:
                ms.append(median_ms(lambda: G.spmv_gf2(op, x, out_rows)))
                plain.append(median_ms(
                    lambda: G.spmv_gf2_plain(op, x, out_rows), reps=5))
                bounds.append(gf2_spmv_bound(op, W, out_rows))
                print(f"  spmv_gf2 {name} n=128: {ms[-1]:.4f} ms, plain "
                      f"{plain[-1]:.4f} ms, bound {bounds[-1][0]:.4f} ms "
                      f"({bounds[-1][1]}), library_ms: none", flush=True)
    rec.ms, rec.plain_ms = statistics.mean(ms), statistics.mean(plain)
    rec.bound_ms = statistics.mean(b for b, _ in bounds)
    rec.bound_by = bounds[0][1]
    # edge widths on a second matrix with a long spill row
    i, j, _ = gen.random_sparse(EDGE_ROWS, 15013, 9, seed=5)
    i = np.concatenate([i, np.full(5000, 17), np.arange(40)])
    j = np.concatenate([j, rng.integers(0, 15013, 5000), np.arange(40)])
    for out_dim, in_dim, oi, ii in ((EDGE_ROWS, 15013, i, j),
                                    (15013, EDGE_ROWS, j, i)):
        op = G.make_gf2_op(oi, ii, out_dim, in_dim)
        if out_dim == EDGE_ROWS:
            assert op.spill_nnz >= 5000, "long spill row missing"
        op = (op.to(dev),)
        for n in GF2_EDGE_NS:
            x = rand_words(rng, in_dim + 5, n // 32, dev)
            case(f"edge n={n} out={out_dim}", op, x, out_dim + 13)
        x = torch.full((in_dim, 4), -1, dtype=torch.int32, device=dev)
        case(f"all-ones x out={out_dim}", op, x, out_dim)
    # slabs wider than one valid word; rows longer than the slab
    for ell in (40, 70):
        rows = np.repeat(np.arange(301), 75)
        op = G.make_gf2_op(rows, rng.integers(0, 250, rows.size), 301, 250,
                           ell=ell)
        assert op.valid.shape[0] == (ell + 31) // 32 > 1 and op.spill_nnz
        op = (op.to(dev),)
        for n in (32, 128, 160):
            case(f"ell={ell} n={n}", op, rand_words(rng, 250, n // 32, dev),
                 307)
    op = G.make_gf2_op(np.arange(999) % 333, np.arange(999) % 71, 333, 71)
    assert op.spill_nnz == 0
    case("empty spill", (op.to(dev),), rand_words(rng, 71, 4, dev), 341)
    op = sg.second_op
    for skew in (1, 2):
        x = skewed(rand_words(rng, sg.mp_rows, 4, dev), skew)
        y = skewed(torch.empty((sg.np_rows, 4), dtype=torch.int32,
                               device=dev), skew)
        case(f"misaligned by {skew} words", op, x, sg.np_rows, out=y)
    # column bands: the edge matrix without columns 5000..9999, so that
    # some of 7 bands hold no entry and most rows miss some band
    keep = (j < 5000) | (j >= 10000)
    for bands in (2, 3, 7):
        op = bands_on(i[keep], j[keep], EDGE_ROWS, 15013, bands)
        for n in (32, 128, 160):
            case(f"bands={bands} n={n}", op,
                 rand_words(rng, 15013 + 5, n // 32, dev), EDGE_ROWS + 13)
        x = skewed(rand_words(rng, 15013, 4, dev))
        case(f"bands={bands} misaligned", op, x, EDGE_ROWS + 13)
    # x past the L2: 3M rows at n = 256 (96 MB), 500k output rows of 10
    # entries, from the seed; one band and the bands the solver would take
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    in_dim, out_dim = 3_000_000, 500_000
    oi = np.repeat(np.arange(out_dim), 10)
    ii = rng.integers(0, in_dim, oi.size)
    x = rand_words(rng, in_dim, 8, dev)
    mb = x.numel() * 4 / 2 ** 20
    assert mb >= 64, mb
    for bands in (1, G.choose_bands(in_dim, 8, l2)):
        op = bands_on(oi, ii, out_dim, in_dim, bands)
        case(f"x {mb:.0f} MB bands={bands}", op, x, out_dim + 7)
        print(f"  spmv_gf2 x {mb:.0f} MB (L2 {l2 >> 20} MB), {bands} "
              f"band(s): {median_ms(lambda: G.spmv_gf2(op, x, out_dim)):.4f}"
              " ms a product", flush=True)
    del op, x
    print(f"  spmv_gf2: {rec.cases} cases equal", flush=True)


def check_gram_gf2(rec, rng, dev, gf2, avs, b1_rate):
    """gram_gf2 against gram_gf2_plain: the bench's [v | Av]^T Av at n = 128
    and 256 (`avs`: {n: (v, Av)}), every edge width at N a multiple of no
    staging round, N = 1, all-ones blocks.  Times n = 128 and the library
    yardstick (torch._int_mm of the unpacked bits, with the unpack's
    time); bounds it at the measured binary rate b1_rate.  Returns
    (unpack_ms, int_mm_ms)."""
    import torch

    def case(what, v, av):
        rec.agree(what, gf2.gram_gf2(v, av), gf2.gram_gf2_plain(v, av))

    for n, (v, av) in avs.items():
        case(f"bench n={n}", v, av)
    v, av = avs[128]
    rec.ms = median_ms(lambda: gf2.gram_gf2(v, av))
    rec.plain_ms = median_ms(lambda: gf2.gram_gf2_plain(v, av), reps=5)
    rec.bound_ms, rec.bound_by = gf2_gram_bound(v.shape[0], 128, b1_rate)

    def unpack():
        X = gf2.unpack_bits(torch.cat([v, av], dim=1)).to(torch.int8)
        return X.T.contiguous(), gf2.unpack_bits(av).to(torch.int8)

    unpack_ms = median_ms(unpack, reps=5)
    XT, A = unpack()
    lib = gf2.pack_bits(int_mm_parity(XT, A))
    rec.agree("library yardstick n=128", lib, gf2.gram_gf2(v, av))
    rec.library_ms = median_ms(lambda: int_mm_parity(XT, A))
    # every W = n / 32 (every region shape of the kernel), N a multiple of
    # no K-tile, one K-tile and either side of it, N = 1; bit 31 set
    for W in range(1, 17):
        for N in (EDGE_ROWS, 1, 255, 256, 257):
            case(f"n={32 * W} N={N}", rand_words(rng, N, W, dev),
                 rand_words(rng, N, W, dev))
        ones = torch.full((EDGE_ROWS, W), -1, dtype=torch.int32, device=dev)
        case(f"all ones n={32 * W}", ones, ones.clone())
    print(f"  gram_gf2: {rec.cases} cases equal", flush=True)
    return unpack_ms, rec.library_ms


def check_si_gf2(rec, rng, dev, gf2, real_grams):
    """semi_inverse_gf2 against semi_inverse_gf2_plain (all outputs and the
    state): the bench's Grams at n = 128 and 256, zero, singular and
    full-rank Grams at every edge width, a failing invariant, the check
    off, and a frozen state (left as it is).  Times n = 128."""
    import torch

    def case(what, grams, state=(0, 1, 0, 0), check=True):
        s_k = torch.tensor(state, dtype=torch.int32, device=dev)
        s_p = s_k.clone()
        got = gf2.semi_inverse_gf2(grams, s_k, check)
        want = gf2.semi_inverse_gf2_plain(grams, s_p, check)
        for a, b in zip(got, want):
            rec.agree(what, a, b)
        rec.agree(what + " state", s_k, s_p)
        return got, s_k

    for n, grams in real_grams.items():
        case(f"bench n={n}", grams)
    g128 = real_grams[128]
    state = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
    rec.ms = median_ms(lambda: gf2.semi_inverse_gf2(g128, state))
    rec.plain_ms = median_ms(
        lambda: gf2.semi_inverse_gf2_plain(g128, state.clone()), reps=3)
    n, W = 128, 4
    # grams read; winv, d, npiv, rhs and the state written; two
    # eliminations of n steps over n rows of W words (phase 2 with W), the
    # check and the right-hand side (n rows x n x W masked XORs each), one
    # LOP3 a masked XOR
    rec.set_bound(4 * (2 * n * W + n * W + n + 1 + 4 * n * W + 4),
                  3 * n * n * W + 2 * n * n * W, LOP3_OPS_PER_S)
    # the chain: 2n dependent pivot steps, each at least a warp reduction
    # (~40 cycles, PERF.md) and a dependent read of the pivot row, ~80
    # cycles at the 1.98 GHz boost clock
    chain_ms = 2 * n * 80 / 1.98e9 * 1e3
    rec.note = ("latency-bound: the 2n pivot steps run one after another in "
                "one CTA, so neither bytes nor operations bound it; the "
                f"chain of 2n >= ~80-cycle steps is >= {chain_ms:.4f} ms")
    # n = 64 is the widest one-warp elimination (W = SI2_WARP_MAXW), 96 the
    # narrowest with one thread a row
    for n in GF2_EDGE_NS + (96, 128, 256):
        for rank in (0, n // 3, n + 7):
            got, s_k = case(f"n={n} rank<={rank}",
                            gf2_grams(rng, n, rank, dev))
            if rank == 0:
                assert int(got.npiv[0]) == 0 and int(s_k[0]) == 1, \
                    "zero Gram"
        got, _ = case(f"n={n} full rank", gf2_grams(rng, n, 0, dev,
                                                    full=True))
        assert int(got.npiv[0]) == n, "expected a full-rank Gram"
        # a dense non-symmetric U whose phase-2 pivots differ from phase
        # 1's (drawn until one does)
        for _ in range(40):
            g = rand_words(rng, 2 * n, n // 32, dev)
            U = g[:n].cpu()
            _, _, d1, _ = gf2._eliminate_plain(U, torch.zeros_like(U))
            if not torch.equal(gf2.semi_inverse_gf2_core(U, n)[1], d1):
                break
        else:
            raise AssertionError(f"n={n}: no Gram with d != d1 drawn")
        _, s_k = case(f"n={n} non-symmetric, d != d1", g)
        assert int(s_k[1]) == 0, "a non-symmetric Gram passed the check"
    bad = gf2_grams(rng, 64, 20, dev)
    bad[64 + 3, 0] ^= 1 << 9      # vtAAv[3, 9] flipped: not symmetric
    _, s_k = case("n=64 failing check", bad)
    assert int(s_k[1]) == 0, "the check should fail"
    case("n=64 check off", bad, check=False)
    for state in ((1, 1, 0, 0), (0, 0, 0, 0)):    # stopped, failed
        case(f"n=64 state={state}", bad, state=state)
    _, s_k = case("n=64 frozen state", bad, state=(1, 1, 5, 1))
    assert s_k.tolist() == [1, 1, 5, 1], "a frozen state changed"
    print(f"  semi_inverse_gf2: {rec.cases} cases equal", flush=True)


def check_ortho_gf2(rec, rng, dev, G, gf2, avs, real_si, b1_rate):
    """orthogonalize_gf2 against orthogonalize_gf2_plain: the bench rows
    at n = 128 and 256 with the bench's right-hand side, running and
    stopped; every edge width with d all 0, all 1 and mixed under running,
    stopped, failed-invariant and frozen states; N = 1.  v and p rows
    differ and carry bit 31.  Times n = 128 and the library yardstick;
    bounds it at the measured binary rate b1_rate.  Returns (unpack_ms,
    int_mm_ms)."""
    import torch

    def case(what, v, pb, av, rhs, d, state):
        st_k = torch.tensor(state, dtype=torch.int32, device=dev)
        st_p = st_k.clone()
        vk, pk, vp, pp = v.clone(), pb.clone(), v.clone(), pb.clone()
        G.orthogonalize_gf2(vk, pk, av, rhs, d, st_k)
        G.orthogonalize_gf2_plain(vp, pp, av, rhs, d, st_p)
        rec.agree(what + " v", vk, vp)
        rec.agree(what + " p", pk, pp)
        rec.agree(what + " state", st_k, st_p)
        if state[0] or not state[1]:
            rec.agree(what + " frozen v", vk, v)
            rec.agree(what + " frozen p", pk, pb)

    def rhs_block(n):
        """[[top], [bottom-left, 0]] as semi_inverse_gf2 lays it out."""
        W = n // 32
        rhs = rand_words(rng, 2 * n, 2 * W, dev)
        rhs[n:, W:] = 0
        return rhs

    def d_of(kind, n):
        d = {"0": np.zeros(n), "1": np.ones(n),
             "mixed": rng.integers(0, 2, n)}[kind]
        if kind == "mixed":
            d[:2] = (0, 1)
        return torch.from_numpy(d.astype(np.int32)).to(dev)

    running, halted, inv_fail, frozen = ((0, 1, 0, 0), (1, 1, 0, 0),
                                         (0, 0, 0, 0), (1, 1, 5, 1))
    for n, (v, av) in avs.items():
        si = real_si[n]
        pb = rand_words(rng, v.shape[0], n // 32, dev)
        for state in (running, halted):
            case(f"bench n={n} state={state}", v, pb, av, si.rhs, si.d,
                 state)
    v, av = avs[128]
    si = real_si[128]
    pb = rand_words(rng, v.shape[0], 4, dev)
    st = torch.tensor(running, dtype=torch.int32, device=dev)
    vk, pk = v.clone(), pb.clone()
    rec.ms = median_ms(lambda: G.orthogonalize_gf2(vk, pk, av, si.rhs, si.d,
                                                   st))
    rec.plain_ms = median_ms(
        lambda: G.orthogonalize_gf2_plain(vk, pk, av, si.rhs, si.d,
                                          st.clone()), reps=5)
    rec.bound_ms, rec.bound_by = gf2_ortho_bound(v.shape[0], 128, b1_rate)

    def unpack():
        X = gf2.unpack_bits(torch.cat([v, pb], dim=1)).to(torch.int8)
        return X, gf2.unpack_bits(si.rhs).to(torch.int8)

    unpack_ms = median_ms(unpack, reps=5)
    X, R = unpack()
    upd = gf2.pack_bits(int_mm_parity(X, R))
    rec.agree("library yardstick n=128", upd,
              gf2.matmul_gf2(torch.cat([v, pb], dim=1), si.rhs, 256))
    rec.library_ms = median_ms(lambda: int_mm_parity(X, R))
    # n = 32 runs the CUDA-core kernel, n >= 64 (OG_MMA_MIN_N) the tensor
    # cores
    for n in GF2_EDGE_NS + (96,):
        W = n // 32
        v, pb, av = (rand_words(rng, EDGE_ROWS, W, dev) for _ in range(3))
        rhs = rhs_block(n)
        for kind in ("0", "1", "mixed"):
            states = ((running, halted, inv_fail, frozen)
                      if kind == "mixed" else (running,))
            for state in states:
                case(f"n={n} d={kind} state={state}", v, pb, av, rhs,
                     d_of(kind, n), state)
        # either side of a warp's 32-row tile; no rows at all
        for N in (1, 31, 32, 33, 0):
            vn, pn, an = (rand_words(rng, N, W, dev) for _ in range(3))
            case(f"N={N} n={n}", vn, pn, an, rhs, d_of("mixed", n), running)
        # every count at its most (256 a K-step)
        ones = torch.full((EDGE_ROWS, W), -1, dtype=torch.int32, device=dev)
        ones_rhs = torch.full_like(rhs, -1)
        ones_rhs[n:, W:] = 0
        case(f"all ones n={n}", ones, ones.clone(), ones.clone(), ones_rhs,
             d_of("mixed", n), running)
    # at the height of the 3Mx2M cell (3M rows, n = 128: 240 MB moved,
    # past the L2), timed only
    N3 = ORTHO_3M_ROWS
    v3, p3, a3 = (rand_words(rng, N3, 4, dev) for _ in range(3))
    ms3 = median_ms(lambda: G.orthogonalize_gf2(v3, p3, a3, si.rhs, si.d, st))
    b3 = gf2_ortho_bound(N3, 128, b1_rate)
    print(f"  orthogonalize_gf2 n=128 on {N3} rows: {ms3:.4f} ms, bound "
          f"{b3[0]:.4f} ms ({b3[1]})", flush=True)
    del v3, p3, a3
    print(f"  orthogonalize_gf2: {rec.cases} cases equal", flush=True)
    return unpack_ms, rec.library_ms


def check_gf2_kernels(recs, rng, dev, sg):
    """Phase 2 of the GF(2) kernels, on the bench operators of the GF(2)
    solver `sg` (the layout does not depend on n): every kernel against
    its plain version, then the timing line at n = 128."""
    from block_lanczos_tpu_torch.models import lanczos_gf2 as G
    from block_lanczos_tpu_torch.ops import gf2
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    from block_lanczos_tpu_torch.utils.kernel_sweeps import mma_rate
    b1_rate = mma_rate()
    print(f"  binary tensor-core rate, measured (gram_gf2_rate, mma.sync "
          f"m16n8k256 .and.popc): {b1_rate / 1e12:.1f} TOP/s; the GF(2) "
          "products are bounded at it", flush=True)
    check_spmv_gf2(recs["spmv_gf2"], rng, dev, G, sg)
    avs, real_grams, real_si = {}, {}, {}
    for n in (128, 256):
        v = rand_words(rng, sg.np_rows, n // 32, dev)
        tmp = G.spmv_gf2(sg.first_op, v, sg.mp_rows)
        avs[n] = (v, G.spmv_gf2(sg.second_op, tmp, sg.np_rows))
        real_grams[n] = gf2.gram_gf2(*avs[n])
        real_si[n] = gf2.semi_inverse_gf2(real_grams[n], new_state(dev))
    g_unpack, g_lib = check_gram_gf2(recs["gram_gf2"], rng, dev, gf2, avs,
                                     b1_rate)
    check_si_gf2(recs["semi_inverse_gf2"], rng, dev, gf2, real_grams)
    o_unpack, o_lib = check_ortho_gf2(recs["orthogonalize_gf2"], rng, dev, G,
                                      gf2, avs, real_si, b1_rate)
    N = avs[128][0].shape[0]
    print("  GF(2) products' bounds at the measured binary rate, n=256: "
          + "; ".join(f"{name} {b[0]:.6f} ms ({b[1]})"
                      for name, fn in (("gram_gf2", gf2_gram_bound),
                                       ("orthogonalize_gf2", gf2_ortho_bound))
                      for b in [fn(N, 256, b1_rate)]), flush=True)
    for name in ("gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2"):
        r = recs[name]
        print(f"  {name} n=128: {r.ms:.4f} ms, plain {r.plain_ms:.4f} ms, "
              f"bound {r.bound_ms:.6f} ms ({r.bound_by}), library_ms: "
              f"{'none' if r.library_ms is None else f'{r.library_ms:.4f}'}",
              flush=True)
    print(f"  library yardsticks (torch._int_mm of 0/1 int8 bits, & 1): "
          f"gram {g_lib:.4f} ms + unpack {g_unpack:.4f} ms; orthogonalize's "
          f"product {o_lib:.4f} ms + unpack {o_unpack:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# The wide-field kernels (2^30 - 35 < p < 2^62, u64 residues)
# ---------------------------------------------------------------------------

WIDE_PRIMES = (1073741827, (1 << 61) - 1, 4611686018427387847)  # 2^30 + 3,
# 2^61 - 1 (the bench's) and the largest prime below 2^62
WIDE_NS = (1, 2, 3, 4, 8, 16, 32, 64)
# orthogonalize_wide also at odd n and n = 2 mod 4 on the tensor cores: an
# 8-column tile across v' and p', 8-byte stores
ORTHO_NS = WIDE_NS + (5, 6, 17, 34)
# A 64 x 64 -> 128-bit multiply-add on the CUDA cores: a * b (3 IMADs),
# __umul64hi (4) and the carry add, counted as 8 integer multiply-adds; the
# narrow slab's product x * c is three IMAD.WIDE (one a 21-bit limb of x).
WIDE_MAC_OPS = 8
NARROW_MAC_OPS = 3
# gram_wide's limb products: 64 u8 products a residue product (8 limbs a
# residue), two operations each on the int8 tensor cores.
WIDE_LIMB_PRODUCTS = 64
# semi_inverse_wide's dependent chain, in cycles: a pivot step at least a
# warp reduction and a dependent read (~80, as for the narrow and GF(2)
# eliminations), and the inverse's steps (modp64.cuh::almost_inverse, as
# many as the pivots' product needs: ops/gfp_wide.py::semi_inverse_mont_np
# counts them) at the latency of one step, which utils/kernel_sweeps.py's
# microbenchmark (the SIW_STEP_BENCH build: one thread, almost_inverse
# alone on 512 random residues, clock64) measured on an H100 80GB HBM3 at
# 700 W (PERF.md), apart from the kernel.
WIDE_STEP_CYCLES = 80
WIDE_INV_STEP_CYCLES = 124.8
# gram_wide built with recombinations every 64 / 128 rows (the defaults are
# 32,768 and 4,096, which a solve on one card never reaches), so that phase
# 2 crosses them
GRAM_WIDE_SMALL_FOLDS = {"GW_FOLDED_FOLD_ROWS": 64, "GW_CLASS_FOLD_ROWS": 128}


def rand_wide(rng, rows, n, p, device):
    """(rows, n) int64 residues drawn over the full 62 bits, reduced."""
    import torch
    return torch.from_numpy(
        rng.integers(0, 1 << 62, size=(rows, n), dtype=np.int64) % p
    ).to(device)


def wide_spmv_work(op, n, out_rows):
    """(bytes, operations): a slab entry (int32 column, int32 coefficient
    or int64 residue) per true nonzero, x read, y written, rowptr; one
    narrow or wide multiply-add per nonzero and column."""
    import torch
    narrow = op.vals.dtype == torch.int32
    return ((8 if narrow else 12) * op.nnz + 8 * op.in_dim * n
            + 8 * out_rows * n + 4 * (op.out_dim + 1),
            (NARROW_MAC_OPS if narrow else WIDE_MAC_OPS) * op.nnz * n)


def wide_gram_bound(N, n):
    """v and Av read once, G written; N 2n n residue products of 64 u8
    limb products each on the int8 tensor cores."""
    return bound(8 * (2 * N * n + 2 * n * n),
                 2 * WIDE_LIMB_PRODUCTS * N * 2 * n * n, INT8_TC_OPS_PER_S)


def wide_ortho_bound(N, n):
    """v, p, Av read, v and p written, rhs and d read; 3 n^2 residue
    products a row: wide multiply-adds on the CUDA cores on the row path,
    64 u8 limb products each on the int8 tensor cores from the threshold
    (ops/gfp_wide.py::OW_MMA_MIN_N)."""
    from block_lanczos_tpu_torch.ops.gfp_wide import OW_MMA_MIN_N
    nbytes = 8 * (5 * N * n + 4 * n * n) + 4 * (n + 4)
    if n >= OW_MMA_MIN_N:
        return bound(nbytes, 2 * WIDE_LIMB_PRODUCTS * 3 * N * n * n,
                     INT8_TC_OPS_PER_S)
    return bound(nbytes, WIDE_MAC_OPS * 3 * N * n * n)


def wide_si_bound(p, n, U):
    """(bound_ms, bound_by, chain_ms, inverse steps) of semi_inverse_wide
    on the Gram U: bytes (grams read; winv, d, npiv, rhs, state written)
    against operations (two eliminations of M and W, 4 n^3 wide
    multiply-adds; the check and the right-hand side, 2 n^3); the dependent
    chain: 2n pivot steps of WIDE_STEP_CYCLES and the inverse's steps for
    this Gram's pivots' product of WIDE_INV_STEP_CYCLES."""
    from block_lanczos_tpu_torch.ops.gfp_wide import semi_inverse_mont_np
    b = bound(8 * (2 * n * n + n * n + 4 * n * n) + 4 * (n + 1 + 4),
              WIDE_MAC_OPS * 6 * n ** 3)
    steps = semi_inverse_mont_np(p, U)[3]
    chain = (2 * n * WIDE_STEP_CYCLES + steps * WIDE_INV_STEP_CYCLES) \
        / BOOST_HZ * 1e3
    return (*b, chain, steps)


def check_spmv_wide(rec, rng, dev, wo, ws):
    """spmv_wide against spmv_wide_plain: the bench operators at 2^61 - 1
    in both directions at n = 4 (timed) on their narrow slab (the bench's
    values are below 2^20) and on the u64 slab, and the gather-only build
    (the same loads, the products XORed) timed beside them: the L2-sector
    floor; at every prime of WIDE_PRIMES and every n of WIDE_NS an edge
    matrix with one long spill row in both directions, with full-range and
    with small signed coefficients, each on its default slab and on the u64
    slab; signed coefficients +-1 and +-(2^31 - 1) against x = 0 and p - 1,
    and a spill row of 3000 of them past the narrow slab's fold; the lazy
    sums' worst case (every value and x at p - 1, rows longer than the fold
    in slab and spill) on both slabs, aligned and not; a zero x; an empty
    spill."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
    from block_lanczos_tpu_torch.utils import gen

    f = ws.f
    ms, plain, nbytes, nops = [], [], [], []
    back, u64_ms, floor_ms = [], [], []
    for name, op, in_rows, out_rows in (
            ("Mt*v", ws.first_op, ws.np_rows, ws.mp_rows),
            ("M*tmp", ws.second_op, ws.mp_rows, ws.np_rows)):
        assert op.vals.dtype == torch.int32, "the bench takes the narrow slab"
        wide = wo.u64_slab(op)
        x = rand_wide(rng, in_rows, 4, f.p, dev)
        want = wo.spmv_wide_plain(op, x, out_rows)
        rec.agree(f"bench {name} n=4", wo.spmv_wide(f, op, x, out_rows),
                  want)
        rec.agree(f"bench {name} n=4 u64 slab",
                  wo.spmv_wide(f, wide, x, out_rows), want)
        k_ms = median_ms(lambda: wo.spmv_wide(f, op, x, out_rows))
        # back to back, so that the host's launch cost does not blur them:
        # this slab, the u64 slab, and the same loads with the products
        # XORed (the gather-only build: the L2-sector floor)
        b_ms = per_launch_ms(lambda: wo.spmv_wide(f, op, x, out_rows))
        w_ms = per_launch_ms(lambda: wo.spmv_wide(f, wide, x, out_rows))
        with kernels.variant("spmv_wide", SPMV_WIDE_GATHER_ONLY=1):
            g_ms = per_launch_ms(lambda: wo.spmv_wide(f, op, x, out_rows))
        p_ms = median_ms(lambda: wo.spmv_wide_plain(op, x, out_rows), reps=3)
        nb, no = wide_spmv_work(op, 4, out_rows)
        b = bound(nb, no)
        for lst, val in ((ms, k_ms), (plain, p_ms), (nbytes, nb), (nops, no),
                         (back, b_ms), (u64_ms, w_ms), (floor_ms, g_ms)):
            lst.append(val)
        print(f"  spmv_wide {name} n=4: {k_ms:.4f} ms (back to back "
              f"{b_ms:.4f}, u64 slab {w_ms:.4f}, gather-only {g_ms:.4f}), "
              f"plain {p_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
              "library_ms: none", flush=True)
    rec.ms, rec.plain_ms = statistics.mean(ms), statistics.mean(plain)
    rec.set_bound(statistics.mean(nbytes), statistics.mean(nops))
    rec.note = (f"narrow slab; back to back {statistics.mean(back):.4f} ms, "
                f"the u64 slab {statistics.mean(u64_ms):.4f}, the L2-sector "
                f"floor (the gather-only build: the same loads, the products "
                f"XORed) {statistics.mean(floor_ms):.4f} (means of M^T and "
                f"M)")
    i, j, _ = gen.random_sparse(3001, 1517, 7, seed=17)
    i = np.concatenate([i, np.full(3000, 17), np.arange(40)])
    j = np.concatenate([j, rng.integers(0, 1517, 3000), np.arange(40)])
    cmax = (1 << 31) - 1
    for p in WIDE_PRIMES:
        fe = GFpWide.make(p)
        vals = {"full": rng.integers(0, 1 << 62, i.size, dtype=np.int64) % p,
                "small": rng.integers(-cmax, cmax + 1, i.size) % p}
        for kind, x in vals.items():
            for out_dim, in_dim, oi, ii in ((3001, 1517, i, j),
                                            (1517, 3001, j, i)):
                chosen = wo.make_wide_op(fe, oi, ii, x, out_dim, in_dim)
                for op in (chosen, wo.u64_slab(chosen)):
                    if out_dim == 3001:
                        assert op.spill_nnz >= 3000, "long spill row missing"
                    slab = str(op.vals.dtype)
                    op = op.to(dev)
                    for n in WIDE_NS:
                        xb = rand_wide(rng, in_dim + 5, n, p, dev)
                        rec.agree(f"edge p={p} {kind} {slab} n={n} "
                                  f"out={out_dim}",
                                  wo.spmv_wide(fe, op, xb, out_dim + 13),
                                  wo.spmv_wide_plain(op, xb, out_dim + 13))
                    xz = torch.zeros((in_dim, 4), dtype=torch.int64,
                                     device=dev)
                    rec.agree(f"zero x p={p} {kind} {slab} out={out_dim}",
                              wo.spmv_wide(fe, op, xz, out_dim),
                              wo.spmv_wide_plain(op, xz, out_dim))
        # the narrow slab's edges: c = +-1, +-(2^31 - 1) against x rows 0
        # and p - 1 (and a random row), and a spill row of 3000 of them
        cs = np.array([1, -1, cmax, -cmax])
        si = np.concatenate([np.repeat(np.arange(12), 3),
                             np.full(3000, 12)])
        sj = np.concatenate([np.tile(np.arange(3), 12),
                             np.arange(3000) % 2])
        sv = np.concatenate([np.repeat(cs, 9), np.tile(cs, 750)]) % p
        chosen = wo.make_wide_op(fe, si, sj, sv, 13, 3, ell=3)
        assert chosen.vals.dtype == torch.int32, "+-(2^31 - 1) fit"
        for op in (chosen, wo.u64_slab(chosen)):
            op = op.to(dev)
            for n in (1, 2, 4):
                xs = torch.cat([torch.zeros((1, n), dtype=torch.int64),
                                torch.full((1, n), p - 1, dtype=torch.int64),
                                torch.from_numpy(rng.integers(
                                    0, p, (1, n), dtype=np.int64))]).to(dev)
                rec.agree(f"signs p={p} {op.vals.dtype} n={n}",
                          wo.spmv_wide(fe, op, xs, 16),
                          wo.spmv_wide_plain(op, xs, 16))
        # worst case of the lazy sums, at every vector width and off the
        # 16-byte alignment, on both slabs
        fold = 8
        wi = np.concatenate([np.repeat(np.arange(300), 2 * fold + 5),
                             np.full(600, 7), np.arange(40) * 3])
        wj = rng.integers(0, 250, wi.size)
        chosen = wo.make_wide_op(fe, wi, wj, np.full(wi.size, p - 1), 300,
                                 250, ell=2 * fold + 3)
        for op in (chosen, wo.u64_slab(chosen)):
            op = op.to(dev)
            assert op.spill_nnz > 600 + 300
            for n in WIDE_NS:
                for skew in (0, 1):
                    xf = torch.full((250 * n + skew,), p - 1,
                                    dtype=torch.int64, device=dev)
                    yf = torch.empty((307 * n + skew,), dtype=torch.int64,
                                     device=dev)
                    xb, yb = xf[skew:].view(250, n), yf[skew:].view(307, n)
                    rec.agree(f"all p-1 p={p} {op.vals.dtype} n={n} "
                              f"misaligned={skew}",
                              wo.spmv_wide(fe, op, xb, 307, out=yb),
                              wo.spmv_wide_plain(op, xb, 307))
        op = wo.make_wide_op(fe, np.arange(999) % 333, np.arange(999) % 71,
                             np.arange(1, 1000), 333, 71).to(dev)
        assert op.spill_nnz == 0
        xb = rand_wide(rng, 71, 3, p, dev)
        rec.agree(f"empty spill p={p}", wo.spmv_wide(fe, op, xb, 341),
                  wo.spmv_wide_plain(op, xb, 341))


def check_gram_wide(rec, rng, dev, wo, ws):
    """gram_wide against gram_wide_plain: [v | Av]^T Av at the bench's rows
    at n = 4 (timed) and all p - 1 there, at n = 32 (timed); FOLD_ROWS rows
    (past the tensor-core folds' rows a CTA at n = 32) with all p - 1 at
    n = 4 and 32; every prime and n of WIDE_NS (both sides of the shift
    classes' threshold, n = 4 / 8) at EDGE_ROWS, all p - 1, zero blocks,
    N = 1 and N = 0; and the same with the build that recombines every 64
    / 128 rows (GRAM_WIDE_SMALL_FOLDS), so that every fold is crossed."""
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide

    f, N = ws.f, ws.np_rows
    v, av = rand_wide(rng, N, 4, f.p, dev), rand_wide(rng, N, 4, f.p, dev)
    rec.agree("bench n=4", wo.gram_wide(v, av, f),
              wo.gram_wide_plain(v, av, f.p))
    rec.ms = median_ms(lambda: wo.gram_wide(v, av, f))
    rec.plain_ms = median_ms(lambda: wo.gram_wide_plain(v, av, f.p), reps=3)
    rec.bound_ms, rec.bound_by = wide_gram_bound(N, 4)
    full = torch.full((N, 4), f.p - 1, dtype=torch.int64, device=dev)
    rec.agree("bench all p-1 n=4", wo.gram_wide(full, full, f),
              wo.gram_wide_plain(full, full, f.p))
    v32, av32 = (rand_wide(rng, N, 32, f.p, dev) for _ in range(2))
    rec.agree("bench n=32", wo.gram_wide(v32, av32, f),
              wo.gram_wide_plain(v32, av32, f.p))
    ms32 = median_ms(lambda: wo.gram_wide(v32, av32, f))
    b32 = wide_gram_bound(N, 32)
    print(f"  gram_wide n=32, p=2^61-1: {ms32:.4f} ms, bound "
          f"{b32[0]:.6f} ms ({b32[1]})", flush=True)
    del v32, av32
    pl = WIDE_PRIMES[-1]
    fl = GFpWide.make(pl)
    for n in (4, 32):
        big = torch.full((FOLD_ROWS, n), pl - 1, dtype=torch.int64,
                         device=dev)
        rec.agree(f"all p-1 N={FOLD_ROWS} n={n}", wo.gram_wide(big, big, fl),
                  wo.gram_wide_plain(big, big, pl))
        del big

    def cases(tag):
        for p in WIDE_PRIMES:
            fe = GFpWide.make(p)
            for n in WIDE_NS:
                v = rand_wide(rng, EDGE_ROWS, n, p, dev)
                av = rand_wide(rng, EDGE_ROWS, n, p, dev)
                rec.agree(f"{tag}p={p} n={n}", wo.gram_wide(v, av, fe),
                          wo.gram_wide_plain(v, av, p))
                full = torch.full((EDGE_ROWS, n), p - 1, dtype=torch.int64,
                                  device=dev)
                rec.agree(f"{tag}all p-1 p={p} n={n}",
                          wo.gram_wide(full, full, fe),
                          wo.gram_wide_plain(full, full, p))
            for n in (1, 4, 64):
                for N in (0, 1):
                    v, av = (rand_wide(rng, N, n, p, dev) for _ in range(2))
                    rec.agree(f"{tag}N={N} p={p} n={n}",
                              wo.gram_wide(v, av, fe),
                              wo.gram_wide_plain(v, av, p))
                z = torch.zeros((EDGE_ROWS, n), dtype=torch.int64,
                                device=dev)
                rec.agree(f"{tag}zero p={p} n={n}", wo.gram_wide(z, z, fe),
                          wo.gram_wide_plain(z, z, p))

    cases("")
    with kernels.variant("gram_wide", **GRAM_WIDE_SMALL_FOLDS):
        cases("small folds ")
        big = torch.full((FOLD_ROWS, 4), pl - 1, dtype=torch.int64,
                         device=dev)
        rec.agree(f"small folds all p-1 N={FOLD_ROWS} n=4",
                  wo.gram_wide(big, big, fl), wo.gram_wide_plain(big, big, pl))


def wide_grams(rng, p, n, kind, device):
    """[U ; UA] (2n, n) int64: U symmetric of full rank ("full"), of rank
    n - 1 or 1 ("deficient"), zero ("zero"), or with rows 0 and 1 zero and
    the rest random ("d!=d1": phase 1 pivots columns 0 and 1 on rows 2 and
    3, phase 2's masked block U[d1, d1] has zero rows there, so d != d1);
    UA symmetric."""
    import torch
    r = lambda *s: rng.integers(0, 1 << 62, size=s).astype(object) % p  # noqa
    if kind == "full":
        L = np.tril(r(n, n), -1) + np.eye(n, dtype=object)
        D = r(n) % (p - 1) + 1                    # in [1, p - 1]
        U = (L * D[None, :]) @ L.T % p            # L D L^T: full rank
    elif kind == "deficient":
        B = r(n, max(n - 1, 1))
        U = B @ B.T % p
    elif kind == "zero":
        U = np.zeros((n, n), object)
    else:
        U = np.zeros((n, n), object)
        U[2:] = r(n - 2, n)
    A = r(n, n)
    UA = (A + A.T) % p
    return torch.from_numpy(np.concatenate([U, UA]).astype(np.int64)
                            ).to(device)


def check_si_wide(rec, rng, dev, wo, ws, real_grams):
    """semi_inverse_wide against semi_inverse_wide_plain: the bench's real
    Grams (n = 4 and 32, timed); at every prime and n of WIDE_NS full-rank,
    rank-deficient and zero Grams, and (n >= 4) one whose phase-2 pivots
    differ from phase 1's (d != d1); a failing check; the check off; a
    frozen state; diag(1, .., 1, y) at n = 1, 4, 8 and 32, whose pivots'
    product is y, for y = 1, p - 1, 2^k (the binary inverse's shortest,
    a long and power-of-two inputs)."""
    import torch
    from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    def case(what, grams, fe, check=True, state=None):
        s_k = new_state(dev) if state is None else state.clone()
        s_p = s_k.clone()
        got = wo.semi_inverse_wide(grams, fe, s_k, check)
        want = wo.semi_inverse_wide_plain(grams, fe.p, s_p, check)
        for a, b in zip(got, want):
            rec.agree(what, a, b)
        rec.agree(what + " state", s_k, s_p)
        return got, s_k

    f = ws.f
    timed = {}
    for n, grams in real_grams.items():
        case(f"bench gram n={n}", grams, f)
        state = new_state(dev)
        timed[n] = (median_ms(lambda: wo.semi_inverse_wide(grams, f, state)),
                    wide_si_bound(f.p, n, grams[:n].cpu().numpy()))
    rec.ms, (rec.bound_ms, rec.bound_by, chain_ms, steps) = timed[4]
    rec.plain_ms = median_ms(
        lambda: wo.semi_inverse_wide_plain(real_grams[4], f.p,
                                           new_state(dev)), reps=3)
    rec.note = ("latency-bound: 2n pivot steps and the inverse's steps run "
                "one after another in one CTA, so neither bytes nor "
                "operations bound it; the chain of 2n >= "
                f"~{WIDE_STEP_CYCLES}-cycle steps and this Gram's {steps} "
                f"inverse steps of {WIDE_INV_STEP_CYCLES} cycles is >= "
                f"{chain_ms:.4f} ms")
    ms32, (b32, by32, chain32, steps32) = timed[32]
    print(f"  semi_inverse_wide n=32, p=2^61-1: {ms32:.4f} ms, bound "
          f"{b32:.6f} ms ({by32}), chain >= {chain32:.4f} ms ({steps32} "
          "inverse steps)", flush=True)
    for p in WIDE_PRIMES:
        fe = GFpWide.make(p)
        for n in WIDE_NS:
            kinds = ["full", "deficient", "zero"] + (["d!=d1"] if n >= 4
                                                     else [])
            for kind in kinds:
                got, s_k = case(f"p={p} n={n} {kind}",
                                wide_grams(rng, p, n, kind, dev), fe)
                if kind == "full":
                    assert int(got.npiv[0]) == n, "expected full rank"
                if kind == "zero":
                    assert int(got.npiv[0]) == 0 and int(s_k[0]) == 1
        grams = wide_grams(rng, p, 8, "d!=d1", dev)
        d1 = wo._eliminate_plain(p, grams[:8].cpu(), None)[2]
        got, _ = case(f"p={p} d!=d1 n=8", grams, fe)
        assert not torch.equal(got.d.cpu().long(), d1), "expected d != d1"
        bad = wide_grams(rng, p, 8, "full", dev)
        bad[8, 1] = (bad[8, 1] + 1) % p          # vtAAv no longer symmetric
        _, s_k = case(f"p={p} failing check", bad, fe)
        assert int(s_k[1]) == 0, "the check should fail"
        _, s_k = case(f"p={p} check off", bad, fe, check=False)
        assert int(s_k[1]) == 1
        frozen = torch.tensor([1, 1, 9, 1], dtype=torch.int32, device=dev)
        _, s_k = case(f"p={p} frozen", bad, fe, state=frozen)
        assert s_k.tolist() == [1, 1, 9, 1]
        for n in (1, 4, 8, 32):
            for y in (1, p - 1, 1 << 29, 1 << (p.bit_length() - 1)):
                g = torch.zeros((2 * n, n), dtype=torch.int64)
                g[:n] = torch.eye(n, dtype=torch.int64)
                g[n - 1, n - 1] = y
                g[n:] = g[:n] * 3 % p
                got, _ = case(f"p={p} n={n} pivots' product {y}", g.to(dev),
                              fe)
                assert int(got.npiv[0]) == n


def check_ortho_wide(rec, rng, dev, LW, wo, ws, blocks):
    """orthogonalize_wide against orthogonalize_wide_plain: the bench's
    rows at n = 4 and 32 with their real right-hand sides (timed), running
    and halted; at every prime and n of ORTHO_NS (both sides of the
    tensor-core threshold) d all 0, all 1 and mixed under running,
    stopped, failed-invariant and frozen states; all residues and rhs
    p - 1 (at n = 64 the limb sums' s32 worst case); N = 1, 15, 16, 17;
    misaligned views."""
    import torch
    from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide

    def case(what, v, pb, av, rhs, d, fe, state, skew=0):
        st_k = torch.tensor(state, dtype=torch.int32, device=dev)
        st_p = st_k.clone()
        vk = skewed(v, skew) if skew else v.clone()
        pk = skewed(pb, skew) if skew else pb.clone()
        avk = skewed(av, skew) if skew else av
        vp, pp = v.clone(), pb.clone()
        LW.orthogonalize_wide(vk, pk, avk, rhs, d, fe, st_k)
        LW.orthogonalize_wide_plain(vp, pp, av, rhs, d, fe.p, st_p)
        rec.agree(what + " v", vk, vp)
        rec.agree(what + " p", pk, pp)
        rec.agree(what + " state", st_k, st_p)
        if state[0] or not state[1]:
            rec.agree(what + " frozen v", vk, v)

    f = ws.f
    timed = {}
    for n, (v, av, si) in blocks.items():
        pb = rand_wide(rng, v.shape[0], n, f.p, dev)
        for state in ([0, 1, 0, 0], [1, 1, 0, 0]):
            case(f"bench n={n} state={state}", v, pb, av, si.rhs, si.d, f,
                 state)
        st = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
        vk, pk = v.clone(), pb.clone()
        timed[n] = median_ms(
            lambda: LW.orthogonalize_wide(vk, pk, av, si.rhs, si.d, f, st))
        if n == 4:
            rec.plain_ms = median_ms(
                lambda: LW.orthogonalize_wide_plain(
                    vk, pk, av, si.rhs, si.d, f.p, st.clone()), reps=3)
        del vk, pk
    N = blocks[4][0].shape[0]
    rec.ms = timed[4]
    rec.bound_ms, rec.bound_by = wide_ortho_bound(N, 4)
    b32 = wide_ortho_bound(N, 32)
    print(f"  orthogonalize_wide n=32, p=2^61-1: {timed[32]:.4f} ms, bound "
          f"{b32[0]:.6f} ms ({b32[1]})", flush=True)

    def rhs_block(n, p, value=None):
        rhs = torch.zeros((2 * n, 2 * n), dtype=torch.int64, device=dev)
        if value is None:
            rhs[:n] = rand_wide(rng, n, 2 * n, p, dev)
            rhs[n:, :n] = rand_wide(rng, n, n, p, dev)
        else:
            rhs[:n] = value
            rhs[n:, :n] = value
        return rhs

    def d_of(kind, n):
        d = {"0": np.zeros(n), "1": np.ones(n),
             "mixed": rng.integers(0, 2, n)}[kind]
        if kind == "mixed" and n > 1:
            d[:2] = (0, 1)
        return torch.from_numpy(d.astype(np.int32)).to(dev)

    states = ([0, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 5, 1])
    for p in WIDE_PRIMES:
        fe = GFpWide.make(p)
        for n in ORTHO_NS:
            vv, pp, aa = (rand_wide(rng, EDGE_ROWS, n, p, dev)
                          for _ in range(3))
            rhs = rhs_block(n, p)
            for kind in ("0", "1", "mixed"):
                for state in (states if kind == "mixed" else states[:1]):
                    case(f"p={p} n={n} d={kind} state={state}", vv, pp, aa,
                         rhs, d_of(kind, n), fe, state)
            full = torch.full((EDGE_ROWS, n), p - 1, dtype=torch.int64,
                              device=dev)
            case(f"all p-1 p={p} n={n}", full, full, full,
                 rhs_block(n, p, p - 1), d_of("mixed", n), fe, states[0])
            for N in (1, 15, 16, 17):
                few = [rand_wide(rng, N, n, p, dev) for _ in range(3)]
                case(f"N={N} p={p} n={n}", *few, rhs_block(n, p),
                     d_of("mixed", n), fe, states[0])
            case(f"misaligned p={p} n={n}", vv, pp, aa, rhs,
                 d_of("mixed", n), fe, states[0], skew=1)


def xoshiro_host_block(gen, field, p, rows, n, pad):
    """The solvers' NumPy v0 (their CPU branch of initial_block): the
    draw, zero padding rows, GF(2) bits packed."""
    import torch
    from block_lanczos_tpu_torch.ops import gf2
    if field == "gf2":
        block = np.zeros((rows + pad, n), np.uint32)
        block[:rows] = gen.fill_mod(rows * n, 2).reshape(rows, n)
        return torch.from_numpy(gf2.pack_bits_np(block).view(np.int32))
    dtype = np.int64 if field == "wide" else np.int32
    block = np.zeros((rows + pad, n), dtype)
    block[:rows] = (gen.fill_mod64 if field == "wide" else gen.fill_mod)(
        rows * n, p).reshape(rows, n)
    return torch.from_numpy(block)


def check_xoshiro_fill(rec, dev):
    """xoshiro_fill (v0 drawn on the card, ops/xoshiro.py::LaneDraw) against
    the host draw, bit for bit, at XOSHIRO_SHAPES with 3 padding rows: two
    draws in a row from one generator, the host-advanced state equal to the
    NumPy draw's after each; timed at each shape (event ms of a whole
    block() call, zeroed block and state advance included; device ms a
    launch of the kernel alone, back to back; the host draw's seconds)."""
    import torch
    from block_lanczos_tpu_torch.ops import xoshiro
    from block_lanczos_tpu_torch.utils import rng as xr
    pad = 3
    for field, p, rows, n in XOSHIRO_SHAPES:
        count = rows * n
        shape = (rows + pad, n // 32 if field == "gf2" else n)
        d = xoshiro.LaneDraw(count, dev)
        card, host = xr.Xoshiro256Plus(), xr.Xoshiro256Plus()
        plain = []
        for k in range(2):
            got = d.block(card, field, p, shape)
            t0 = time.perf_counter()
            want = xoshiro_host_block(host, field, p, rows, n, pad)
            plain.append(time.perf_counter() - t0)
            rec.agree(f"{field} p={p} {rows} x {n}, draw {k}", got,
                      want.to(dev))
            if card.state != host.state:
                raise AssertionError(f"xoshiro_fill {field} {rows} x {n}: "
                                     "the host-advanced state differs")
        ev = median_ms(lambda: d.block(card, field, p, shape))
        out = torch.zeros(shape, device=dev, dtype=torch.int64
                          if field == "wide" else torch.int32)
        args = d.args(xr.DEFAULT_SEED, field, p)
        dms = per_launch_ms(lambda: xoshiro.xoshiro_fill(d.jumps_dev, args,
                                                         out))
        nbytes = out.numel() * out.element_size()
        b_ms, b_by = bound(nbytes, count * XOSHIRO_OPS_PER_DRAW)
        print(f"  xoshiro_fill {field} p={p} {rows} x {n}: {d.lanes} lanes "
              f"of {d.m}, {d.levels} jumps; event {ev:.4f} ms, device "
              f"{dms:.4f} ms a launch, bound {b_ms:.4f} ms ({b_by}); host "
              f"draw {min(plain):.4f} s", flush=True)
        if (field, rows, n) == ("gf2", 500_000, 128):    # the table's row
            rec.ms, rec.plain_ms = ev, min(plain) * 1e3
            rec.bound_ms, rec.bound_by = b_ms, b_by
            rec.extra["device_ms"] = dms
    rec.note = ("ms, plain_ms, bound_ms at the GF(2) cell's v0, 500,000 x "
                "128; plain_ms is the host draw, pack included")


# final_unpack's shapes (n, rows, n_eff, m_eff): small ones at three widths,
# tmp absent or all padding (m_eff 0), and the GF(2) cell's 500,000 x 128
FINAL_SHAPES = ((32, 8, 1, 1), (32, 4104, 4099, 3001), (128, 136, 129, 130),
                (512, 4104, 4099, 3001), (128, 500_000, 499_992, 0),
                (128, 500_000, 500_000, 499_000))


def check_final_unpack(rec, rng, dev):
    """final_unpack (GF(2)'s final step on the card, ops/gf2.py) against
    its NumPy mirror, bit for bit, at FINAL_SHAPES with random words in
    every row, padding included: with tmp and without it, and on tmp alone
    (the failed check's vtM); timed at the GF(2) cell's 500,000 x 128 (event
    ms of the launch, device ms back to back, the bytes bound) beside the
    host path it replaces (download, unpack_bits_np, final_check)."""
    import torch
    from block_lanczos_tpu_torch.models.lanczos import final_check
    from block_lanczos_tpu_torch.ops import gf2
    for n, rows, n_eff, m_eff in FINAL_SHAPES:
        W = n // 32
        v, tmp = (rng.integers(0, 1 << 32, size=(rows, W), dtype=np.uint64)
                  .astype(np.uint32).view(np.int32) for _ in range(2))
        vd, td = torch.from_numpy(v).to(dev), torch.from_numpy(tmp).to(dev)
        out = torch.empty((rows, n), dtype=torch.int32, device=dev)
        flags = torch.empty(2, dtype=torch.int32, device=dev)
        for t, td_ in ((tmp, td), (None, None)):
            bits, want_flags = gf2.final_unpack_np(v, t, n_eff, m_eff, n)
            gf2.final_unpack(vd, td_, n_eff, m_eff, n, out, flags)
            rec.agree(f"n={n} {rows} rows, n_eff {n_eff}, m_eff {m_eff}"
                      f"{'' if t is not None else ', no tmp'}",
                      out[:n_eff], torch.from_numpy(bits.view(np.int32))
                      .to(dev))
            rec.agree(f"flags n={n} {rows} rows", flags,
                      torch.from_numpy(want_flags).to(dev))
        bits, want_flags = gf2.final_unpack_np(tmp, None, m_eff, 0, n)
        gf2.final_unpack(td, None, m_eff, 0, n, out, flags)
        rec.agree(f"vtM n={n} {rows} rows, m_eff {m_eff}", out[:m_eff],
                  torch.from_numpy(bits.view(np.int32)).to(dev))
        if (n, rows, m_eff) != (128, 500_000, 499_000):
            continue
        ev = median_ms(lambda: gf2.final_unpack(vd, td, n_eff, m_eff, n,
                                                out, flags))
        dms = per_launch_ms(lambda: gf2.final_unpack(vd, td, n_eff, m_eff, n,
                                                     out, flags))
        t0 = time.perf_counter()
        kernel = out[:n_eff].cpu()
        down_s = time.perf_counter() - t0
        plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            vb = gf2.unpack_bits_np(vd.cpu().numpy(), n)
            tb = gf2.unpack_bits_np(td.cpu().numpy(), n)
            final_check(vb, tb, n_eff, m_eff, verbose=False)
            plain.append(time.perf_counter() - t0)
        assert np.array_equal(kernel.numpy().view(np.uint32), vb[:n_eff])
        nbytes = (n_eff + m_eff) * W * 4 + n_eff * n * 4
        rec.set_bound(nbytes, 0)
        rec.ms, rec.plain_ms = ev, min(plain) * 1e3
        rec.extra["device_ms"] = dms
        rec.extra["download_ms"] = down_s * 1e3
        print(f"  final_unpack n={n} {n_eff} x {n} (tmp {m_eff} rows): event "
              f"{ev:.4f} ms, device {dms:.4f} ms a launch, bound "
              f"{rec.bound_ms:.4f} ms ({rec.bound_by}); the block's download "
              f"{down_s * 1e3:.1f} ms; host path (download, unpack, check) "
              f"{min(plain):.4f} s", flush=True)
    rec.note = ("ms, plain_ms, bound_ms at the GF(2) cell's 500,000 x 128; "
                "plain_ms is the host path it replaces")


def check_wide_kernels(recs, rng, dev, ws):
    """Phase 2 of the wide kernels, on the bench operators of the wide
    solver `ws` (2^61 - 1, n = 4): every kernel against its plain version
    at 2^30 + 3, 2^61 - 1 and 4611686018427387847, every n of WIDE_NS, then
    the timing lines."""
    from block_lanczos_tpu_torch.models import lanczos_wide as LW
    from block_lanczos_tpu_torch.ops import wide_ops as wo
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    f = ws.f
    check_spmv_wide(recs["spmv_wide"], rng, dev, wo, ws)
    # the bench's blocks at n = 4 and 32: v, Av = M^T M v, their Grams
    blocks, grams = {}, {}
    for n in (4, 32):
        v = rand_wide(rng, ws.np_rows, n, f.p, dev)
        tmp = wo.spmv_wide(f, ws.first_op, v, ws.mp_rows)
        av = wo.spmv_wide(f, ws.second_op, tmp, ws.np_rows)
        grams[n] = wo.gram_wide(v, av, f)
        blocks[n] = (v, av)
    check_gram_wide(recs["gram_wide"], rng, dev, wo, ws)
    check_si_wide(recs["semi_inverse_wide"], rng, dev, wo, ws, grams)
    for n, (v, av) in blocks.items():
        blocks[n] = (v, av, wo.semi_inverse_wide(grams[n], f, new_state(dev)))
    check_ortho_wide(recs["orthogonalize_wide"], rng, dev, LW, wo, ws,
                     blocks)
    for name in ("spmv_wide", "gram_wide", "semi_inverse_wide",
                 "orthogonalize_wide"):
        r = recs[name]
        print(f"  {name} n=4, p=2^61-1: {r.ms:.4f} ms, plain "
              f"{r.plain_ms:.4f} ms, bound {r.bound_ms:.6f} ms "
              f"({r.bound_by}), library_ms: none; {r.cases} cases equal"
              + (f"; {r.note}" if r.note else ""), flush=True)


# ---------------------------------------------------------------------------
# The mesh's collectives (csrc/collectives.cu) and the mesh itself
# ---------------------------------------------------------------------------

# axis sizes whose sums phase 12 feeds to the folds: every payload switch
# (K1 int32 -> int64, K2 whole -> halves, K3's lane widths 2 / 4 / 8 / 16)
# on both sides
COLL_RANKS = (1, 2, 3, 4, 15, 16, 255)
COLL_NARROW_PRIMES = (2, 3, 65537, 1073741789, (1 << 30) - 35)
COLL_WIDE_PRIMES = WIDE_PRIMES
MESH_ITERS = 200           # phase 14's iterations of each field
# phase 14's grids of 4 ranks: (2, 2) splits both axes; (4, 1) sums over
# an axis of 4, where K1 sends int64, K2 two 31-bit halves and K3 4-bit lanes
MESH_GRIDS = ((2, 2), (4, 1))
MESH_RANKS = 4
RESUME_ITERS = 100         # phase 15: the 2 x 2 grid's run from phase 13's
# checkpoint, held against one device's from the same file
# each field's kernels on the mesh: its SpMV (two an iteration), the
# three others (one each) and its collective (three)
MESH_KERNELS = {
    "narrow": ("spmv_ell", "gram_mod", "semi_inverse", "orthogonalize",
               "psum_mod"),
    "gf2": ("spmv_gf2", "gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2",
            "pxor"),
    "wide": ("spmv_wide", "gram_wide", "semi_inverse_wide",
             "orthogonalize_wide", "psum_mod_wide")}


def check_collectives(recs, dev, shapes, wshapes, gshapes):
    """K1-K3, through the solvers' bound forms (PsumMod, PsumModWide,
    Pxor) on aligned tensors and misaligned views, against their plain
    versions: the folds fed sums of R ranks' partials made here on the card
    (R in COLL_RANKS), random and at the extremes (every partial p - 1,
    every word all ones), the packs on partials with p - 1 and bit 31 set,
    at the mesh's shapes (`shapes`: tmp, Av and the Grams of the 1 x 1
    mesh's bench solve; wide and GF(2) likewise), an edge shape and empty
    tensors; the folds also against the exact sums (Python ints on a
    sample for K2, the XOR of the ranks' words for K3, whose planes'
    padding must stay zeros); each bound form refuses a tensor other than
    its own.  Then each is timed at the 1-rank
    payload of phase 13 (CUDA events, median), with its bound (bytes at
    the HBM rate) and, for K1 and K2, torch.remainder as the library
    yardstick (at the 1-rank payload each fold is x mod p)."""
    import torch
    from block_lanczos_tpu_torch.ops.gfp_wide import GFpWide
    from block_lanczos_tpu_torch.parallel import collectives as C
    tg = torch.Generator(device=dev)
    tg.manual_seed(12)

    def rint(shape, low, high):          # [low, high], int64
        return torch.randint(low, high + 1, shape, generator=tg,
                             device=dev, dtype=torch.int64)

    edge = [(0, 4), (EDGE_ROWS, 3), (1, 1)]

    def bound_on(make, x, skew):
        """x (a misaligned copy when skew) and the bound form on it."""
        x = skewed(x) if skew else x
        return x, make(x)

    # K1: narrow residues
    rec = recs["psum_mod"]
    for p in COLL_NARROW_PRIMES:
        for R in COLL_RANKS:
            dtype = C.mod_payload_dtype(R, p)
            for shape in list(shapes) + edge:
                top = R * (p - 1)
                S = rint(shape, 0, top)
                S.view(-1)[:7] = top          # every partial p - 1
                S.view(-1)[7:9] = 0
                sums = S.to(dtype)
                xp = torch.empty(shape, dtype=torch.int32, device=dev)
                C.fold_mod_plain(sums, xp, p)
                for skew in (0, 1):
                    # the solvers' bound form: its pack of x, then its
                    # fold of the sums S written into its payload
                    x = rint(shape, 0, p - 1).to(torch.int32)
                    x.view(-1)[:5] = p - 1
                    x, b = bound_on(lambda t: C.PsumMod(t, p, ranks=R), x,
                                    skew)
                    what = f"p={p} R={R} {shape} misaligned={skew}"
                    rec.agree("pack " + what, b.pack(x),
                              C.pack_mod_plain(x, R, p))
                    b.payload.copy_(sums)
                    b.fold(b.payload, x)
                    rec.agree("fold " + what, x, xp)
                    rec.agree("fold " + what + " vs S % p", x,
                              (S % p).to(torch.int32))
                    refuses_others(b, x)
    print(f"  psum_mod: {rec.cases} cases equal", flush=True)

    # K2: wide residues
    rec = recs["psum_mod_wide"]
    m31 = (1 << 31) - 1
    for p in COLL_WIDE_PRIMES:
        f = GFpWide.make(p)
        for R in COLL_RANKS:
            for shape in list(wshapes) + edge:
                if C.wide_halves(R):
                    lo = rint(shape, 0, R * m31)
                    hi = rint(shape, 0, R * ((p - 1) >> 31))
                    lo.view(-1)[:7] = R * ((p - 1) & m31)
                    hi.view(-1)[:7] = R * ((p - 1) >> 31)
                    sums = torch.stack([lo, hi])
                else:
                    sums = rint(shape, 0, R * (p - 1))
                    sums.view(-1)[:7] = R * (p - 1)
                xp = torch.empty(shape, dtype=torch.int64, device=dev)
                C.fold_wide_plain(sums, xp, p)
                # the exact sums on a sample, in Python ints
                k = min(64, xp.numel())
                if C.wide_halves(R):
                    lo_h = zip(sums[0].view(-1)[:k].tolist(),
                               sums[1].view(-1)[:k].tolist())
                    want = [((h << 31) + lo_) % p for lo_, h in lo_h]
                else:
                    want = [s_ % p for s_ in sums.view(-1)[:k].tolist()]
                for skew in (0, 1):
                    x = rint(shape, 0, p - 1)
                    x.view(-1)[:5] = p - 1
                    x, b = bound_on(lambda t: C.PsumModWide(t, f, ranks=R),
                                    x, skew)
                    what = f"p={p} R={R} {shape} misaligned={skew}"
                    rec.agree("pack " + what, b.pack(x),
                              C.pack_wide_plain(x, R))
                    b.payload.copy_(sums)
                    b.fold(b.payload, x)
                    rec.agree("fold " + what, x, xp)
                    if x.view(-1)[:k].tolist() != want:
                        raise AssertionError(f"psum_mod_wide fold {what}: "
                                             "not the exact sum")
                    refuses_others(b, x)
    print(f"  psum_mod_wide: {rec.cases} cases equal", flush=True)

    # K3: XOR of words, its (L, plane_stride(n)) planes summed here (the
    # edge shapes' n % 4 != 0: padded planes, a scalar tail), each rank's
    # spread by a bound form (rank 1's on a misaligned view)
    rec = recs["pxor"]
    for R in COLL_RANKS:
        lanes = C.pxor_lanes(R)
        for shape in list(gshapes) + edge:
            n = shape[0] * shape[1]
            S = torch.zeros((lanes, C.plane_stride(n)), dtype=torch.int64,
                            device=dev)
            X = torch.zeros(shape, dtype=torch.int32, device=dev)
            spreads = [bound_on(lambda t: C.Pxor(t, ranks=R),
                                torch.empty(shape, dtype=torch.int32,
                                            device=dev), skew)
                       for skew in (0, 1)]
            for r in range(R):
                w = rint(shape, -(1 << 31), (1 << 31) - 1).to(torch.int32)
                w.view(-1)[:7] = -1                   # every bit set
                w.view(-1)[7:9] = -(1 << 31)          # bit 31 alone
                x, b = spreads[r == 1]
                x.copy_(w)
                sk = b.pack(x)
                if r < 2:
                    rec.agree(f"spread R={R} {shape} rank {r} "
                              f"misaligned={r}", sk, C.spread_xor_plain(w, R))
                S += sk
                X ^= w
            if S[:, n:].any():
                raise AssertionError(f"pxor wrote a plane's padding at "
                                     f"R={R} {shape}")
            if S.numel() and not (-(1 << 31) <= int(S.min())
                                  and int(S.max()) < 1 << 31):
                raise AssertionError(f"pxor lane sums leave int32 at R={R}")
            sums = S.to(torch.int32)
            xp = torch.empty(shape, dtype=torch.int32, device=dev)
            C.fold_xor_plain(sums, xp)
            for skew in (0, 1):
                x, b = bound_on(lambda t: C.Pxor(t, ranks=R),
                                torch.empty(shape, dtype=torch.int32,
                                            device=dev), skew)
                b.payload.copy_(sums)
                b.fold(b.payload, x)
                what = f"fold R={R} {shape} misaligned={skew}"
                rec.agree(what, x, xp)
                rec.agree(what + " vs XOR", x, X)
                refuses_others(b, x)
    print(f"  pxor: {rec.cases} cases equal", flush=True)

    # times at phase 13's 1-rank payloads, the mean over a call's shapes:
    # the exact path a sharded solver's step runs around the transport (the
    # bound form's pack and fold; at one rank K1's and K2's packs launch
    # nothing, K3's spread writes L = 2 planes)
    pb = COLL_NARROW_PRIMES[3]                 # the bench prime
    fw = GFpWide.make(COLL_WIDE_PRIMES[1])     # 2^61 - 1
    rows = []
    for name, shp, dtype, top, nbytes_el in (
            ("psum_mod", shapes, torch.int32, pb - 1, 8),
            ("psum_mod_wide", wshapes, torch.int64, fw.p - 1, 16),
            # 4 B read, 2 planes of 4 B written and read, 4 B written
            ("pxor", gshapes, torch.int32, None, 24)):
        ms, per, plain, lib, nbytes = [], [], [], [], []
        for shape in shp:
            x = (rint(shape, -(1 << 31), (1 << 31) - 1) if top is None
                 else rint(shape, 0, top)).to(dtype)
            call = one_rank_call(C, name, x, pb, fw)
            ms.append(median_ms(call))
            per.append(per_launch_ms(call))
            plain.append(median_ms(
                one_rank_call(C, name, x, pb, fw, plain=True), reps=5))
            if name != "pxor":
                pl = pb if name == "psum_mod" else fw.p
                lib.append(median_ms(lambda: torch.remainder(x, pl, out=x)))
            nbytes.append(nbytes_el * x.numel())
        rec = recs[name]
        rec.ms, rec.plain_ms = statistics.mean(ms), statistics.mean(plain)
        rec.library_ms = statistics.mean(lib) if lib else None
        rec.extra["per_launch_ms"] = statistics.mean(per)
        rec.set_bound(statistics.mean(nbytes), 0)
        rows.append(f"{name} {rec.ms:.4f} ms, back to back "
                    f"{rec.extra['per_launch_ms']:.4f} (plain "
                    f"{rec.plain_ms:.4f}, bound {rec.bound_ms:.6f} "
                    f"{rec.bound_by}"
                    + (f", torch.remainder {rec.library_ms:.4f}" if lib
                       else "") + ")")
    print("  the 1-rank payloads, a call (mean over its shapes): "
          + "; ".join(rows), flush=True)
    # the 4-rank payloads (phase 14's axis of 4): K1 widened to int64 (a
    # pack of 4 B read and 8 B written, a fold of 8 B read and 4 B
    # written), K2 in 31-bit halves (8 B read and 16 B written, then 16 B
    # read and 8 B written), K3 in 4 planes of 4-bit lanes (4 B read and 16
    # B written, then 16 B read and 4 B written); pack and fold back to
    # back, no transport
    rows = []
    for name, shp, make, top, nbytes_el in (
            ("psum_mod", shapes, lambda x: C.PsumMod(x, pb, ranks=4),
             pb - 1, 24),
            ("psum_mod_wide", wshapes,
             lambda x: C.PsumModWide(x, fw, ranks=4), fw.p - 1, 48),
            ("pxor", gshapes, lambda x: C.Pxor(x, ranks=4), None, 40)):
        ms, per, nbytes = [], [], []
        for shape in shp:
            x = (rint(shape, -(1 << 31), (1 << 31) - 1) if top is None
                 else rint(shape, 0, top)).to(
                     torch.int64 if name == "psum_mod_wide" else torch.int32)
            b = make(x)
            assert b.payload is not x        # the pack runs
            ms.append(median_ms(lambda: b.fold(b.pack(x), x)))
            per.append(per_launch_ms(lambda: b.fold(b.pack(x), x)))
            nbytes.append(nbytes_el * x.numel())
        rec = recs[name]
        bound_ms, bound_by = bound(statistics.mean(nbytes), 0)
        rec.extra.update(r4_ms=statistics.mean(ms),
                         r4_per_launch_ms=statistics.mean(per),
                         r4_bound_ms=bound_ms)
        rows.append(f"{name} {rec.extra['r4_ms']:.4f} ms, back to back "
                    f"{rec.extra['r4_per_launch_ms']:.4f} (bound "
                    f"{bound_ms:.6f} {bound_by})")
    print("  the 4-rank payloads, pack + fold (mean over its shapes): "
          + "; ".join(rows), flush=True)


def one_rank_call(C, name, x, p, f, plain=False):
    """A function running what a call of collective `name` runs around the
    transport on a 1-rank group (phase 13's payloads; the sum of a 1-rank
    payload is the payload): the bound form's pack and fold (PsumMod,
    PsumModWide, Pxor), as the sharded solvers' step calls them, or the
    plain versions of the two."""
    if plain:
        return {"psum_mod": lambda: C.fold_mod_plain(
                    C.pack_mod_plain(x, 1, p), x, p),
                "psum_mod_wide": lambda: C.fold_wide_plain(
                    C.pack_wide_plain(x, 1), x, f.p),
                "pxor": lambda: C.fold_xor_plain(
                    C.spread_xor_plain(x, 1), x)}[name]
    b = {"psum_mod": lambda: C.PsumMod(x, p, ranks=1),
         "psum_mod_wide": lambda: C.PsumModWide(x, f, ranks=1),
         "pxor": lambda: C.Pxor(x, ranks=1)}[name]()
    return lambda: b.fold(b.pack(x), x)


def refuses_others(b, x):
    """A bound form on the card (its launches prepared for x and its
    payload) raises on any other tensor, launching nothing."""
    other = x.clone()
    for what, call in (("x", lambda: b.pack(other)),
                       ("x", lambda: b.fold(b.payload, other)),
                       ("sums", lambda: b.fold(b.payload.clone(), x))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"{b.name}'s bound form took another {what} "
                             "than its own")


def _mesh_rank(rank, world, device, coo, primes, n_by_field, iters,
               ckpt_a, ckpt_b):
    """Phase 14's rank: the three fields' sharded solvers on each grid of
    MESH_GRIDS over gloo, `iters` iterations each; returns (v, p) of each
    (by (grid, field)) in true row order, the iterations, and the launch
    counts of this rank; then phase 16's: the same on the 2 x 2 grid with
    overlap=True, ("overlap", field), and their own launch counts.  Phase
    15's mesh checkpoints: the 2 x 2 wide solve
    saves at its first block boundary past iters / 2 into `ckpt_b` (only
    the root requests it; every rank's manager must save); afterwards the
    2 x 2 narrow solver resumes phase 13's checkpoint `ckpt_a` for
    RESUME_ITERS iterations and the 4 x 1 wide solver resumes `ckpt_b` to
    `iters`, each recording (v, p) at its end ("resume", grid, field)."""
    from block_lanczos_tpu_torch import convert
    from block_lanczos_tpu_torch.parallel import distributed as D
    from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
        ShardedBlockLanczosGF2
    from block_lanczos_tpu_torch.parallel.distributed_wide import \
        ShardedBlockLanczosWide
    from block_lanczos_tpu_torch.parallel.mesh import make_grid
    from block_lanczos_tpu_torch.utils import mmio
    nrows, ncols, i, j, x = coo
    grids = [make_grid(*g, device) for g in MESH_GRIDS]
    out = {}
    D.reset_launch_counts()
    for g, grid in zip(MESH_GRIDS, grids):
        for field, cls, dtype in (
                ("narrow", D.ShardedBlockLanczos, np.uint32),
                ("gf2", ShardedBlockLanczosGF2, np.uint32),
                ("wide", ShardedBlockLanczosWide, np.uint64)):
            M = mmio.COOMatrix(nrows, ncols, len(i), i, j, x.astype(dtype),
                               primes[field])
            solver = cls(M, n=n_by_field[field], grid=grid)
            last, saved = {}, {}
            mgr = None
            if (g, field) == ((2, 2), "wide"):
                from block_lanczos_tpu_torch.utils import checkpoint as ckpt
                mgr = ckpt.CheckpointManager(
                    ckpt_b, interval_s=3600.0, meta={"field": field},
                    solver=solver)

            def grab(slv, iteration, v, p_blk, start):
                if mgr is not None and not saved and iteration >= iters // 2:
                    if grid.is_root:
                        mgr.request_save()
                    t0 = time.time()
                    if not mgr.maybe_save(iteration, v, p_blk, start):
                        raise AssertionError(f"rank {rank}: the root's save "
                                             "request was not followed")
                    saved.update(iteration=iteration, s=time.time() - t0)
                last["vp"] = (slv.gather_rows(v), slv.gather_rows(p_blk),
                              iteration)
            t0 = time.time()
            res = solver.solve(stop_after=iters, on_iteration=grab)
            out[g, field] = last["vp"] + (res.iterations, time.time() - t0)
            if saved:
                out["saved", g, field] = saved
            resume = {((2, 2), "narrow"): (ckpt_a, None),
                      ((4, 1), "wide"): (ckpt_b, iters)}.get((g, field))
            if resume is not None:
                from block_lanczos_tpu_torch.utils import checkpoint as ckpt
                state = ckpt.load_checkpoint(resume[0])
                stop = resume[1] or int(state["iteration"]) + RESUME_ITERS
                last.clear()
                solver.solve(stop_after=stop, on_iteration=grab,
                             resume_state=convert.FROM_NUMPY[field](
                                 state, "cpu"))
                out["resume", g, field] = last["vp"]
            del solver
    out["counts"] = D.launch_counts()
    # phase 16: the overlap step on the 2 x 2 grid, `iters` iterations of
    # each field, its own launch counts
    D.reset_launch_counts()
    for field, cls, dtype in (
            ("narrow", D.ShardedBlockLanczos, np.uint32),
            ("gf2", ShardedBlockLanczosGF2, np.uint32),
            ("wide", ShardedBlockLanczosWide, np.uint64)):
        M = mmio.COOMatrix(nrows, ncols, len(i), i, j, x.astype(dtype),
                           primes[field])
        solver = cls(M, n=n_by_field[field],
                     grid=grids[MESH_GRIDS.index((2, 2))], overlap=True)
        last = {}

        def grab_last(slv, iteration, v, p_blk, start):
            last["vp"] = (slv.gather_rows(v), slv.gather_rows(p_blk),
                          iteration)
        t0 = time.time()
        res = solver.solve(stop_after=iters, on_iteration=grab_last)
        out["overlap", field] = last["vp"] + (res.iterations,
                                              time.time() - t0)
        del solver
    out["overlap_counts"] = D.launch_counts()
    return out if rank == 0 else None



def mesh_solves(recs, dev, backend, cases, shapes, mtx, card, saves):
    """Phase 13: each (field, M, n, one-device result, prime) of `cases`
    solved whole by the field's sharded solver on a 1 x 1 grid of this
    process over `backend`; the kernel must equal the one-device solve's
    and pass the checker (on the file mtx[field]), and the launch counts
    (reset just before, read just after) show each of the field's kernels
    and its collective three times an iteration.  The transport's all_reduce of each collective's
    1-rank payload (`shapes`) is timed on its own.  The narrow solve saves
    a checkpoint at its middle (`mid_save`, saves["mesh-1x1-n4"]: phase
    15's).  Returns the collectives' launch counts and, by field, the
    solve's ms/iter (the save taken out) and launches an iteration of its
    SpMV and its collective."""
    import torch
    import torch.distributed as tdist
    from block_lanczos_tpu_torch.parallel import distributed as D
    from block_lanczos_tpu_torch.parallel import multihost
    from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
        ShardedBlockLanczosGF2
    from block_lanczos_tpu_torch.parallel.distributed_wide import \
        ShardedBlockLanczosWide
    from block_lanczos_tpu_torch.parallel.mesh import make_grid
    from block_lanczos_tpu_torch.utils import checker, mmio, salvage
    solvers = {"narrow": D.ShardedBlockLanczos,
               "gf2": ShardedBlockLanczosGF2, "wide": ShardedBlockLanczosWide}
    rdv = os.path.join(WORK, "mesh_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    multihost.init_distributed("file://" + rdv, 1, 0, backend, 300, dev)
    grid = make_grid(1, 1, dev)
    # the transport alone, for the record (not in the kernels' ms)
    for name, dtype, planes in (("psum_mod", torch.int32, ()),
                                ("psum_mod_wide", torch.int64, ()),
                                ("pxor", torch.int32, (2,))):
        t_ar = statistics.mean(
            median_ms(lambda: tdist.all_reduce(t, group=grid.rows_group))
            for t in (torch.zeros(planes + tuple(sh), dtype=dtype,
                                  device=dev) for sh in shapes[name]))
        recs[name].note = (f"1-rank {backend} all_reduce of the payload: "
                           f"{t_ar:.4f} ms a call (not in ms)")
        print(f"  {name}: {recs[name].note}", flush=True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh_counts, per_field = {}, {}
    try:
        for field, Mx, n, want, fp in cases:
            t0 = time.time()
            msolver = solvers[field](Mx, n=n, grid=grid)
            t1 = time.time()
            on_iteration = None
            if field == "narrow":
                on_iteration = mid_save(
                    msolver, os.path.join(WORK, "ckpt_mesh_narrow"),
                    ckpt_meta(msolver, Mx, mtx[field]), saves, "mesh-1x1-n4")
            D.reset_launch_counts()
            sync()
            mres = msolver.solve(verbose=True, on_iteration=on_iteration)
            sync()
            mc = D.launch_counts()
            it = mres.iterations
            save_s = (saves["mesh-1x1-n4"]["save_s"] if field == "narrow"
                      else 0.0)
            print(f"  {field}: layout {t1 - t0:.1f} s; {it} iterations, loop "
                  f"{mres.elapsed:.3f} s (a checkpoint save {save_s:.3f} s "
                  "of it), "
                  f"{(mres.elapsed - save_s) / max(it, 1) * 1e3:.4f} ms/iter "
                  "without it, against "
                  "the one-device solve's "
                  f"{want.elapsed / max(want.iterations, 1) * 1e3:.4f} "
                  f"[{card}]", flush=True)
            print(f"  launches during the solve: {mc}", flush=True)
            if it != want.iterations or not np.array_equal(mres.kernel,
                                                           want.kernel):
                raise AssertionError(f"{field}: the 1 x 1 mesh's kernel "
                                     "differs from the one-device solve's")
            assert (mres.v_nonzero, mres.product_zero) == \
                (want.v_nonzero, want.product_zero), field
            kernel = mres.kernel
            if not mres.product_zero:
                kernel = salvage.salvage_kernel(mres.kernel, mres.vtM, fp)
                assert kernel.shape[1] >= 1, "salvage recovered no vector"
            kpath = os.path.join(WORK, f"mesh_{field}.kernel.mtx")
            mmio.write_kernel_mtx(kpath, kernel, msolver.n_eff,
                                  kernel.shape[1])
            checker.check_kernel_file(mtx[field], kpath, fp, verbose=True)
            spmv, *rest, coll = MESH_KERNELS[field]
            assert mc[spmv] >= 2 * it, mc
            for name in rest:
                assert mc[name] >= it, mc
            assert mc[coll] >= 3 * it, mc
            mesh_counts[coll] = mc[coll]
            per_field[field] = {
                "ms_iter": (mres.elapsed - save_s) / max(it, 1) * 1e3,
                "spmv_iter": mc[spmv] / max(it, 1),
                "coll_iter": mc[coll] / max(it, 1)}
    finally:
        tdist.destroy_process_group()
    return mesh_counts, per_field


def mesh_grid_run(device, M, primes, refs, n_by_field, iters, ckpt_a,
                  ckpt_b):
    """Phase 14: the three fields' sharded solvers on each of MESH_GRIDS,
    over MESH_RANKS ranks spawned over gloo, all on `device`, `iters`
    iterations each (the matrix M's entries, at each field's prime); each
    field's v and p must equal those of refs[field]() (a one-device
    solver) after as many, on every grid.  Returns the ranks' results
    (with phase 15's mesh checkpoints: `_mesh_rank`) and each reference's
    (v, p) after `iters`, by field."""
    from block_lanczos_tpu_torch.parallel import launch
    t0 = time.time()
    out = launch.spawn(
        _mesh_rank, [device] * MESH_RANKS,
        args=((M.nrows, M.ncols, M.i, M.j, M.x), primes, n_by_field, iters,
              ckpt_a, ckpt_b),
        backend="gloo", timeout_s=300, wall_s=900)[0]
    print(f"  {MESH_RANKS} ranks spawned, built and run in "
          f"{time.time() - t0:.1f} s; "
          f"rank 0's launches: {out['counts']}", flush=True)
    ref_vp = {}
    for field, make in refs.items():
        ref = make()
        got = {}

        def grab(slv, iteration, v, p_blk, start):
            got["vp"] = (v.clone(), p_blk.clone(), iteration)
        ref.solve(stop_after=iters, on_iteration=grab)
        rv, rp, rit = got["vp"]
        ref_vp[field] = (rv[:ref.n_eff].cpu().numpy(),
                         rp[:ref.n_eff].cpu().numpy())
        for g in MESH_GRIDS:
            mv, mp, mit, mits, msecs = out[g, field]
            assert rit == mit == mits == iters, (g, field, rit, mit, mits)
            for name, a, b in (("v", mv, rv), ("p", mp, rp)):
                if not np.array_equal(a, b[:ref.n_eff].cpu().numpy()):
                    raise AssertionError(
                        f"phase 14 {field} on {g[0]} x {g[1]}: the mesh's "
                        f"{name} differs from the one-device solver's after "
                        f"{iters} iterations")
            print(f"  {field} on {g[0]} x {g[1]}: v and p equal after "
                  f"{iters} iterations; the mesh's loop took {msecs:.1f} s "
                  f"({MESH_RANKS} ranks sharing one card over gloo: not a "
                  "multi-GPU speed)", flush=True)
        del ref
    for name in ("psum_mod", "psum_mod_wide", "pxor"):
        assert out["counts"][name] >= 3 * iters * len(MESH_GRIDS), \
            out["counts"]
    return out, ref_vp



# ---------------------------------------------------------------------------
# Phase 15: checkpoints
# ---------------------------------------------------------------------------

def ckpt_meta(solver, M, mtx) -> dict:
    """The run meta the CLI writes into a checkpoint's manifest."""
    return {"matrix": mtx, "prime": int(M.prime), "n": solver.n,
            "right": False, "field": solver.field, "nrows": M.nrows,
            "ncols": M.ncols, "nnz": M.nnz, "m_eff": int(solver.m_eff)}


def dir_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def mid_save(solver, ckdir, meta, saves, key):
    """An on_iteration callback that saves the solve's state once, through
    CheckpointManager.request_save, at its first block boundary at or past
    half its expected iterations (the manager's timer is an hour: nothing
    else saves); saves[key] gets the iteration, the save's seconds and the
    checkpoint's bytes."""
    import shutil

    from block_lanczos_tpu_torch.utils import checkpoint as ckpt
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = ckpt.CheckpointManager(ckdir, interval_s=3600.0, meta=meta,
                                 solver=solver)
    half = solver.expected_iterations // 2

    def on_iteration(slv, iteration, v, p_blk, start):
        if key in saves or iteration < half:
            return
        mgr.request_save()
        t0 = time.time()
        if not mgr.maybe_save(iteration, v, p_blk, start):
            raise AssertionError(f"{key}: the requested save did not happen")
        saves[key] = {"iteration": iteration, "save_s": time.time() - t0,
                      "bytes": dir_bytes(ckdir), "dir": ckdir}
    return on_iteration


def load_resume(key, saves, field, device):
    """The checkpoint of saves[key] read and brought to `device` as the
    port's resume state (convert.FROM_NUMPY); its seconds go into
    saves[key]["load_s"]."""
    from block_lanczos_tpu_torch import convert
    from block_lanczos_tpu_torch.utils import checkpoint as ckpt
    t0 = time.time()
    state = ckpt.load_checkpoint(saves[key]["dir"])
    rs = convert.FROM_NUMPY[field](state, device)
    saves[key]["load_s"] = time.time() - t0
    assert rs["iteration"] == saves[key]["iteration"], (key, state)
    return rs


def load_resume_dir(d, field, device):
    from block_lanczos_tpu_torch import convert
    from block_lanczos_tpu_torch.utils import checkpoint as ckpt
    return convert.FROM_NUMPY[field](ckpt.load_checkpoint(d), device)


def write_kernel(res, solver, p, path):
    """The solve's kernel file as phases 4, 6 and 9 write it (a KO block
    salvaged, as phase 6 does)."""
    from block_lanczos_tpu_torch.utils import mmio, salvage
    kernel = res.kernel
    if not res.product_zero:
        kernel = salvage.salvage_kernel(res.kernel, res.vtM, p)
        assert kernel.shape[1] >= 1, "salvage recovered no kernel vector"
    mmio.write_kernel_mtx(path, kernel, solver.n_eff, kernel.shape[1])
    return path


def same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def cli_preempt_round_trip(prime, card):
    """The CLI on the card: --checkpoint 0 --sync-every 1, SIGTERM to its
    process after the first save line, exit 143; then --load-checkpoint to
    the end and the checker.  Returns the line to print (phase 15 runs
    this beside its own solves, so it prints nothing itself)."""
    import shutil
    import signal

    from block_lanczos_tpu_torch.utils import checker, gen
    mtx = os.path.join(WORK, "cli_30000x20000.mtx")
    gen.write_random_mtx(mtx, 30_000, 20_000, gen.BENCH_DENSITY,
                         seed=gen.BENCH_SEED)
    ckdir, kfile = (os.path.join(WORK, "ckpt_cli"),
                    os.path.join(WORK, "cli.kernel.mtx"))
    shutil.rmtree(ckdir, ignore_errors=True)
    base = [sys.executable, "-m", "block_lanczos_tpu_torch.utils.cli",
            "--matrix", mtx, "--prime", str(prime), "--n", "4",
            "--checkpoint-dir", ckdir, "--output-file", kfile]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.time()
    proc = subprocess.Popen(base + ["--checkpoint", "0", "--sync-every", "1"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and ">> checkpoint at iteration" in line:
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    first_s = time.time() - t0
    out = "".join(lines)
    if not sent or rc != 128 + signal.SIGTERM or \
            "state checkpointed" not in out:
        raise AssertionError(f"the preempted CLI exited {rc} (signal sent: "
                             f"{sent}):\n{out[-3000:]}")
    with open(os.path.join(ckdir, "manifest.json")) as fh:
        at = json.load(fh)["iteration"]
    t0 = time.time()
    r = subprocess.run(base + ["--load-checkpoint"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    second_s = time.time() - t0
    if r.returncode != 0 or f"Resuming from iteration {at}" not in r.stdout:
        raise AssertionError(f"the resumed CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    checker.check_kernel_file(mtx, kfile, prime)
    return (f"  CLI: SIGTERM after the first save line -> exit {rc} at "
            f"iteration {at} ({first_s:.1f} s, the process's start "
            f"included); --load-checkpoint to the end, checker OK "
            f"({second_s:.1f} s) [{card}]")


# ---------------------------------------------------------------------------
# Phase 16: comm/compute overlap and the profilers
# ---------------------------------------------------------------------------

OVERLAP_ITERS = 4096        # the narrow and wide overlap solves' depth


def chunk_spmv_launches(solver) -> int:
    """SpMV launches an overlap step makes: one a column band of each of
    its four chunk operators (a narrow or wide operator is one)."""
    ops = solver.ops
    return sum(len(op) if isinstance(op, tuple) else 1
               for op in (ops.first_a, ops.first_b, ops.second_a,
                          ops.second_b))


def overlap_solves(dev, cases, card, mesh13):
    """Phase 16 on a 1 x 1 NCCL grid: each (field, M, n, stop, check) of
    `cases` solved by the field's sharded solver with overlap=True, to
    `stop` iterations or (stop None) whole; check(result, solver, [v, p]
    at the end in true row order]) holds it against the one-device
    solve.  The launch counts (reset just before,
    read just after each solve) must show the overlap step's launches: its
    chunks' SpMVs, five collective folds, one of each other kernel an
    iteration.  Prints each ms/iter beside phase 13's (`mesh13`)."""
    import torch
    import torch.distributed as tdist
    from block_lanczos_tpu_torch.parallel import distributed as D
    from block_lanczos_tpu_torch.parallel import multihost
    from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
        ShardedBlockLanczosGF2
    from block_lanczos_tpu_torch.parallel.distributed_wide import \
        ShardedBlockLanczosWide
    from block_lanczos_tpu_torch.parallel.mesh import make_grid
    solvers = {"narrow": D.ShardedBlockLanczos,
               "gf2": ShardedBlockLanczosGF2, "wide": ShardedBlockLanczosWide}
    rdv = os.path.join(WORK, "overlap_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    multihost.init_distributed("file://" + rdv, 1, 0, "nccl", 300, dev)
    try:
        grid = make_grid(1, 1, dev)
        for field, Mx, n, stop, check in cases:
            t0 = time.time()
            solver = solvers[field](Mx, n=n, grid=grid, overlap=True)
            layout_s = time.time() - t0
            last = {}

            def keep(slv, iteration, v, p_blk, start):
                last["vp"] = (v.clone(), p_blk.clone())
            D.reset_launch_counts()
            torch.cuda.synchronize()
            res = solver.solve(stop_after=stop or -1, verbose=stop is None,
                               on_iteration=keep)
            torch.cuda.synchronize()
            mc = D.launch_counts()
            check(res, solver, [solver.gather_rows(t) for t in last["vp"]])
            spmv, *rest, coll = MESH_KERNELS[field]
            steps = mc[rest[0]]       # one Gram an iteration run
            assert steps >= res.iterations, mc
            assert mc[spmv] == chunk_spmv_launches(solver) * steps, mc
            assert mc[coll] == 5 * steps, mc
            for name in rest:
                assert mc[name] == steps, mc
            if stop is not None:
                assert steps == res.iterations == stop, (mc, res.iterations)
            ms = res.elapsed / max(res.iterations, 1) * 1e3
            m13 = mesh13[field]
            print(f"  {field}: overlap (chunks ha = {solver.ops.ha}, hb = "
                  f"{solver.ops.hb}), layout {layout_s:.1f} s; "
                  f"{res.iterations} iterations, loop {res.elapsed:.3f} s, "
                  f"{ms:.4f} ms/iter against phase 13's (no overlap, whole "
                  f"solve) {m13['ms_iter']:.4f}; launches an iteration: "
                  f"{spmv} {mc[spmv] / steps:.2f} (phase 13 "
                  f"{m13['spmv_iter']:.2f}), {coll} {mc[coll] / steps:.2f} "
                  f"(phase 13 {m13['coll_iter']:.2f}) [{card}]", flush=True)
            del solver
    finally:
        tdist.destroy_process_group()


def run_profilers(solver, card):
    """Phase 16's profiler on the card: utils/profiling.py's trace around
    10 iterations of `solver` (a one-device BlockLanczos), whose Chrome
    trace must name spmv_ell and hold the solve's spans."""
    from block_lanczos_tpu_torch.utils import profiling
    t0 = time.time()
    tdir = os.path.join(WORK, "trace")
    with profiling.trace(tdir):
        tres = solver.solve(stop_after=10)
    assert tres.iterations == 10, tres.iterations
    path = os.path.join(tdir, profiling.TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels_seen = sorted({e["name"] for e in events
                           if e.get("cat") == "kernel"})
    if not any("spmv_ell" in k for k in kernels_seen):
        raise AssertionError(f"the trace of 10 iterations names no spmv_ell "
                             f"kernel: {kernels_seen[:20]}")
    spans = sorted({e["name"] for e in events if e.get("cat") == "span"})
    if "solve.loop" not in spans:
        raise AssertionError(f"the trace holds no solve.loop span: {spans}")
    print(f"  trace: {os.path.getsize(path)} bytes, {len(events)} events, "
          f"device kernels {kernels_seen}, spans {spans}; the profiler took "
          f"{time.time() - t0:.1f} s [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device(DEVICE)

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.models import lanczos_gf2 as G
    from block_lanczos_tpu_torch.models import lanczos_wide as LW
    from block_lanczos_tpu_torch.ops import dense, spmm
    from block_lanczos_tpu_torch.ops import semi_inverse as si_mod
    from block_lanczos_tpu_torch.ops.gfp import LAZY_FOLD, GFp
    from block_lanczos_tpu_torch.utils import checker, gen, mmio, salvage

    prime = gen.BENCH_PRIME

    # ---- phase 1: build ---------------------------------------------------
    # every kernel source and, beside them, the two builds phase 2 holds
    # equal (gram_wide recombining every 64 / 128 rows) or times (the
    # gather-only spmv_wide): one nvcc a source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(kernels.load_all),
                pool.submit(kernels.build, ["gram_wide"],
                            GRAM_WIDE_SMALL_FOLDS),
                pool.submit(kernels.build, ["spmv_wide"],
                            {"SPMV_WIDE_GATHER_ONLY": 1})]
        for job in jobs:
            job.result()
    print(f"phase 1: kernels built and loaded in {time.time() - t0:.1f} s",
          flush=True)

    recs = {
        "spmv_ell": KernelRecord(
            "spmv_ell", "block_lanczos_tpu_torch/csrc/spmv_ell.cu",
            "block_lanczos_tpu/ops/spmm.py:549"),
        "gram_mod": KernelRecord(
            "gram_mod", "block_lanczos_tpu_torch/csrc/gram_mod.cu",
            "block_lanczos_tpu/ops/pallas_gram.py:49"),
        "semi_inverse": KernelRecord(
            "semi_inverse", "block_lanczos_tpu_torch/csrc/semi_inverse.cu",
            "block_lanczos_tpu/ops/semi_inverse.py:123"),
        "orthogonalize": KernelRecord(
            "orthogonalize", "block_lanczos_tpu_torch/csrc/orthogonalize.cu",
            "block_lanczos_tpu/models/lanczos.py:98"),
        "spmv_gf2": KernelRecord(
            "spmv_gf2", "block_lanczos_tpu_torch/csrc/spmv_gf2.cu",
            "block_lanczos_tpu/models/lanczos_gf2.py:123"),
        "gram_gf2": KernelRecord(
            "gram_gf2", "block_lanczos_tpu_torch/csrc/gram_gf2.cu",
            "block_lanczos_tpu/ops/gf2.py:128"),
        "semi_inverse_gf2": KernelRecord(
            "semi_inverse_gf2",
            "block_lanczos_tpu_torch/csrc/semi_inverse_gf2.cu",
            "block_lanczos_tpu/ops/gf2.py:221"),
        "orthogonalize_gf2": KernelRecord(
            "orthogonalize_gf2",
            "block_lanczos_tpu_torch/csrc/orthogonalize_gf2.cu",
            "block_lanczos_tpu/models/lanczos_gf2.py:175"),
        "spmv_wide": KernelRecord(
            "spmv_wide", "block_lanczos_tpu_torch/csrc/spmv_wide.cu",
            "block_lanczos_tpu/ops/wide_ops.py:322"),
        "gram_wide": KernelRecord(
            "gram_wide", "block_lanczos_tpu_torch/csrc/gram_wide.cu",
            "block_lanczos_tpu/ops/wide_ops.py:47"),
        "semi_inverse_wide": KernelRecord(
            "semi_inverse_wide",
            "block_lanczos_tpu_torch/csrc/semi_inverse_wide.cu",
            "block_lanczos_tpu/ops/wide_ops.py:131"),
        "orthogonalize_wide": KernelRecord(
            "orthogonalize_wide",
            "block_lanczos_tpu_torch/csrc/orthogonalize_wide.cu",
            "block_lanczos_tpu/models/lanczos_wide.py:30"),
        "psum_mod": KernelRecord(
            "psum_mod", "block_lanczos_tpu_torch/csrc/collectives.cu",
            "block_lanczos_tpu/parallel/collectives.py:20"),
        "psum_mod_wide": KernelRecord(
            "psum_mod_wide", "block_lanczos_tpu_torch/csrc/collectives.cu",
            "block_lanczos_tpu/parallel/collectives.py:28"),
        "pxor": KernelRecord(
            "pxor", "block_lanczos_tpu_torch/csrc/collectives.cu",
            "block_lanczos_tpu/parallel/distributed_gf2.py:39"),
        "xoshiro_fill": KernelRecord(
            "xoshiro_fill", "block_lanczos_tpu_torch/csrc/xoshiro_fill.cu",
            "block_lanczos_tpu/utils/rng.py:49"),
        "final_unpack": KernelRecord(
            "final_unpack", "block_lanczos_tpu_torch/csrc/gf2_final.cu",
            "block_lanczos_tpu/models/lanczos_gf2.py (host unpack)"),
    }
    rng = np.random.default_rng(2024)

    # ---- the bench matrix (used by phases 2, 4 to 8) ----------------------
    os.makedirs(WORK, exist_ok=True)
    mtx = os.path.join(WORK, f"bench_{gen.BENCH_NROWS}x{gen.BENCH_NCOLS}_d"
                       f"{gen.BENCH_DENSITY}_s{gen.BENCH_SEED}.mtx")
    t0 = time.time()
    nnz = gen.write_random_mtx(mtx, gen.BENCH_NROWS, gen.BENCH_NCOLS,
                               gen.BENCH_DENSITY, seed=gen.BENCH_SEED)
    t1 = time.time()
    M = mmio.load_mtx(mtx, prime)
    t2 = time.time()
    print(f"bench matrix: {M.nrows} x {M.ncols}, {nnz} nnz; generated and "
          f"written in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s", flush=True)
    solver4 = L.BlockLanczos(M, n=4, device=dev)
    print(f"  layout built in {time.time() - t2:.1f} s: bwd ell "
          f"{solver4.sp.bwd.ell} spill {solver4.sp.bwd.spill_nnz}, fwd ell "
          f"{solver4.sp.fwd.ell} spill {solver4.sp.fwd.spill_nnz}", flush=True)
    # the same matrix mod 2 (bench.py:106-113, 462): the GF(2) slice's input
    M2 = mmio.COOMatrix(M.nrows, M.ncols, M.nnz, M.i, M.j,
                        (M.x % 2).astype(np.uint32), 2)
    t3 = time.time()
    gsolver = G.BlockLanczosGF2(M2, n=128, device=dev)
    print(f"  mod 2: {gsolver.nnz} odd entries, dedup dropped "
          f"{gsolver.dedup_dropped}; GF(2) layout built in "
          f"{time.time() - t3:.1f} s: " + ", ".join(
              f"{name} ell {b.ell} spill {b.spill_nnz}"
              for name, ops in (("Mt", gsolver.first_op),
                                ("M", gsolver.second_op)) for b in ops),
          flush=True)

    # the same file at 2^61 - 1 (bench.py:124-140, 471-473): the wide
    # field's input, through the wide loader
    wprime = gen.WIDE_BENCH_PRIME
    t3 = time.time()
    Mw = mmio.load_mtx(mtx, wprime)
    assert Mw.x.dtype == np.uint64
    wsolver = LW.BlockLanczosWide(Mw, n=4, device=dev)
    print(f"  mod 2^61 - 1: loaded and wide layout built in "
          f"{time.time() - t3:.1f} s: bwd ell {wsolver.sp.bwd.ell} spill "
          f"{wsolver.sp.bwd.spill_nnz}, fwd ell {wsolver.sp.fwd.ell} spill "
          f"{wsolver.sp.fwd.spill_nnz}", flush=True)

    # ---- phase 2: kernels against their plain versions ---------------------
    print("phase 2: kernels against their plain versions (tolerance 0: the "
          "arithmetic is exact)", flush=True)
    f = solver4.f
    p = f.p

    # spmv_ell at the main path's shapes, both directions
    rec = recs["spmv_ell"]
    ms, plain, nbytes, nops = [], [], [], []
    for n in (4, 32):
        v = rand_block(rng, solver4.np_rows, n, p, dev)
        for name, op, x, out_rows in (
                ("Mt*v", solver4.first_op, v, solver4.mp_rows),
                ("M*tmp", solver4.second_op, None, solver4.np_rows)):
            if x is None:
                x = rand_block(rng, solver4.mp_rows, n, p, dev)
            rec.agree(f"{name} n={n}", spmm.spmv(op, x, out_rows),
                      spmm.spmv_plain(op, x, out_rows))
            # 8 B of slab per true nonzero, x read, y written, rowptr
            nb = (8 * op.nnz + 4 * op.in_dim * n + 4 * out_rows * n
                  + 4 * (op.out_dim + 1))
            if n == 32:
                b32 = bound(nb, op.nnz * n)
                print(f"  spmv_ell {name} n=32: "
                      f"{median_ms(lambda: spmm.spmv(op, x, out_rows)):.4f} "
                      f"ms, bound {b32[0]:.6f} ms ({b32[1]})", flush=True)
            if n == 4:
                k_ms = median_ms(lambda: spmm.spmv(op, x, out_rows))
                p_ms = median_ms(lambda: spmm.spmv_plain(op, x, out_rows),
                                 reps=5)
                ms.append(k_ms)
                plain.append(p_ms)
                nbytes.append(nb)
                nops.append(op.nnz * n)
                print(f"  spmv_ell {name} n=4: {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound "
                      f"{rec.set_bound(nb, op.nnz * n):.4f} ms "
                      f"({rec.bound_by}), library_ms: none", flush=True)
    # the row is per launch: the mean of the two directions
    rec.ms, rec.plain_ms = statistics.mean(ms), statistics.mean(plain)
    rec.set_bound(statistics.mean(nbytes), statistics.mean(nops))
    # spmv_ell edge shapes
    for pe, n in ((2, 4), (3, 4), (65537, 1), (prime, 8)):
        fe = GFp.make(pe)
        i, j, x = gen.random_sparse(1003, 517, 7, seed=pe + n)
        i = np.concatenate([i, np.full(5000, 17), np.arange(40)])
        j = np.concatenate([j, rng.integers(0, 517, 5000), np.arange(40)])
        x = np.concatenate([x, rng.integers(1, 1 << 20, 5040)])
        for out_dim, in_dim, oi, ii in ((1003, 517, i, j), (517, 1003, j, i)):
            op = spmm.make_hybrid_op(fe, oi, ii, x % pe, out_dim, in_dim)
            if out_dim == 1003:
                assert op.spill_nnz >= 5000, "long spill row missing"
            op = op.to(dev)
            xb = rand_block(rng, in_dim + 5, n, pe, dev)
            rec.agree(f"edge p={pe} n={n} out={out_dim}",
                      spmm.spmv(op, xb, out_dim + 13),
                      spmm.spmv_plain(op, xb, out_dim + 13))
    op = spmm.make_hybrid_op(f, np.arange(999) % 333, np.arange(999) % 71,
                             np.arange(1, 1000), 333, 71).to(dev)
    assert op.spill_nnz == 0
    xb = rand_block(rng, 71, 3, p, dev)
    rec.agree("empty spill", spmm.spmv(op, xb, 341), spmm.spmv_plain(op, xb, 341))
    # worst case of the lazy sums: every value and every x at p - 1, rows
    # longer than the fold interval in the slab (forced ell 2 * fold + 3)
    # and in the spill (up to 600 entries), at every vector width (n % 4,
    # n % 2, odd) and with x and y off their 16-byte alignment
    fold = LAZY_FOLD
    i = np.concatenate([np.repeat(np.arange(300), 2 * fold + 5),
                        np.full(600, 7), np.arange(40) * 3])
    j = rng.integers(0, 250, i.size)
    op = spmm.make_hybrid_op(f, i, j, np.full(i.size, p - 1), 300, 250,
                             ell=2 * fold + 3).to(dev)
    assert op.spill_nnz > 600 + 300
    for n in (1, 2, 3, 4, 8, 32, 64):
        for skew in (0, 1):
            xf = torch.full((250 * n + skew,), p - 1, dtype=torch.int32,
                            device=dev)
            yf = torch.empty((307 * n + skew,), dtype=torch.int32, device=dev)
            xb = xf[skew:].view(250, n)
            yb = yf[skew:].view(307, n)
            rec.agree(f"all p-1 n={n} misaligned={skew}",
                      spmm.spmv(op, xb, 307, out=yb),
                      spmm.spmv_plain(op, xb, 307))
    print(f"  spmv_ell: {rec.cases} cases equal", flush=True)

    # gram_mod
    rec = recs["gram_mod"]
    gram_t = check_gram(rec, rng, p, solver4.np_rows, dev)
    rec.ms, rec.plain_ms, (rec.bound_ms, rec.bound_by) = gram_t[4]
    print(f"  gram_mod n=4: {rec.ms:.4f} ms, plain {rec.plain_ms:.4f} ms, "
          f"bound {rec.bound_ms:.4f} ms ({rec.bound_by}), library_ms: none",
          flush=True)
    print(f"  gram_mod: {rec.cases} cases equal", flush=True)

    # semi_inverse: real Grams from the bench iteration, singular, zero
    rec = recs["semi_inverse"]

    def si_case(what, grams, pe, check=True):
        s_k, s_p = si_mod.new_state(dev), si_mod.new_state(dev)
        got = si_mod.semi_inverse(grams, pe, s_k, check)
        want = si_mod.semi_inverse_plain(grams, pe, s_p, check)
        for a, b in zip(got, want):
            rec.agree(what, a, b)
        rec.agree(what + " state", s_k, s_p)
        return got, s_k

    grams_by_n = {}
    for n in (4, 32):
        v = rand_block(rng, solver4.np_rows, n, p, dev)
        tmp = spmm.spmv(solver4.first_op, v, solver4.mp_rows)
        av = spmm.spmv(solver4.second_op, tmp, solver4.np_rows)
        grams_by_n[n] = (v, av, dense.gram_mod(v, av, av, p))
        si_case(f"bench gram n={n}", grams_by_n[n][2], p)
    g4 = grams_by_n[4][2]
    state = si_mod.new_state(dev)
    rec.ms = median_ms(lambda: si_mod.semi_inverse(g4, p, state))
    rec.plain_ms = median_ms(
        lambda: si_mod.semi_inverse_plain(g4, p, si_mod.new_state(dev)),
        reps=5)
    # grams read; winv, d, npiv, rhs and the state written; two
    # eliminations of M and W (4 n^3 multiply-adds), the check and the
    # right-hand side (2 n^3)
    rec.set_bound(4 * (2 * 16 + 16 + 4 + 1 + 4 * 16 + 4), 6 * 4 ** 3)
    rec.note = ("latency-bound: the 2n pivot steps run one after another in "
                "one CTA, so neither bytes nor operations bound it; bound_ms "
                "is their floor all the same (PERF.md gives the chain's)")
    print(f"  semi_inverse n=4: {rec.ms:.4f} ms, plain {rec.plain_ms:.4f} ms,"
          f" bound {rec.bound_ms:.6f} ms ({rec.bound_by}), library_ms: none; "
          f"{rec.note}", flush=True)
    # edge cases: full rank up to n = 64, n = 1, 31, 33, p = 2 and 3,
    # singular and zero Grams, a failing check; the kernel's CTA shape by n
    # (1 to 32 warps) covers each of its barrier paths
    for pe, n, rank in ((prime, 8, 3), (2, 4, 2), (3, 4, 2), (65537, 1, 1),
                        (prime, 32, 17), (prime, 64, 40), (3, 16, 0),
                        (prime, 64, 66), (2, 64, 70), (3, 33, 35),
                        (prime, 31, 33), (prime, 33, 20), (prime, 1, 1),
                        (2, 1, 1), (2, 31, 0), (65537, 4, 0), (3, 8, 9)):
        U = low_rank_sym(rng, n, rank, pe)
        UA = rng.integers(0, pe, size=(n, n), dtype=np.int64)
        UA = (UA + UA.T) % pe
        grams = torch.from_numpy(
            np.concatenate([U, UA]).astype(np.int32)).to(dev)
        got, s_k = si_case(f"p={pe} n={n} rank<={rank}", grams, pe)
        if rank == 0:
            assert int(got.npiv[0]) == 0 and int(s_k[0]) == 1, "zero Gram"
        if rank > n and pe == prime:
            assert int(got.npiv[0]) == n, "expected a full-rank Gram"
    bad = grams.clone()        # the last case's Grams, p = 3, n = 8
    bad[n, n - 1] = (bad[n, n - 1] + 1) % 3    # vtAAv no longer symmetric
    _, s_k = si_case("p=3 n=8 failing check", bad, 3)
    assert int(s_k[1]) == 0, "the check should fail"
    print(f"  semi_inverse: {rec.cases} cases equal", flush=True)

    # orthogonalize
    rec = recs["orthogonalize"]
    ortho_t = check_ortho(rec, rng, p, solver4.np_rows, dev, si_mod, L,
                          grams_by_n)
    rec.ms, rec.plain_ms, (rec.bound_ms, rec.bound_by) = ortho_t[4]
    print(f"  orthogonalize n=4: {rec.ms:.4f} ms, plain {rec.plain_ms:.4f} "
          f"ms, bound {rec.bound_ms:.4f} ms ({rec.bound_by}), library_ms: "
          "none", flush=True)
    print(f"  orthogonalize: {rec.cases} cases equal", flush=True)
    print("  n=32 (event median, bound): " + "; ".join(
        f"{name} {t[32][0]:.4f} ms, bound {t[32][2][0]:.4f} ms "
        f"({t[32][2][1]})" for name, t in (("gram_mod", gram_t),
                                          ("orthogonalize", ortho_t)))
          + f" [{card}]", flush=True)
    torch.cuda.synchronize()

    # the GF(2) kernels
    check_gf2_kernels(recs, rng, dev, gsolver)
    torch.cuda.synchronize()

    # the wide kernels
    check_wide_kernels(recs, rng, dev, wsolver)
    torch.cuda.synchronize()

    # v0 drawn on the card
    check_xoshiro_fill(recs["xoshiro_fill"], dev)
    torch.cuda.synchronize()

    # GF(2)'s final step on the card
    check_final_unpack(recs["final_unpack"], rng, dev)
    torch.cuda.synchronize()

    # ---- phase 3: goldens on the card --------------------------------------
    print("phase 3: goldens on the card", flush=True)
    with open(os.path.join(GOLDEN, "MANIFEST.txt")) as fh:
        configs = [ln.split() for ln in fh if ln.strip()]
    n_golden = 0
    for name, gp, n, right in configs:
        gp, n, right = int(gp), int(n), right == "True"
        Mg = mmio.load_mtx(os.path.join(GOLDEN, f"{name}.mtx"), gp)
        if gp == 2 and n % 32 == 0:     # the GF(2) bitsliced path
            sg = G.BlockLanczosGF2(Mg, n=n, right=right, device=dev)
        else:
            sg = L.BlockLanczos(Mg, n=n, right=right, device=dev)
        res = sg.solve()
        out = os.path.join(WORK, f"{name}.kernel.mtx")
        mmio.write_kernel_mtx(out, res.kernel, sg.n_eff, n)
        with open(out, "rb") as a, \
                open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"golden {name}: kernel file differs")
        assert res.v_nonzero and res.product_zero, name
        print(f"  {name}: {res.iterations} iterations, byte-identical",
              flush=True)
        n_golden += 1
    assert n_golden == 9, n_golden

    # ---- phase 4: the main path at full size -------------------------------
    print(f"phase 4: full solve, p={prime}, n=4, left kernel, invariant "
          "checks on", flush=True)
    # the solve saves a checkpoint at its middle (phase 15 resumes it)
    saves = {}
    mid4 = mid_save(solver4, os.path.join(WORK, "ckpt_n4"),
                    ckpt_meta(solver4, M, mtx), saves, "bench-n4")
    L.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = res4 = solver4.solve(verbose=True, on_iteration=mid4)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    counts = L.launch_counts()
    # res.elapsed is the iteration loop (v0 drawn before it starts); each
    # block of the loop ends in a device sync; the checkpoint's save is
    # taken out of the ms/iter
    save_s = saves["bench-n4"]["save_s"]
    print(f"  iterations {res.iterations} (expected about "
          f"{solver4.expected_iterations}); loop {res.elapsed:.3f} s with "
          f"a checkpoint save of {save_s:.3f} s, "
          f"{(res.elapsed - save_s) / max(res.iterations, 1) * 1e3:.4f} "
          f"ms/iter without it; solve() {total_s:.3f} s [{card}]",
          flush=True)
    print(f"  launches during the solve: {counts}", flush=True)
    assert res.v_nonzero and res.product_zero, "final check failed"
    kpath = os.path.join(WORK, "bench.kernel.mtx")
    mmio.write_kernel_mtx(kpath, res.kernel, solver4.n_eff, 4)
    checker.check_kernel_file(mtx, kpath, prime, verbose=True)
    it = res.iterations
    assert counts["spmv_ell"] >= 2 * it, counts
    for name in ("gram_mod", "semi_inverse", "orthogonalize"):
        assert counts[name] >= it, counts
    assert counts["xoshiro_fill"] == 1, counts      # v0 drawn on the card

    # ---- phase 5: n = 32 ---------------------------------------------------
    print("phase 5: 100 iterations at n=32", flush=True)
    solver32 = L.BlockLanczos(M, n=32, device=dev)
    L.reset_launch_counts()
    r32 = solver32.solve(stop_after=100)
    counts32 = L.launch_counts()
    s32 = r32.elapsed
    assert r32.stopped_by_limit and r32.iterations == 100, r32.iterations
    print(f"  n=32: {r32.iterations} iterations, loop {s32:.3f} s, "
          f"{s32 / r32.iterations * 1e3:.4f} ms/iter [{card}]", flush=True)
    print(f"  launches during the n=32 block: {counts32}", flush=True)
    assert counts32["spmv_ell"] >= 2 * r32.iterations, counts32
    for name in ("gram_mod", "semi_inverse", "orthogonalize"):
        assert counts32[name] >= r32.iterations, counts32

    # ---- phase 6: the GF(2) slice at full size -----------------------------
    print("phase 6: GF(2) full solve of the bench matrix mod 2, n=128, left "
          "kernel, invariant checks on", flush=True)
    mid_g = mid_save(gsolver, os.path.join(WORK, "ckpt_gf2"),
                     ckpt_meta(gsolver, M2, mtx), saves, "bench-gf2-n128")
    G.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    gres = gsolver.solve(verbose=True, on_iteration=mid_g)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    gcounts = G.launch_counts()
    git = gres.iterations
    save_s = saves["bench-gf2-n128"]["save_s"]
    print(f"  iterations {git} (expected about "
          f"{gsolver.expected_iterations}); loop {gres.elapsed:.3f} s with "
          f"a checkpoint save of {save_s:.3f} s, "
          f"{(gres.elapsed - save_s) / max(git, 1) * 1e3:.4f} ms/iter "
          f"without it; solve() {total_s:.3f} s (v0 drawn before the loop) "
          f"[{card}]", flush=True)
    print(f"  launches during the solve: {gcounts}", flush=True)
    assert gres.v_nonzero, "GF(2) solve ended with v == 0"
    gkernel = gres.kernel
    if not gres.product_zero:
        gkernel = salvage.salvage_kernel(gres.kernel, gres.vtM, 2)
        print(f"  final check KO: salvage recovered {gkernel.shape[1]} / "
              "128 verified kernel vectors", flush=True)
        assert gkernel.shape[1] >= 1, "salvage recovered no kernel vector"
    kpath = os.path.join(WORK, "bench_gf2.kernel.mtx")
    mmio.write_kernel_mtx(kpath, gkernel, gsolver.n_eff, gkernel.shape[1])
    checker.check_kernel_file(mtx, kpath, 2, verbose=True)
    assert gcounts["spmv_gf2"] >= 2 * git, gcounts
    for name in ("gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2"):
        assert gcounts[name] >= git, gcounts
    assert gcounts["xoshiro_fill"] == 1, gcounts    # v0 drawn on the card
    # the final step on the card: a second launch unpacks vtM on a failure
    assert gcounts["final_unpack"] == 1 + (not gres.product_zero), gcounts

    # ---- phase 7: GF(2) against the narrow kernels at p = 2 ----------------
    print("phase 7: 50 iterations of BlockLanczosGF2(n=64, dedup=False), of "
          "the same on operators in 2 column bands, and of the narrow "
          "BlockLanczos at p=2, n=64", flush=True)
    from block_lanczos_tpu_torch.ops import gf2
    g64 = G.BlockLanczosGF2(M2, n=64, dedup=False, device=dev)
    b64 = G.BlockLanczosGF2(M2, n=64, dedup=False, device=dev)
    odd = (M2.x & 1) == 1
    fwd, bwd = (tuple(b.to(dev) for b in G.make_gf2_bands(
        o, c, out_dim, in_dim, 2)) for o, c, out_dim, in_dim in (
            (M2.i[odd], M2.j[odd], M2.nrows, M2.ncols),
            (M2.j[odd], M2.i[odd], M2.ncols, M2.nrows)))
    b64.first_op, b64.second_op = bwd, fwd           # the left kernel
    n64 = L.BlockLanczos(M2, n=64, device=dev)
    assert (g64.np_rows, g64.mp_rows) == (n64.np_rows, n64.mp_rows)
    last = {}

    def grab(key):
        def on_iteration(slv, iteration, v, p_blk, start):
            last[key] = (v.clone(), p_blk.clone(), iteration)
        return on_iteration

    g64.solve(stop_after=50, on_iteration=grab("gf2"))
    G.reset_launch_counts()
    b64.solve(stop_after=50, on_iteration=grab("banded"))
    bcounts = G.launch_counts()
    n64.solve(stop_after=50, on_iteration=grab("narrow"))
    nv, np_, nit50 = last["narrow"]
    for key in ("gf2", "banded"):
        gv, gp_, git50 = last[key]
        assert git50 == nit50 == 50, (key, git50, nit50)
        for name, g, nb in (("v", gv, nv), ("p", gp_, np_)):
            if not torch.equal(gf2.unpack_bits(g), nb):
                raise AssertionError(f"GF(2) ({key}) and narrow {name} "
                                     "differ after 50 iterations")
    assert bcounts["spmv_gf2"] >= 4 * 50, bcounts
    print(f"  v and p equal after 50 iterations ({g64.np_rows} x 64), "
          f"unbanded and in 2 bands (spmv_gf2 launches "
          f"{bcounts['spmv_gf2']})", flush=True)

    # ---- phase 8: n = 256 ----------------------------------------------------
    print("phase 8: 100 iterations at n=256 (GF(2))", flush=True)
    g256 = G.BlockLanczosGF2(M2, n=256, device=dev)
    G.reset_launch_counts()
    r256 = g256.solve(stop_after=100)
    counts256 = G.launch_counts()
    assert r256.stopped_by_limit and r256.iterations == 100, r256.iterations
    print(f"  n=256: {r256.iterations} iterations, loop {r256.elapsed:.3f} "
          f"s, {r256.elapsed / r256.iterations * 1e3:.4f} ms/iter [{card}]",
          flush=True)
    print(f"  launches during the n=256 block: {counts256}", flush=True)
    assert counts256["spmv_gf2"] >= 2 * r256.iterations, counts256
    for name in ("gram_gf2", "semi_inverse_gf2", "orthogonalize_gf2"):
        assert counts256[name] >= r256.iterations, counts256

    # ---- phase 9: the wide slice at full size -----------------------------
    print(f"phase 9: wide full solve of the bench matrix, p=2^61-1, n=4, "
          "left kernel, invariant checks on", flush=True)
    mid_w = mid_save(wsolver, os.path.join(WORK, "ckpt_wide"),
                     ckpt_meta(wsolver, Mw, mtx), saves, "bench-wide-p61-n4")
    LW.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    wres = wsolver.solve(verbose=True, on_iteration=mid_w)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    wcounts = LW.launch_counts()
    wit = wres.iterations
    save_s = saves["bench-wide-p61-n4"]["save_s"]
    print(f"  iterations {wit} (expected about "
          f"{wsolver.expected_iterations}); loop {wres.elapsed:.3f} s with "
          f"a checkpoint save of {save_s:.3f} s, "
          f"{(wres.elapsed - save_s) / max(wit, 1) * 1e3:.4f} ms/iter "
          f"without it; solve() {total_s:.3f} s [{card}]", flush=True)
    print(f"  launches during the solve: {wcounts}", flush=True)
    assert wres.v_nonzero and wres.product_zero, "wide final check failed"
    assert wres.kernel.dtype == np.uint64
    kpath = os.path.join(WORK, "bench_wide.kernel.mtx")
    mmio.write_kernel_mtx(kpath, wres.kernel, wsolver.n_eff, 4)
    t0 = time.time()
    checker.check_kernel_file(mtx, kpath, wprime, verbose=True)
    print(f"  the port's wide checker: OK in {time.time() - t0:.1f} s",
          flush=True)
    assert wcounts["spmv_wide"] >= 2 * wit, wcounts
    for name in ("gram_wide", "semi_inverse_wide", "orthogonalize_wide"):
        assert wcounts[name] >= wit, wcounts
    assert wcounts["xoshiro_fill"] == 1, wcounts    # v0 drawn on the card

    # ---- phase 10: the wide field against the narrow one -------------------
    print(f"phase 10: 50 iterations of BlockLanczosWide and of the narrow "
          f"BlockLanczos at p={prime}, n=4", flush=True)
    w4 = LW.BlockLanczosWide(M, n=4, device=dev)
    n4 = L.BlockLanczos(M, n=4, device=dev)
    assert (w4.np_rows, w4.mp_rows) == (n4.np_rows, n4.mp_rows)
    w4.solve(stop_after=50, on_iteration=grab("wide"))
    n4.solve(stop_after=50, on_iteration=grab("narrow4"))
    (wv, wp, wit50), (nv, np_, nit50) = last["wide"], last["narrow4"]
    assert wit50 == nit50 == 50, (wit50, nit50)
    for name, a, b in (("v", wv, nv), ("p", wp, np_)):
        if not torch.equal(a, b.long()):
            raise AssertionError(f"wide and narrow {name} differ after 50 "
                                 "iterations")
    print(f"  v and p equal after 50 iterations ({w4.np_rows} x 4)",
          flush=True)

    # ---- phase 12: the collectives against their plain versions -----------
    print("phase 12: psum_mod, psum_mod_wide and pxor against their plain "
          "versions, on sums of R in " + str(COLL_RANKS) + " ranks' "
          "partials (tolerance 0)", flush=True)
    mesh_shapes = ((solver4.mp_rows, 4), (solver4.np_rows, 4), (8, 4))
    gmesh_shapes = ((gsolver.mp_rows, gsolver.W), (gsolver.np_rows, gsolver.W),
                    (2 * 128, gsolver.W))
    check_collectives(recs, dev, mesh_shapes, mesh_shapes, gmesh_shapes)
    torch.cuda.synchronize()

    # ---- phase 13: the mesh path at full size on a 1-rank NCCL group -------
    print("phase 13: the three sharded solvers on a 1 x 1 grid over NCCL "
          "(the mesh path: pack, all_reduce, fold after each partial), each "
          "solve whole", flush=True)
    mesh_counts, mesh13 = mesh_solves(
        recs, torch.device("cuda", torch.cuda.current_device()), "nccl",
        [("narrow", M, 4, res4, prime), ("gf2", M2, 128, gres, 2),
         ("wide", Mw, 4, wres, wprime)],
        {"psum_mod": mesh_shapes, "psum_mod_wide": mesh_shapes,
         "pxor": gmesh_shapes}, dict.fromkeys(("narrow", "gf2", "wide"), mtx),
        card, saves)

    # ---- phase 14: the multi-rank mesh on the one card ---------------------
    grids = " and ".join(f"{r} x {c}" for r, c in MESH_GRIDS)
    print(f"phase 14: grids {grids} of {MESH_RANKS} ranks over gloo, all on "
          f"cuda:0, {MESH_ITERS} iterations of each field on each (the "
          "per-shard kernels at shard shapes, the folds on 2- and 4-rank "
          "sums; a check of the mesh, NOT a multi-GPU speed)", flush=True)
    ckpt_b = os.path.join(WORK, "ckpt_mesh_2x2_wide")
    mesh_out, ref_vp = mesh_grid_run(
        DEVICE, M, {"narrow": prime, "gf2": 2, "wide": wprime},
        {"narrow": lambda: L.BlockLanczos(M, n=4, device=dev),
         "gf2": lambda: G.BlockLanczosGF2(M2, n=128, device=dev),
         "wide": lambda: LW.BlockLanczosWide(Mw, n=4, device=dev)},
        {"narrow": 4, "gf2": 128, "wide": 4}, MESH_ITERS,
        saves["mesh-1x1-n4"]["dir"], ckpt_b)

    # ---- phase 15: checkpoints -----------------------------------------
    print("phase 15: checkpoints in the JAX package's on-disk form: the "
          "mid-solve saves of phases 4, 6 and 9 resumed in fresh solvers to "
          "the end; the mesh's (phase 13's 1 x 1 NCCL, phase 14's 2 x 2 "
          "gloo) resumed on one device and on another grid; the CLI "
          "preempted by SIGTERM and resumed", flush=True)
    t15 = time.time()
    # the CLI's round trip is processes of its own: it runs meanwhile
    cli_pool = ThreadPoolExecutor(1)
    cli_job = cli_pool.submit(cli_preempt_round_trip, prime, card)
    kfiles = {"bench-n4": os.path.join(WORK, "bench.kernel.mtx"),
              "bench-gf2-n128": os.path.join(WORK, "bench_gf2.kernel.mtx"),
              "bench-wide-p61-n4": os.path.join(WORK,
                                                "bench_wide.kernel.mtx")}
    fresh = {}
    for key, field, make, mod, whole, fp, names in (
            ("bench-n4", "narrow", lambda: L.BlockLanczos(M, n=4, device=dev),
             L, res4, prime, ("spmv_ell", "gram_mod", "semi_inverse",
                              "orthogonalize")),
            ("bench-gf2-n128", "gf2",
             lambda: G.BlockLanczosGF2(M2, n=128, device=dev), G, gres, 2,
             ("spmv_gf2", "gram_gf2", "semi_inverse_gf2",
              "orthogonalize_gf2")),
            ("bench-wide-p61-n4", "wide",
             lambda: LW.BlockLanczosWide(Mw, n=4, device=dev), LW, wres,
             wprime, ("spmv_wide", "gram_wide", "semi_inverse_wide",
                      "orthogonalize_wide"))):
        t0 = time.time()
        fresh[field] = solver = make()
        layout_s = time.time() - t0
        state = load_resume(key, saves, field, dev)
        mod.reset_launch_counts()
        torch.cuda.synchronize()
        rres = solver.solve(resume_state=state)
        torch.cuda.synchronize()
        rc = mod.launch_counts()
        ran = rres.iterations - saves[key]["iteration"]
        assert rres.iterations == whole.iterations, (key, rres.iterations)
        kpath = write_kernel(rres, solver, fp,
                             os.path.join(WORK, f"resumed_{field}.mtx"))
        if not same_bytes(kpath, kfiles[key]):
            raise AssertionError(f"{key}: the resumed solve's kernel file "
                                 "differs from the uninterrupted one's")
        checker.check_kernel_file(mtx, kpath, fp)
        assert rc[names[0]] >= 2 * ran, rc
        for name in names[1:]:
            assert rc[name] >= ran, rc
        assert rc["xoshiro_fill"] == 0, rc     # a resume draws no v0
        sv = saves[key]
        print(f"  {key}: saved at iteration {sv['iteration']} in "
              f"{sv['save_s']:.3f} s, {sv['bytes']} bytes; loaded in "
              f"{sv['load_s']:.3f} s; a fresh solver (layout {layout_s:.1f} "
              f"s) resumed it to iteration {rres.iterations} in "
              f"{rres.elapsed:.3f} s: kernel file byte-identical, checker "
              f"OK; launches {rc} [{card}]", flush=True)
    # the mesh's checkpoints: phase 13's (1 x 1 NCCL, narrow) to the end on
    # one device, and RESUME_ITERS iterations against phase 14's 2 x 2
    a_key = "mesh-1x1-n4"
    sa = load_resume(a_key, saves, "narrow", dev)
    L.reset_launch_counts()
    ares = fresh["narrow"].solve(resume_state=sa)
    ac = L.launch_counts()
    kpath = write_kernel(ares, fresh["narrow"], prime,
                         os.path.join(WORK, "resumed_mesh_narrow.mtx"))
    if ares.iterations != res4.iterations or \
            not same_bytes(kpath, kfiles["bench-n4"]):
        raise AssertionError("the 1 x 1 mesh's checkpoint, resumed on one "
                             "device, does not end at phase 4's kernel")
    assert ac["spmv_ell"] >= 2 * (ares.iterations - sa["iteration"]), ac
    last = {}
    fresh["narrow"].solve(
        stop_after=sa["iteration"] + RESUME_ITERS, resume_state=sa,
        on_iteration=grab("a"))
    av, ap, ait = last["a"]
    mv, mp = mesh_out["resume", (2, 2), "narrow"][:2]
    if ait != sa["iteration"] + RESUME_ITERS or \
            not np.array_equal(mv, av[:fresh["narrow"].n_eff].cpu().numpy()) \
            or not np.array_equal(mp, ap[:fresh["narrow"].n_eff].cpu().numpy()):
        raise AssertionError("the 1 x 1 mesh's checkpoint resumed on the "
                             "2 x 2 grid differs from one device's")
    sv = saves[a_key]
    print(f"  {a_key} (phase 13): saved at iteration {sv['iteration']} in "
          f"{sv['save_s']:.3f} s, {sv['bytes']} bytes; loaded in "
          f"{sv['load_s']:.3f} s; resumed on one device to the end: phase "
          f"4's kernel file, byte for byte; on the 2 x 2 gloo grid "
          f"{RESUME_ITERS} iterations: v and p equal to one device's",
          flush=True)
    # phase 14's 2 x 2 wide checkpoint, to MESH_ITERS on one device and on
    # the 4 x 1 grid, against the uninterrupted one-device (v, p)
    sb = mesh_out["saved", (2, 2), "wide"]
    wv, wp = ref_vp["wide"]
    state_b = load_resume_dir(ckpt_b, "wide", dev)
    fresh["wide"].solve(stop_after=MESH_ITERS, resume_state=state_b,
                        on_iteration=grab("b"))
    bv, bp, bit = last["b"]
    n_eff = fresh["wide"].n_eff
    gv, gp = mesh_out["resume", (4, 1), "wide"][:2]
    for who, v_, p_ in (("one device", bv[:n_eff].cpu().numpy(),
                         bp[:n_eff].cpu().numpy()), ("the 4 x 1 grid", gv,
                                                     gp)):
        if not (np.array_equal(v_, wv) and np.array_equal(p_, wp)):
            raise AssertionError(f"phase 14's 2 x 2 checkpoint resumed on "
                                 f"{who} differs from the uninterrupted "
                                 f"solve after {MESH_ITERS} iterations")
    assert bit == MESH_ITERS, bit
    print(f"  mesh-2x2-wide (phase 14): the root's request saved on every "
          f"rank at iteration {sb['iteration']} ({sb['s']:.3f} s at rank 0, "
          f"{dir_bytes(ckpt_b)} bytes); resumed to iteration {MESH_ITERS} on "
          f"one device and on the 4 x 1 grid: v and p equal to the "
          f"uninterrupted solve's", flush=True)
    print(cli_job.result(), flush=True)
    cli_pool.shutdown()
    print(f"  phase 15 took {time.time() - t15:.1f} s", flush=True)

    # ---- phase 16: comm/compute overlap and the profilers ---------------
    print(f"phase 16: the overlap step (overlap=True: each SpMV in two row "
          f"chunks, chunk A's all-reduce in flight during chunk B's SpMV) on "
          f"a 1 x 1 NCCL grid (GF(2) whole, narrow and wide to "
          f"{OVERLAP_ITERS} iterations) and on phase 14's 2 x 2 gloo grid; "
          "the profilers on the card", flush=True)
    t16 = time.time()
    ref = {}
    for field, solver in (("narrow", fresh["narrow"]),
                          ("wide", fresh["wide"])):
        # the one-device solve to the same iteration (the solvers' first
        # v0: phase 15 only resumed them)
        solver.solve(stop_after=OVERLAP_ITERS, on_iteration=grab(field))
        v_, p_, it_ = last[field]
        assert it_ == OVERLAP_ITERS, it_
        ref[field] = (v_[:solver.n_eff].cpu().numpy(),
                      p_[:solver.n_eff].cpu().numpy())

    def same_vp(field):
        def check(res, solver, vp):
            for name, a, b in zip("vp", vp, ref[field]):
                if not np.array_equal(a, b):
                    raise AssertionError(
                        f"phase 16 {field}: the overlap solve's {name} "
                        f"differs from one device's after {OVERLAP_ITERS} "
                        "iterations")
        return check

    def same_gf2_file(res, solver, vp):
        kpath = write_kernel(res, solver, 2,
                             os.path.join(WORK, "overlap_gf2.kernel.mtx"))
        if res.iterations != gres.iterations or \
                not same_bytes(kpath, kfiles["bench-gf2-n128"]):
            raise AssertionError("phase 16 gf2: the overlap solve's kernel "
                                 "file differs from phase 6's")
        checker.check_kernel_file(mtx, kpath, 2)

    overlap_solves(
        torch.device("cuda", torch.cuda.current_device()),
        [("gf2", M2, 128, None, same_gf2_file),
         ("narrow", M, 4, OVERLAP_ITERS, same_vp("narrow")),
         ("wide", Mw, 4, OVERLAP_ITERS, same_vp("wide"))], card, mesh13)
    oc = mesh_out["overlap_counts"]
    for field in ("narrow", "gf2", "wide"):
        mv, mp, mit, mits, msecs = mesh_out["overlap", field]
        rv, rp = ref_vp[field]
        assert mit == mits == MESH_ITERS, (field, mit, mits)
        if not (np.array_equal(mv, rv) and np.array_equal(mp, rp)):
            raise AssertionError(f"phase 16 {field} on 2 x 2 with overlap: "
                                 "v or p differs from the one-device solver's "
                                 f"after {MESH_ITERS} iterations")
        print(f"  {field} on 2 x 2 (gloo, 4 ranks on one card) with overlap: "
              f"v and p equal to one device's after {MESH_ITERS} iterations; "
              f"the loop took {msecs:.1f} s (not a multi-GPU speed)",
              flush=True)
    for spmv, *_, coll in MESH_KERNELS.values():
        assert oc[coll] == 5 * MESH_ITERS, oc
        assert oc[spmv] >= 4 * MESH_ITERS, oc
    print(f"  rank 0's launches in the 2 x 2 overlap solves: {oc}",
          flush=True)
    run_profilers(fresh["narrow"], card)
    print(f"  phase 16 took {time.time() - t16:.1f} s", flush=True)

    # ---- phase 11: summary (last) -------------------------------------------
    counts.update(gcounts)
    counts.update(wcounts)
    counts.update(mesh_counts)
    # xoshiro_fill: phase 6's GF(2) solve's, the shape of its timed row
    # (phases 4 and 9 counted one each as well)
    counts["xoshiro_fill"] = gcounts["xoshiro_fill"]
    counts["final_unpack"] = gcounts["final_unpack"]
    print(json.dumps({"kernels": [recs[k].as_json(counts[k]) for k in recs]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
