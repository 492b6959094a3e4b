#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (nvcc).  Phases, each of which raises (non-zero exit) on
failure:

  0. print the card's name and power limit; require CUDA;
  1. build the four CUDA kernels from block_lanczos_tpu_torch/csrc/;
  2. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes (the bench matrix, n = 4 and n = 32) and at edge
     shapes (p = 2 and 3, n = 1, an empty spill, one long spill row, N not a
     multiple of the block, singular and zero Grams; for spmv_ell the lazy
     sums' worst case, every value and x at p - 1 on rows longer than the
     fold in slab and spill, at every vector width n in {1, 2, 3, 4, 8, 32,
     64} and off 16-byte alignment; for semi_inverse full rank up to n = 64,
     n = 1, 31, 33, p = 2 and 3, a failing check): exact equality, since
     the arithmetic is exact; time each (CUDA events, median);
  3. solve the 8 narrow goldens on the card: every kernel file must be
     byte-identical to its golden;
  4. the main path at full size: generate the bench matrix (300000 x
     200000, 15 nnz/row, seed 42), write it and load it through the port's
     mmio, and solve it with p = 1073741789, n = 4, left kernel, invariant
     checks on; the final check and the port's checker must pass, and the
     launch counts (reset just before, read just after) must show that
     every kernel ran;
  5. a timed block of 100 iterations at n = 32 on the same matrix, whose
     launch counts (reset just before, read just after) must show that
     every kernel ran in every iteration;
  6. print the kernels JSON line, the card line, and the result line.

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
# Integer multiply-adds run on the CUDA cores; the published table has no
# integer rate there, so they are counted against its float32 rate.
CORE_OPS_PER_S = 67e12
TIMING_REPS = 30
GOLDEN = os.path.join(ROOT, "tests", "golden")
WORK = os.path.join(ROOT, "build", "chip_smoke")
DEVICE = "cuda"


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
        self.note = None

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
               "bound_by": self.bound_by, "library_ms": None}
        if self.note:
            row["note"] = self.note
        return row

    def set_bound(self, nbytes, nops):
        """The least time for the work: the larger of its bytes over the
        memory rate and its operations over the core rate."""
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / CORE_OPS_PER_S * 1e3
        self.bound_ms = max(b_ms, o_ms)
        self.bound_by = "bytes" if b_ms >= o_ms else "operations"
        return self.bound_ms


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device(DEVICE)

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.ops import dense, spmm
    from block_lanczos_tpu_torch.ops import semi_inverse as si_mod
    from block_lanczos_tpu_torch.ops.gfp import LAZY_FOLD, GFp
    from block_lanczos_tpu_torch.utils import checker, gen, mmio

    prime = gen.BENCH_PRIME

    # ---- phase 1: build ---------------------------------------------------
    print(f"phase 1: kernels built and loaded in {kernels.load_all():.1f} s",
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
    }
    rng = np.random.default_rng(2024)

    # ---- the bench matrix (used by phases 2, 4, 5) -------------------------
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
            if n == 4:
                k_ms = median_ms(lambda: spmm.spmv(op, x, out_rows))
                p_ms = median_ms(lambda: spmm.spmv_plain(op, x, out_rows),
                                 reps=5)
                # 8 B of slab per true nonzero, x read, y written, rowptr
                nb = (8 * op.nnz + 4 * op.in_dim * n + 4 * out_rows * n
                      + 4 * (op.out_dim + 1))
                ms.append(k_ms)
                plain.append(p_ms)
                nbytes.append(nb)
                nops.append(2 * op.nnz * n)
                print(f"  spmv_ell {name} n=4: {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound "
                      f"{rec.set_bound(nb, 2 * op.nnz * n):.4f} ms "
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
    for n in (4, 32):
        v = rand_block(rng, solver4.np_rows, n, p, dev)
        av = rand_block(rng, solver4.np_rows, n, p, dev)
        rec.agree(f"[v|Av]^T Av n={n}", dense.gram_mod(v, av, av, p),
                  dense.gram_mod_plain(v, av, av, p))
        if n == 4:
            rec.ms = median_ms(lambda: dense.gram_mod(v, av, av, p))
            rec.plain_ms = median_ms(
                lambda: dense.gram_mod_plain(v, av, av, p), reps=5)
            rec.set_bound(4 * v.numel() + 4 * av.numel() + 4 * 2 * n * n,
                          2 * v.shape[0] * 2 * n * n)
            print(f"  gram_mod n=4: {rec.ms:.4f} ms, plain "
                  f"{rec.plain_ms:.4f} ms, bound {rec.bound_ms:.4f} ms "
                  f"({rec.bound_by}), library_ms: none", flush=True)
    for N, n1, n2, b, pe in ((1, 1, 1, 1, prime), (1001, 4, 4, 4, 2),
                             (70_001, 8, 8, 8, 3), (9_001, 40, 0, 32, prime),
                             (4097, 1, 0, 1, 65537)):
        V1 = rand_block(rng, N, n1, pe, dev)
        V2 = rand_block(rng, N, n2, pe, dev) if n2 else None
        W = rand_block(rng, N, b, pe, dev)
        rec.agree(f"N={N} a={n1 + n2} b={b} p={pe}",
                  dense.gram_mod(V1, V2, W, pe),
                  dense.gram_mod_plain(V1, V2, W, pe))
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
    rec.set_bound(4 * (2 * 16 + 16 + 4 + 1 + 4 * 16 + 4), 2 * 6 * 4 ** 3)
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

    # orthogonalize, with a singular Gram's d so the masks are exercised
    rec = recs["orthogonalize"]
    for n in (4, 32):
        v, av, _ = grams_by_n[n]
        pb = rand_block(rng, solver4.np_rows, n, p, dev)
        U = low_rank_sym(rng, n, n - 1, p)
        grams = torch.from_numpy(
            np.concatenate([U, U]).astype(np.int32)).to(dev)
        si = si_mod.semi_inverse(grams, p, si_mod.new_state(dev))
        assert int(si.d.sum()) < n, "expected a rank-deficient d"
        for halted in (False, True):
            st_k = torch.tensor([int(halted), 1, 0, 0], dtype=torch.int32,
                                device=dev)
            st_p = st_k.clone()
            vk, pk, vp, pp = v.clone(), pb.clone(), v.clone(), pb.clone()
            L.orthogonalize(vk, pk, av, si.rhs, si.d, p, st_k)
            L.orthogonalize_plain(vp, pp, av, si.rhs, si.d, p, st_p)
            what = f"n={n} halted={halted}"
            rec.agree(what + " v", vk, vp)
            rec.agree(what + " p", pk, pp)
            rec.agree(what + " state", st_k, st_p)
            if halted:
                rec.agree(what + " frozen v", vk, v)
        if n == 4:
            st = si_mod.new_state(dev)
            vk, pk = v.clone(), pb.clone()
            rec.ms = median_ms(
                lambda: L.orthogonalize(vk, pk, av, si.rhs, si.d, p, st))
            rec.plain_ms = median_ms(
                lambda: L.orthogonalize_plain(vk, pk, av, si.rhs, si.d, p,
                                              si_mod.new_state(dev)), reps=5)
            # v, p, Av read, v and p written; 3 n^2 multiply-adds per row
            rec.set_bound(4 * 5 * v.numel() + 4 * (4 * n * n + n + 4),
                          2 * 3 * v.shape[0] * n * n)
            print(f"  orthogonalize n=4: {rec.ms:.4f} ms, plain "
                  f"{rec.plain_ms:.4f} ms, bound {rec.bound_ms:.4f} ms "
                  f"({rec.bound_by}), library_ms: none", flush=True)
    print(f"  orthogonalize: {rec.cases} cases equal", flush=True)
    torch.cuda.synchronize()

    # ---- phase 3: goldens on the card --------------------------------------
    print("phase 3: narrow goldens on the card", flush=True)
    with open(os.path.join(GOLDEN, "MANIFEST.txt")) as fh:
        configs = [ln.split() for ln in fh if ln.strip()]
    n_golden = 0
    for name, gp, n, right in configs:
        gp, n, right = int(gp), int(n), right == "True"
        if gp == 2 and n % 32 == 0:
            continue    # the GF(2) bitsliced path: a later slice
        Mg = mmio.load_mtx(os.path.join(GOLDEN, f"{name}.mtx"), gp)
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
    assert n_golden == 8, n_golden

    # ---- phase 4: the main path at full size -------------------------------
    print(f"phase 4: full solve, p={prime}, n=4, left kernel, invariant "
          "checks on", flush=True)
    L.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = solver4.solve(verbose=True)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    counts = L.launch_counts()
    # res.elapsed is the iteration loop (v0 drawn before it starts); each
    # block of the loop ends in a device sync
    print(f"  iterations {res.iterations} (expected about "
          f"{solver4.expected_iterations}); loop {res.elapsed:.3f} s, "
          f"{res.elapsed / max(res.iterations, 1) * 1e3:.4f} ms/iter; "
          f"solve() {total_s:.3f} s [{card}]", flush=True)
    print(f"  launches during the solve: {counts}", flush=True)
    assert res.v_nonzero and res.product_zero, "final check failed"
    kpath = os.path.join(WORK, "bench.kernel.mtx")
    mmio.write_kernel_mtx(kpath, res.kernel, solver4.n_eff, 4)
    checker.check_kernel_file(mtx, kpath, prime, verbose=True)
    it = res.iterations
    assert counts["spmv_ell"] >= 2 * it, counts
    for name in ("gram_mod", "semi_inverse", "orthogonalize"):
        assert counts[name] >= it, counts

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

    # ---- phase 6: summary ----------------------------------------------------
    print(json.dumps({"kernels": [recs[k].as_json(counts[k]) for k in recs]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
