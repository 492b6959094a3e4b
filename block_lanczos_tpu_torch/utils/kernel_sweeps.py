"""Design measurements of the spmv_ell and semi_inverse kernels on the card.

    python -m block_lanczos_tpu_torch.utils.kernel_sweeps

What chose the two kernels' shapes, on the bench matrix (utils/gen.py's
BENCH_* configuration, the one chip_smoke.py and profile_solve use), as
torch.profiler's device time per launch; every variant's outputs are first
held equal to the default build's:
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
    4, 8, 32, 64}.  The stamps themselves add a little to the launch.
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


def main() -> int:
    import torch

    from block_lanczos_tpu_torch import kernels
    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.ops import dense, spmm
    from block_lanczos_tpu_torch.utils import gen
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix

    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweeps needs a CUDA device")
    card = _card()
    dev = torch.device("cuda")
    variants = ([("spmv_ell", {"LAZY_FOLD": f, "SPMV_THREADS": t})
                 for f in FOLDS for t in THREADS]
                + [("semi_inverse", {"SI_WARPS": w}) for w in WARPS]
                + [("semi_inverse", {"SI_TIMELINE": 1})])
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: kernels.build([v[0]], v[1]), variants))
    kernels.load_all()

    i, j, x = gen.random_sparse(gen.BENCH_NROWS, gen.BENCH_NCOLS,
                                gen.BENCH_DENSITY, gen.BENCH_SEED)
    M = COOMatrix(gen.BENCH_NROWS, gen.BENCH_NCOLS, len(x),
                  i.astype(np.int32), j.astype(np.int32),
                  (x % gen.BENCH_PRIME).astype(np.uint32), gen.BENCH_PRIME)
    s = L.BlockLanczos(M, n=4, device=dev)
    p = s.f.p
    rng = np.random.default_rng(7)
    grams_by_n = {}
    for n in SI_NS:
        if n in (4, 32):
            v = _rand(rng, s.np_rows, n, p, dev)
            av = spmm.spmv(s.second_op, spmm.spmv(s.first_op, v, s.mp_rows),
                           s.np_rows)
            grams_by_n[n] = dense.gram_mod(v, av, av, p)
        else:
            grams_by_n[n] = _full_rank_grams(rng, n, p, dev)

    res = {"card": card, "spmv_ell": spmv_sweeps(s, M, rng, dev),
           "semi_inverse": semi_inverse_sweeps(grams_by_n, p, dev)}
    print(f"card: {card}; device ms per launch (torch.profiler, {REPS} "
          f"launches)")
    sp = res["spmv_ell"]
    for k, ms in sp["by_direction"].items():
        print(f"  spmv_ell {k}: {ms:.4f}")
    for k, lay in sp["layout"].items():
        print(f"  spmv_ell Mt*v n=4 {k} layout (ell {lay['ell']}, spill "
              f"{lay['spill']}): {lay['ms']:.4f}")
    for k, by_n in sp["fold_threads"].items():
        print(f"  spmv_ell {k}: " + ", ".join(
            f"{nk} {ms:.4f}" for nk, ms in by_n.items()))
    si = res["semi_inverse"]
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
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
