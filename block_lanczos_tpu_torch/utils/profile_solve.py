"""Where the time of one solver iteration goes on the CUDA device.

    python -m block_lanczos_tpu_torch.utils.profile_solve --n 4
    python -m block_lanczos_tpu_torch.utils.profile_solve --n 32
    python -m block_lanczos_tpu_torch.utils.profile_solve --field gf2 \
        --n 128 256
    python -m block_lanczos_tpu_torch.utils.profile_solve --field gf2 \
        --n 128 256 --matrix 3Mx2M
    python -m block_lanczos_tpu_torch.utils.profile_solve --field wide --n 4
    python -m block_lanczos_tpu_torch.utils.profile_solve --field wide \
        --n 32 --iters 100
    python -m block_lanczos_tpu_torch.utils.profile_solve --mesh --n 4
    python -m block_lanczos_tpu_torch.utils.profile_solve --mesh \
        --field gf2 --n 128

Builds the matrix, runs the solver's iteration on the card, and reports for
a window of iterations far from the solve's end (narrow and wide field:
4096/n, 1024 at n = 4, 128 at n = 32; GF(2): 16384/n, 128 at n = 128, 64
at n = 256; or --iters, e.g. 100 as the depth-cut bench-n32 cells):
  * the wall time per iteration (host clock, synchronised at both ends),
    without and then with torch.profiler, and the host's issue time per
    iteration: the wall of the enqueue loop alone, taken before the sync
    (when it is near the wall, the host sets the pace);
  * per kernel (by its device name, so the path a kernel took shows, e.g.
    orthogonalize_mma_kernel at n = 32), the device time per iteration from
    the profiler, and per wrapper the device time per launch (a kernel
    belongs to the wrapper whose name is its longest prefix);
  * the device's busy share of the profiled window (kernel time / wall) and
    hence its idle share, which is the host's launch overhead.
With --mesh the iteration is the sharded solver's (parallel/) on a 1 x 1
grid over NCCL in this process: the field's kernels with an exact
all-reduce (pack, torch.distributed.all_reduce, fold) after each partial;
NCCL's own kernels count in the busy time, and the host's cost of one
collective call on tmp as the step makes it (its workspace's bound form:
collectives.PsumMod, PsumModWide or Pxor), of the all_reduce of its
payload, of its pack and fold kernels, of torch.remainder doing the same
1-rank fold (narrow and wide) and of reading PyTorch's current stream
(torch.cuda.current_stream().cuda_stream against kernels.current_stream)
is timed alone (1000 calls each, host clock, one sync at the end).
Matrices: `bench` is utils/gen.py's BENCH_* configuration (the one bench.py
and chip_smoke.py use), mod BENCH_PRIME for the narrow field, mod
WIDE_BENCH_PRIME = 2^61 - 1 for the wide field and mod 2 for GF(2); `3Mx2M` is the JAX bench's factorization-scale GF(2) instance
(random_sparse(3000000, 2000000, 17, seed=42) mod 2, 51M entries before the
reduction), generated in memory (about 8 s of NumPy on the H100's host)
and shared by the widths of one call.  Every window starts from the solver's own xoshiro
v0.  Needs a CUDA device; prints one JSON line per width, the last last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_name(key: str) -> str:
    """The bare device kernel name of a profiler event key:
    "spmv_ell_kernel(...)" or "void gram_mod_kernel<4, 4>(...)" ->
    "spmv_ell_kernel", "gram_mod_kernel"."""
    return (key.split("(")[0].split("<")[0].split() or [""])[-1]


def wrapper_of(kernel: str, wrappers) -> str | None:
    """The wrapper that launches a device kernel: the one whose name is the
    kernel's longest prefix (orthogonalize_mma_kernel -> orthogonalize);
    None for a kernel of no wrapper (PyTorch's own)."""
    return max((w for w in wrappers if kernel.startswith(w)), key=len,
               default=None)


def _matrix(name: str, prime: int):
    from block_lanczos_tpu_torch.utils import gen
    from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix
    dims = {"bench": (gen.BENCH_NROWS, gen.BENCH_NCOLS, gen.BENCH_DENSITY,
                      gen.BENCH_SEED),
            "3Mx2M": (3_000_000, 2_000_000, 17, 42)}[name]
    i, j, x = gen.random_sparse(*dims)
    dtype = np.uint64 if prime > PRIME_CAP else np.uint32
    return COOMatrix(dims[0], dims[1], len(x), i.astype(np.int32),
                     j.astype(np.int32), (x % prime).astype(dtype), prime)


def _mesh_solver(M, field: str, n: int):
    """The field's sharded solver on a 1 x 1 NCCL grid of this process (the
    process group made at the first call) and its one-iteration step."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from block_lanczos_tpu_torch.parallel import distributed as D
    from block_lanczos_tpu_torch.parallel import multihost
    from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
        ShardedBlockLanczosGF2
    from block_lanczos_tpu_torch.parallel.distributed_wide import \
        ShardedBlockLanczosWide
    from block_lanczos_tpu_torch.parallel.mesh import make_grid
    if not dist.is_initialized():
        rdv = os.path.join(tempfile.mkdtemp(prefix="bl_profile_"), "rdv")
        multihost.init_distributed("file://" + rdv, 1, 0, "nccl", 300,
                                   torch.device("cuda", 0))
    grid = make_grid(1, 1, torch.device("cuda", 0))
    cls = {"narrow": D.ShardedBlockLanczos, "wide": ShardedBlockLanczosWide,
           "gf2": ShardedBlockLanczosGF2}[field]
    return cls(M, n=n, grid=grid), D


def _host_us_per_call(fn, calls: int = 1000) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def profile_width(M, field: str, n: int, label: str,
                  iters: int | None = None, mesh: bool = False) -> dict:
    """Profile a window of `iters` iterations (default by n, above) at
    block width n on the matrix M (mod 2 for GF(2)) in `field` ("narrow",
    "wide" or "gf2"), on one device or (mesh) a 1 x 1 NCCL grid; prints
    the breakdown and returns its JSON record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from block_lanczos_tpu_torch.ops.semi_inverse import new_state

    gf2 = field == "gf2"
    iters = iters or (16384 if gf2 else 4096) // n
    t0 = time.perf_counter()
    host_us = None
    if mesh:
        import torch.distributed as dist

        s, L = _mesh_solver(M, field, n)
        mesh_ws = s._workspace()

        def step(ws):
            s._step(v, p_blk, state, mesh_ws)

        from block_lanczos_tpu_torch import kernels
        tmp, group = mesh_ws["tmp"], s.grid.rows_group
        # the step's bound form of the collective on tmp (PsumMod,
        # PsumModWide or Pxor)
        (_, _, bound), = mesh_ws["chunks"]["tmp"]
        payload = bound.pack(tmp)
        host_us = {"collective": _host_us_per_call(lambda: bound(tmp)),
                   "all_reduce": _host_us_per_call(
                       lambda: dist.all_reduce(payload, group=group)),
                   "pack_and_fold": _host_us_per_call(
                       lambda: bound.fold(bound.pack(tmp), tmp))}
        if not gf2:     # the same fold at one rank by one PyTorch call
            host_us["torch_remainder"] = _host_us_per_call(
                lambda: torch.remainder(tmp, s.f.p, out=tmp))
        # the two ways to read PyTorch's current stream for a launch
        host_us["stream_object"] = _host_us_per_call(
            lambda: torch.cuda.current_stream().cuda_stream)
        host_us["stream_raw"] = _host_us_per_call(kernels.current_stream)
    elif field == "wide":
        from block_lanczos_tpu_torch.models import lanczos_wide as L
        s = L.BlockLanczosWide(M, n=n)

        def step(ws):
            L.iteration_step(s.f, s.mp_rows, s.np_rows, True, s.first_op,
                             s.second_op, v, p_blk, state, ws)
    elif gf2:
        from block_lanczos_tpu_torch.models import lanczos_gf2 as L
        s = L.BlockLanczosGF2(M, n=n)

        def step(ws):
            L.iteration_step(n, s.mp_rows, s.np_rows, True, s.first_op,
                             s.second_op, v, p_blk, state, ws)
    else:
        from block_lanczos_tpu_torch.models import lanczos as L
        s = L.BlockLanczos(M, n=n)

        def step(ws):
            L.iteration_step(s.f, s.mp_rows, s.np_rows, True, s.first_op,
                             s.second_op, v, p_blk, state, ws)
    t1 = time.perf_counter()
    v = s._band(s._v0()) if mesh else s.initial_block()
    setup_s = (t1 - t0, time.perf_counter() - t1)
    p_blk = torch.zeros_like(v)
    state = new_state(v.device)
    ws = {}

    def run(k):
        """k iterations; returns the seconds the host took to enqueue them."""
        t0 = time.perf_counter()
        for _ in range(k):
            step(ws)
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return issue_s

    run(16)                                     # build, load, warm up
    t0 = time.perf_counter()
    issue_s = run(iters)
    plain_s = time.perf_counter() - t0
    L.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(iters)
        prof_s = time.perf_counter() - t0
    launches = L.launch_counts()
    assert state.tolist()[:2] == [0, 1], "the window ran into a halt"

    per_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = evt.cuda_time_total
        name = kernel_name(evt.key)
        if dev_us and (name.endswith("_kernel") or name.startswith("nccl")):
            per_kernel[name] = per_kernel.get(name, 0.0) + dev_us / iters / 1e3
    per_launch = {}
    for name, ms in per_kernel.items():
        w = wrapper_of(name, launches)
        if w is None or not launches[w]:   # PyTorch's or NCCL's kernel:
            continue                        # in the busy time, no wrapper's
        per_launch[w] = per_launch.get(w, 0.0) + ms * iters / launches[w]
    busy_ms = sum(per_kernel.values())
    iter_ms = prof_s / iters * 1e3
    card = _card()
    ops = (s.ops.first, s.ops.second) if mesh else (s.first_op,
                                                     s.second_op)
    bands = [len(op) for op in ops] if gf2 else None
    nnz = (int(s.ops.stats.shard_nnz.sum()) if mesh
           else s.nnz if gf2 else M.nnz)
    where = "a 1 x 1 NCCL mesh" if mesh else "one device"
    print(f"card: {card}; {field} n={n} on {where}, matrix {label} "
          f"({M.nrows} x {M.ncols}, {M.nnz} entries, {nnz} in the "
          f"operator{f', column bands {bands}' if gf2 else ''}), {iters} "
          f"iterations; solver setup {setup_s[0]:.1f} s, v0 "
          f"{setup_s[1]:.1f} s")
    print(f"  wall: {plain_s / iters * 1e3:.4f} ms/iter unprofiled, "
          f"{iter_ms:.4f} ms/iter profiled; host issue "
          f"{issue_s / iters * 1e3:.4f} ms/iter (unprofiled, before the "
          "sync)")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.4f} ms/iter device time")
    if host_us:
        print("  host us a call, alone: " + ", ".join(
            f"{k} {v:.1f}" for k, v in host_us.items()))
    for w, ms in sorted(per_launch.items()):
        print(f"  {w}: {ms:.4f} ms/launch device time, "
              f"{launches[w] / iters:g} launches/iter")
    if busy_ms:
        print(f"  device busy {busy_ms:.4f} ms/iter = "
              f"{busy_ms / iter_ms:.3f} of the profiled window; idle "
              f"{1 - busy_ms / iter_ms:.3f}")
    else:
        print("  the profiler recorded no device time: busy share not "
              "measured")
    record = {"card": card, "field": field, "n": n, "mesh": mesh,
              "host_us_per_call": host_us,
              "matrix": label, "iters": iters, "bands": bands,
              "wall_ms_per_iter": plain_s / iters * 1e3,
              "issue_ms_per_iter": issue_s / iters * 1e3,
              "profiled_ms_per_iter": iter_ms,
              "kernel_ms_per_iter": per_kernel,
              "wrapper_ms_per_launch": per_launch,
              "busy_share": busy_ms / iter_ms if busy_ms else None}
    print(json.dumps(record))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--field", choices=("narrow", "wide", "gf2"),
                    default="narrow")
    ap.add_argument("--n", type=int, nargs="+", default=None,
                    help="block widths, profiled one after another on one "
                         "matrix [default 4 narrow, 128 GF(2)]")
    ap.add_argument("--matrix", choices=("bench", "3Mx2M"), default="bench")
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations in the window [default 4096/n, GF(2) "
                         "16384/n]")
    ap.add_argument("--mesh", action="store_true",
                    help="the sharded solver's iteration on a 1 x 1 NCCL "
                         "grid (its collectives' cost on one card)")
    args = ap.parse_args(argv)
    gf2 = args.field == "gf2"

    import torch

    from block_lanczos_tpu_torch.utils import gen

    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs a CUDA device")
    t0 = time.perf_counter()
    prime = {"narrow": gen.BENCH_PRIME, "wide": gen.WIDE_BENCH_PRIME,
             "gf2": 2}[args.field]
    M = _matrix(args.matrix, prime)
    print(f"matrix {args.matrix}: {M.nrows} x {M.ncols}, {M.nnz} entries, "
          f"generated in {time.perf_counter() - t0:.1f} s")
    for n in args.n or [128 if gf2 else 4]:
        profile_width(M, args.field, n, args.matrix, args.iters, args.mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
