"""Where the time of one narrow-field iteration goes on the CUDA device.

    python -m block_lanczos_tpu_torch.utils.profile_solve --n 4
    python -m block_lanczos_tpu_torch.utils.profile_solve --n 32

Builds the bench matrix (utils/gen.py's BENCH_* configuration, the one
bench.py and chip_smoke.py use), runs the solver's iteration on the card,
and reports for a window of 4096/n iterations (1024 at n = 4, 128 at
n = 32; the same work at every n, far from the solve's end):
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
Needs a CUDA device; prints one JSON line last.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4)
    args = ap.parse_args(argv)
    iters = 4096 // args.n

    import torch
    from torch.profiler import ProfilerActivity, profile

    from block_lanczos_tpu_torch.models import lanczos as L
    from block_lanczos_tpu_torch.ops.semi_inverse import new_state
    from block_lanczos_tpu_torch.utils import gen
    from block_lanczos_tpu_torch.utils.mmio import COOMatrix

    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs a CUDA device")
    i, j, x = gen.random_sparse(gen.BENCH_NROWS, gen.BENCH_NCOLS,
                                gen.BENCH_DENSITY, gen.BENCH_SEED)
    M = COOMatrix(gen.BENCH_NROWS, gen.BENCH_NCOLS, len(x),
                  i.astype(np.int32), j.astype(np.int32),
                  (x % gen.BENCH_PRIME).astype(np.uint32), gen.BENCH_PRIME)
    s = L.BlockLanczos(M, n=args.n)
    v = s.initial_block()
    p_blk = torch.zeros_like(v)
    state = new_state(v.device)
    ws = {}

    def run(k):
        """k iterations; returns the seconds the host took to enqueue them."""
        t0 = time.perf_counter()
        for _ in range(k):
            L.iteration_step(s.f, s.mp_rows, s.np_rows, True, s.first_op,
                             s.second_op, v, p_blk, state, ws)
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
        if dev_us and name.endswith("_kernel"):
            per_kernel[name] = per_kernel.get(name, 0.0) + dev_us / iters / 1e3
    per_launch = {}
    for name, ms in per_kernel.items():
        w = wrapper_of(name, launches)
        if w is None:   # a PyTorch kernel: in the busy time, no wrapper's
            continue
        per_launch[w] = per_launch.get(w, 0.0) + ms * iters / launches[w]
    busy_ms = sum(per_kernel.values())
    iter_ms = prof_s / iters * 1e3
    card = _card()
    print(f"card: {card}; n={args.n}, {iters} iterations")
    print(f"  wall: {plain_s / iters * 1e3:.4f} ms/iter unprofiled, "
          f"{iter_ms:.4f} ms/iter profiled; host issue "
          f"{issue_s / iters * 1e3:.4f} ms/iter (unprofiled, before the "
          "sync)")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.4f} ms/iter device time")
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
    print(json.dumps({"card": card, "n": args.n, "iters": iters,
                      "wall_ms_per_iter": plain_s / iters * 1e3,
                      "issue_ms_per_iter": issue_s / iters * 1e3,
                      "profiled_ms_per_iter": iter_ms,
                      "kernel_ms_per_iter": per_kernel,
                      "wrapper_ms_per_launch": per_launch,
                      "busy_share": busy_ms / iter_ms if busy_ms else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
