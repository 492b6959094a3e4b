"""One run of a benchmark cell of block_lanczos_tpu_torch on this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the cell's end-to-end metrics (--trace 0) or its per-layer metrics
(--trace 1) as the last line of standard output, one JSON object, and the
numbers compared by the reference, each beside its limit, as the last lines
of standard error.  A traffic whose grid has more than one rank runs one
process a card, and this process prints rank 0's result.  Exits 2, with no
result, when CUDA or the cell's cards are missing, when the program cannot
be imported, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "block_lanczos_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's power limit as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return {"power_limit_w": float(out.strip().splitlines()[0])}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"power_limit_w": None}


def result_line(cell, rec, metrics, harness) -> dict:
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes, **card_info()}
    out = {"correct": harness.failed(rec) == 0 and len(rec.judged) > 0,
           "attempted": len(rec.solves), "failed": harness.failed(rec),
           "metrics": metrics, "device": device}
    if rec.trace is not None:
        busy = rec.busy_us_ranks or [rec.trace.busy_us()]
        device["busy_s"] = sum(busy) / len(busy) / 1e6
        device["window_s"] = rec.trace.window_us() / 1e6
        out["breakdown"] = {
            "device_ops": rec.trace.top_ops(10),
            "idle_gaps": [list(g) for g in rec.trace.idle_gaps()[:10]]}
    out["checks"] = harness.checks(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import block_lanczos_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not here: {e}", file=sys.stderr)
        return 2
    from portbench import harness
    workdir = ROOT / "build" / "portbench" / args.workload
    ranks = harness.grid_ranks(cell.traffic)
    if ranks > 1:
        if ranks > torch.cuda.device_count():
            print(f"portbench: the grid needs {ranks} CUDA devices",
                  file=sys.stderr)
            return 2
        rec = harness.run_ranks(cell.config, cell.traffic, args.seed,
                                args.seconds, bool(args.trace),
                                [f"cuda:{k}" for k in range(ranks)],
                                T_START, workdir)
    else:
        rec = harness.run_cell(cell.config, cell.traffic, args.seed,
                               args.seconds, bool(args.trace), "cuda:0",
                               T_START, workdir)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 2
    if rec.warmup_error:
        print(f"portbench: the warm-up solve raised:\n{rec.warmup_error}",
              file=sys.stderr)
    for k, one in enumerate(rec.solves):
        if one.error:
            print(f"portbench: solve {k} raised:\n{one.error}",
                  file=sys.stderr)
        loop = one.loop()
        print(f"portbench: solve {k}: {one.t_return - one.t_call:.4f} s, "
              f"{one.iterations} iterations"
              + (f", loop {loop[0] / loop[1] * 1e3:.5f} ms/iter"
                 if loop and loop[1] else ""), file=sys.stderr)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = spec.read_metrics(entries, rec)
    out = result_line(cell, rec, metrics, harness)
    if rec.trace is not None:
        print(f"portbench: trace events {rec.trace.counts}, block markers "
              f"{len(rec.trace.blocks)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
