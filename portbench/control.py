"""The control of the correctness check: the program's kernel blocks with
one guarantee of the configuration broken, which the reference has to
fail.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--seconds <s>]

Over a prime p the control is the precision below the exact residues:
each entry of the block passed through float32 (float64 for p >= 2^31),
as a block held or updated in floating point would be.  Over GF(2), where
every bit is exact in any type, it is one bit of each block flipped at a
position drawn from the seed, in a row that has an entry.  A second
reading, `half`, zeroes the second half of each block's columns, as a
download or unpack that fills half the block would.  For each seed the
cell is set up and run for a short window at its own size, then every
block is judged as the program returned it (the lower reading), with the
control applied and with half of it zeroed (the upper readings); one JSON
line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def transform(field: str, coo, seed: int):
    """The control's `transform(kernel, k)` for harness.judge."""
    p = int(coo.prime)
    if field != "gf2":
        lower = np.float32 if p < 1 << 31 else np.float64

        def rounded(kernel, k):
            x = np.asarray(kernel).astype(np.uint64)
            return x.astype(lower).astype(np.uint64) % np.uint64(p)
        return rounded
    rows = np.unique(coo.i[(coo.x & 1) == 1])

    def flipped(kernel, k):
        rng = np.random.default_rng([int(seed), k])
        x = np.array(kernel, copy=True)
        r, c = rows[rng.integers(len(rows))], rng.integers(x.shape[1])
        x[r, c] ^= 1
        return x
    return flipped


def half_zeroed(kernel, k):
    """The block with its second half of columns zeroed."""
    x = np.array(kernel, copy=True)
    x[:, x.shape[1] // 2:] = 0
    return x


def readings(rec, coo, seed: int, device="cpu") -> dict:
    """The summed numbers of the program's blocks, of the control's and of
    the half-zeroed blocks'."""
    from portbench import harness
    out = {"solves": len(rec.solves)}
    for name, change in (("program", None),
                         ("control", transform(rec.field, coo, seed)),
                         ("half", half_zeroed)):
        harness.judge(rec, coo, change, device)
        out[name] = {k: v["value"] for k, v in harness.checks(rec).items()}
        out[f"{name}_fails"] = harness.failed(rec) > 0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, matrix, spec
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = harness.run_cell(cell.config, cell.traffic, seed,
                               args.seconds, False, "cuda:0", t0)
        coo = matrix.generate(cell.config, seed, "cuda:0")
        line = {"workload": args.workload, "seed": seed,
                **readings(rec, coo, seed, "cuda:0"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
