"""Matrix tooling CLI of the port (the JAX package's utils/matrix_tool.py,
copied onto the port's mmio, gen and checker).

    python -m block_lanczos_tpu_torch.utils.matrix_tool generate \
        --out M.mtx --nrows 300000 --ncols 200000 --row-density 15 \
        [--seed 42] [--max-value V] [--skew ALPHA]
    python -m block_lanczos_tpu_torch.utils.matrix_tool info --matrix M.mtx \
        [--prime P]
    python -m block_lanczos_tpu_torch.utils.matrix_tool check \
        --matrix M.mtx --kernel K.mtx --prime P [--right]

`generate` writes a MatrixMarket integer general file, the same bytes as
the JAX tool's for the same arguments (nrows > ncols guarantees a
nontrivial left kernel; `--skew` gives power-law column popularity);
`info` prints the header and, with `--prime`, density stats; `check` runs
the port's checker in any of its fields (narrow, wide 2^30 - 35 < p <
2^62, GF(2) at p = 2) and exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def cmd_generate(args) -> int:
    from block_lanczos_tpu_torch.utils import mmio
    from block_lanczos_tpu_torch.utils.gen import (random_sparse_skewed,
                                                   write_random_mtx)
    if args.skew:
        i, j, x = random_sparse_skewed(args.nrows, args.ncols,
                                       args.row_density, seed=args.seed,
                                       alpha=args.skew,
                                       max_value=args.max_value)
        mmio.write_coo_mtx(args.out, args.nrows, args.ncols, i, j, x)
        nnz = len(x)
    else:
        nnz = write_random_mtx(args.out, args.nrows, args.ncols,
                               args.row_density, seed=args.seed,
                               max_value=args.max_value)
    print(f"wrote {args.out}: {args.nrows} x {args.ncols}, {nnz} nnz")
    return 0


def cmd_info(args) -> int:
    from block_lanczos_tpu_torch.utils import mmio
    nrows, ncols, nnz = mmio.read_mtx_header(args.matrix)
    print(f"{args.matrix}: {nrows} x {ncols}, {nnz} nnz "
          f"({nnz / max(nrows, 1):.2f} nnz/row)")
    if args.prime:
        M = mmio.load_mtx(args.matrix, args.prime)
        counts = np.bincount(M.i, minlength=nrows)
        ccounts = np.bincount(M.j, minlength=ncols)
        print(f"  row nnz: min {counts.min()} max {counts.max()} "
              f"mean {counts.mean():.2f}")
        print(f"  col nnz: min {ccounts.min()} max {ccounts.max()} "
              f"mean {ccounts.mean():.2f}")
        print(f"  values mod {args.prime}: {int((M.x == 0).sum())} zeros")
    return 0


def cmd_check(args) -> int:
    from block_lanczos_tpu_torch.utils import checker
    try:
        checker.check_kernel_file(args.matrix, args.kernel, args.prime,
                                  right=args.right, verbose=True)
        return 0
    except checker.CheckFailure as e:
        print(str(e), file=sys.stderr)
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="matrix-tool-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate a random sparse matrix")
    g.add_argument("--out", required=True)
    g.add_argument("--nrows", type=int, required=True)
    g.add_argument("--ncols", type=int, required=True)
    g.add_argument("--row-density", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--max-value", type=int, default=1 << 20)
    g.add_argument("--skew", type=float, default=None, metavar="ALPHA",
                   help="power-law column popularity exponent "
                        "(factorization-matrix shape)")
    g.set_defaults(fn=cmd_generate)

    i = sub.add_parser("info", help="print matrix stats")
    i.add_argument("--matrix", required=True)
    i.add_argument("--prime", type=int, default=None)
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("check", help="verify a kernel block")
    c.add_argument("--matrix", required=True)
    c.add_argument("--kernel", required=True)
    c.add_argument("--prime", type=int, required=True)
    c.add_argument("--right", action="store_true")
    c.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
