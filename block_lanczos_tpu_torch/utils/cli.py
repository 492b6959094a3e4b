"""Solver command-line interface of the port (the narrow field, the wide
field and bitsliced GF(2), one device).

Flag-compatible with the JAX package's CLI for the part this port covers
(reference: sequential/lanczos_modp.c:124-194):

    lanczos-modp-torch --matrix M.mtx --prime 65537 --n 4
                       [--output-file K.mtx] [--right | --left]
                       [--stop-after N] [--no-checks] [--sync-every K]
                       [--salvage [--salvage-restarts K]] [--no-dedup]
                       [--device cuda|cpu] [--single]

p = 2 with n % 32 == 0 selects the bitsliced GF(2) solver, 2^30 - 35 < p <
2^62 the wide field (as in the JAX package's CLI; p >= 2^62 exits 1), every
other p the narrow field.  Runs on the CUDA device by default and exits
with an error when there is none; `--device cpu` runs the plain PyTorch
versions of the kernels.  `--single` is accepted and changes nothing: the
port always runs on one device.  Exit code 2, before the matrix is loaded,
for what this port does not cover yet: the mesh, multi-host, overlap and
checkpoint flags; and block widths above the kernels' caps, n <= 64 in the
narrow and the wide field and, on CUDA, n <= 512 over GF(2).
"""

from __future__ import annotations

import argparse
import sys

from block_lanczos_tpu_torch.ops import gf2
from block_lanczos_tpu_torch.ops import semi_inverse as narrow
from block_lanczos_tpu_torch.ops import wide_ops as wide
from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP
from block_lanczos_tpu_torch.ops.gfp_wide import WIDE_PRIME_CAP
from block_lanczos_tpu_torch.utils import mmio
from block_lanczos_tpu_torch.utils.verbosity import VerbosityEngine

# flags of the JAX package's CLI that select paths this port does not have:
# dest -> (flag, the value that selects none of them)
REFUSED_FLAGS = {
    "devices": ("--devices", None), "grid": ("--grid", None),
    "overlap": ("--overlap", False), "checkpoint": ("--checkpoint", None),
    "load_checkpoint": ("--load-checkpoint", False),
    "checkpoint_dir": ("--checkpoint-dir", None),
    "coordinator": ("--coordinator", None),
    "num_processes": ("--num-processes", 1),
    "process_id": ("--process-id", 0),
    "local_devices": ("--local-devices", None),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lanczos-modp-torch",
        description="block Lanczos kernel vectors of a sparse matrix mod p "
                    "(PyTorch + CUDA, p < 2^62 and GF(2), one device)")
    ap.add_argument("--matrix", required=True,
                    help="MatrixMarket file containing the sparse matrix")
    ap.add_argument("--prime", required=True, type=int,
                    help="compute modulo P (P < 2^62; P > 2^30 - 35 "
                         "takes the wide field)")
    ap.add_argument("--n", type=int, default=1,
                    help=f"blocking factor [default 1]; this port takes "
                         f"n <= {narrow.MAX_N} in the narrow field, "
                         f"n <= {wide.MAX_N} in the wide field and, on "
                         f"CUDA, n <= {gf2.MAX_N} over GF(2)")
    ap.add_argument("--output-file",
                    help="store the block of kernel vectors")
    ap.add_argument("--right", action="store_true",
                    help="compute right kernel vectors")
    ap.add_argument("--left", action="store_true",
                    help="compute left kernel vectors [default]")
    ap.add_argument("--stop-after", type=int, default=-1,
                    help="stop the algorithm after N iterations")
    ap.add_argument("--no-checks", action="store_true",
                    help="disable per-iteration invariant checks")
    ap.add_argument("--sync-every", type=int, default=None, metavar="K",
                    help="iterations per host sync; default: adaptive "
                         "doubling up to 1024")
    ap.add_argument("--salvage", action="store_true",
                    help="on a failed final check, extract the verified "
                         "kernel combinations from the partial block "
                         "(the reference just reports KO)")
    ap.add_argument("--salvage-restarts", type=int, default=0, metavar="K",
                    help="with --salvage: if the salvaged yield is short of "
                         "n, re-solve up to K times with fresh random blocks "
                         "(the xoshiro stream continues) and combine the "
                         "exactly-independent verified vectors across runs")
    ap.add_argument("--no-dedup", action="store_true",
                    help="GF(2) only: keep duplicate/empty operator lines "
                         "verbatim like the reference (default: drop "
                         "duplicates to restore rank(A) on structured "
                         "instances; a no-op on duplicate-free matrices)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the CUDA device [default] or on the CPU "
                         "(plain PyTorch versions of the kernels)")
    ap.add_argument("--single", action="store_true",
                    help="solve on a single device (a no-op: this port "
                         "always runs on one device)")
    unsupported = ap.add_argument_group(
        "not supported by this port yet (refused with exit code 2; "
        "--num-processes 1 and --process-id 0 are accepted)")
    unsupported.add_argument("--devices", type=int, default=None)
    unsupported.add_argument("--grid", type=int, nargs=2, default=None,
                             metavar=("R", "C"))
    unsupported.add_argument("--overlap", action="store_true")
    unsupported.add_argument("--checkpoint", nargs="?", const=60.0,
                             type=float, default=None, metavar="SECONDS")
    unsupported.add_argument("--load-checkpoint", action="store_true")
    unsupported.add_argument("--checkpoint-dir", default=None)
    unsupported.add_argument("--coordinator", default=None,
                             metavar="HOST:PORT")
    unsupported.add_argument("--num-processes", type=int, default=1)
    unsupported.add_argument("--process-id", type=int, default=0)
    unsupported.add_argument("--local-devices", type=int, default=None)
    return ap


def _refusal(args) -> str | None:
    for dest, (flag, default) in REFUSED_FLAGS.items():
        if getattr(args, dest) != default:
            return f"{flag} is not supported by this port yet"
    if args.prime > PRIME_CAP:
        if args.n > wide.MAX_N:
            return (f"n = {args.n} is above the wide field's cap of n <= "
                    f"{wide.MAX_N}: not supported by this port yet")
    elif args.prime == 2 and args.n % 32 == 0:
        if args.device == "cuda" and args.n > gf2.MAX_N:
            return (f"n = {args.n} is above the GF(2) kernels' cap of n <= "
                    f"{gf2.MAX_N}: not supported by this port yet")
    elif args.n > narrow.MAX_N:
        return (f"n = {args.n} is above the narrow field's cap of n <= "
                f"{narrow.MAX_N}: not supported by this port yet")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.prime > WIDE_PRIME_CAP:
        # the reference stops at 2^30 - 35; the JAX package at 2^62
        print(f"p is capped at 2**62 - 1 (got {args.prime})",
              file=sys.stderr)
        return 1
    reason = _refusal(args)
    if reason is not None:
        print(reason, file=sys.stderr)
        return 2
    if args.output_file and args.stop_after > 0:
        print("--stop-after and --output-file are mutually exclusive",
              file=sys.stderr)
        return 1
    right = args.right and not args.left

    try:
        M = mmio.load_mtx(args.matrix, args.prime, verbose=True)
    except (OSError, ValueError) as e:
        print(f"cannot load matrix {args.matrix}: {e}", file=sys.stderr)
        return 1
    print(f"  - {M.nrows} x {M.ncols} with {M.nnz} nz", file=sys.stderr)

    try:
        if args.prime > PRIME_CAP:
            print("  - wide field (p > 2^30): native 64-bit residues",
                  file=sys.stderr)
            from block_lanczos_tpu_torch.models.lanczos_wide import \
                BlockLanczosWide
            solver = BlockLanczosWide(M, n=args.n, right=right,
                                      check_invariants=not args.no_checks,
                                      sync_every=args.sync_every,
                                      device=args.device)
        elif args.prime == 2 and args.n % 32 == 0:
            # the factorization case: bitsliced GF(2), 32 elements per word
            print("  - GF(2) bitsliced path (p = 2, n % 32 == 0)",
                  file=sys.stderr)
            from block_lanczos_tpu_torch.models.lanczos_gf2 import \
                BlockLanczosGF2
            solver = BlockLanczosGF2(M, n=args.n, right=right,
                                     check_invariants=not args.no_checks,
                                     sync_every=args.sync_every,
                                     dedup=not args.no_dedup,
                                     device=args.device)
        else:
            from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
            solver = BlockLanczos(M, n=args.n, right=right,
                                  check_invariants=not args.no_checks,
                                  sync_every=args.sync_every,
                                  device=args.device)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1

    verb = VerbosityEngine(solver.expected_iterations)

    def on_iteration(slv, iteration, v, p_blk, start):
        verb.n_iterations = max(iteration - 1, 0)
        if iteration > 0:
            verb.tick(start)

    res = solver.solve(stop_after=args.stop_after, verbose=True,
                       on_iteration=on_iteration)
    print()
    kernel, n_cols = res.kernel, args.n
    if args.salvage and res.product_zero is False and res.vtM is not None:
        from block_lanczos_tpu_torch.utils.salvage import (
            salvage_kernel, salvage_with_restarts)
        if args.salvage_restarts > 0:
            salvaged = salvage_with_restarts(
                lambda: solver.solve(stop_after=args.stop_after,
                                     verbose=True),
                res, args.prime, args.n, restarts=args.salvage_restarts,
                verbose=True)
        else:
            salvaged = salvage_kernel(res.kernel, res.vtM, args.prime)
            print(f"Salvage: recovered {salvaged.shape[1]} / {args.n} "
                  "verified kernel vectors from the partially-converged "
                  "block")
        if salvaged.shape[1] == 0:
            print("Salvage found no kernel vectors", file=sys.stderr)
            return 1
        kernel, n_cols = salvaged, salvaged.shape[1]
    if args.output_file:
        print(f"Saving result in {args.output_file}")
        mmio.write_kernel_mtx(args.output_file, kernel, solver.n_eff, n_cols)
    else:
        print("Not saving result (no --output given)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
