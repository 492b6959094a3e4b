"""Print ptxas's resource report (registers, shared memory, spills) of the
named CUDA kernels, default all:

    python -m block_lanczos_tpu_torch.kernels [spmv_ell semi_inverse ...]

Needs nvcc (see find_nvcc); no GPU.
"""

import sys

from block_lanczos_tpu_torch.kernels import ptxas_report

if __name__ == "__main__":
    print(ptxas_report(sys.argv[1:] or None))
