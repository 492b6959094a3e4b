"""Every narrow golden through the PyTorch port (CPU tensors, so the plain
versions of the four kernels): the iteration count must equal the JAX
solver's, the kernel must equal the C reference's golden block, and the
port's own checker must accept it.  `left_p2_n32` takes the GF(2)
bitsliced path: tests/test_torch_gf2_solver.py holds it.
"""

import os

import numpy as np
import pytest

from block_lanczos_tpu.models.lanczos import BlockLanczos as JaxBlockLanczos
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.utils import checker, mmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _narrow_goldens():
    with open(os.path.join(GOLDEN, "MANIFEST.txt")) as fh:
        for line in fh:
            name, prime, n, right = line.split()
            prime, n = int(prime), int(n)
            if prime == 2 and n % 32 == 0:
                continue
            yield name, prime, n, right == "True"


CONFIGS = list(_narrow_goldens())


def test_eight_narrow_goldens():
    assert len(CONFIGS) == 8


@pytest.mark.parametrize("name,prime,n,right", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_golden_matches_jax_and_reference(name, prime, n, right):
    mtx = os.path.join(GOLDEN, f"{name}.mtx")
    _, _, ref_kernel = mmio.read_array_mtx(
        os.path.join(GOLDEN, f"{name}.kernel.mtx"))
    res = BlockLanczos(mmio.load_mtx(mtx, prime), n=n, right=right,
                       device="cpu").solve()
    assert res.v_nonzero and res.product_zero
    np.testing.assert_array_equal(res.kernel.astype(np.int64), ref_kernel)
    want = JaxBlockLanczos(jmmio.load_mtx(mtx, prime), n=n,
                           right=right).solve()
    assert res.iterations == want.iterations
    assert checker.check_kernel_block(mtx, res.kernel, prime, right=right)
