"""The port's matrix tool and profiling trace
(block_lanczos_tpu_torch/utils/matrix_tool.py, utils/profiling.py), twins
of tests/test_tools.py, on the CPU:

  * `generate` (uniform and --skew) writes the JAX tool's file byte for
    byte; `info` prints the JAX tool's lines;
  * `check` exits 0 on a valid kernel and 1 on a corrupted one in the
    narrow field, over GF(2) and in the wide field, as the JAX tool does;
  * trace writes a Chrome trace of the solve.
"""

import json
import os

import numpy as np
import pytest

from block_lanczos_tpu.utils import matrix_tool as jtool
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.models.lanczos_wide import BlockLanczosWide
from block_lanczos_tpu_torch.utils import matrix_tool, mmio, profiling

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P61 = (1 << 61) - 1


def _path(name):
    return os.path.join(GOLDEN, f"{name}.mtx")


@pytest.mark.parametrize("extra", [[], ["--skew", "1.2"],
                                   ["--seed", "7", "--max-value", "17"]],
                         ids=["uniform", "skew", "seed-and-max-value"])
def test_generate_writes_the_jax_tools_file(tmp_path, capsys, extra):
    args = ["--nrows", "50", "--ncols", "30", "--row-density", "4", *extra]
    mine, theirs = tmp_path / "mine.mtx", tmp_path / "theirs.mtx"
    assert matrix_tool.main(["generate", "--out", str(mine), *args]) == 0
    said = capsys.readouterr().out
    assert jtool.main(["generate", "--out", str(theirs), *args]) == 0
    assert said.replace("mine", "theirs") == capsys.readouterr().out
    assert mine.read_bytes() == theirs.read_bytes()
    nr, nc, nnz = mmio.read_mtx_header(str(mine))
    assert (nr, nc) == (50, 30) and nnz > 0


@pytest.mark.parametrize("prime", [None, 65537, 2])
def test_info_prints_the_jax_tools_lines(capsys, prime):
    args = ["info", "--matrix", _path("left_p65537_n4")]
    if prime is not None:
        args += ["--prime", str(prime)]
    assert matrix_tool.main(args) == 0
    mine = capsys.readouterr().out
    assert jtool.main(args) == 0
    assert mine == capsys.readouterr().out
    assert "nnz/row" in mine


def _wide_kernel(tmp_path):
    """A wide-field kernel file: left_pbig_n4 solved at 2^61 - 1."""
    M = mmio.load_mtx(_path("left_pbig_n4"), P61)
    res = BlockLanczosWide(M, n=4, device="cpu").solve()
    assert res.v_nonzero and res.product_zero
    path = str(tmp_path / "wide.kernel.mtx")
    mmio.write_kernel_mtx(path, res.kernel, M.nrows, 4)
    return path


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_check_passes_a_kernel_and_fails_a_corrupted_one(tmp_path, field):
    name, prime = {"narrow": ("left_p65537_n4", 65537),
                   "gf2": ("left_p2_n32", 2),
                   "wide": ("left_pbig_n4", P61)}[field]
    kern = (_wide_kernel(tmp_path) if field == "wide"
            else os.path.join(GOLDEN, f"{name}.kernel.mtx"))
    _, _, data = mmio.read_array_mtx(kern)
    bad = str(tmp_path / "bad.mtx")
    data = data.astype(object)
    r = int(np.argwhere(data[:, 0] != 0)[0][0])   # a row the product uses
    data[r, 0] = (data[r, 0] + 1) % prime
    dtype = np.uint64 if field == "wide" else np.uint32
    mmio.write_kernel_mtx(bad, data.astype(dtype), data.shape[0],
                          data.shape[1])
    for path, rc in ((kern, 0), (bad, 1)):
        args = ["check", "--matrix", _path(name), "--kernel", path,
                "--prime", str(prime)]
        assert matrix_tool.main(args) == rc
        assert jtool.main(args) == rc


def test_trace_writes_a_chrome_trace(tmp_path):
    M = mmio.load_mtx(_path("left_p65537_n4"), 65537)
    s = BlockLanczos(M, n=4, device="cpu")
    with profiling.trace(str(tmp_path / "t")):
        res = s.solve(stop_after=2)
    assert res.iterations == 2
    path = tmp_path / "t" / profiling.TRACE_FILE
    assert path.stat().st_size > 0
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    # the plain SpMV's scatter of the spill is in it
    assert any("index_add" in str(e.get("name", "")) for e in events)
