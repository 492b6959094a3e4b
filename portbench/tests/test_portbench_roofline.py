"""The frozen byte counts equal hand sums, and the yardstick reads
nothing of the program."""

import ast
from pathlib import Path

import pytest

from portbench import roofline, trace

HERE = Path(__file__).resolve().parents[1]


def test_spmv_bytes_by_hand():
    # 3 x 2 matrix with 4 nonzeros, n = 4, narrow: per direction 4 indices
    # and 4 values (32 bytes), in + out blocks (3 + 2) rows x 16 bytes
    assert roofline.spmv_bytes("narrow", 3, 2, 4, 4) == 2 * 32 + 2 * 5 * 16
    # GF(2), n = 128: indices only, 16 bytes a row
    assert roofline.spmv_bytes("gf2", 3, 2, 4, 128) == 2 * 16 + 2 * 5 * 16
    # wide, n = 2: 4 + 8 bytes a nonzero, 16 bytes a row
    assert roofline.spmv_bytes("wide", 3, 2, 4, 2) == 2 * 48 + 2 * 5 * 16


def test_block_bytes_by_hand():
    # N = 10, n = 4 narrow: v, Av 160 bytes each, G 8 x 4 x 4 = 128
    assert roofline.gram_bytes("narrow", 10, 4) == 320 + 128
    # v, p, Av read and v, p written (5 x 160), 8 x 8 coefficients x 4
    assert roofline.orthogonalize_bytes("narrow", 10, 4) == 800 + 256
    # GF(2), n = 64: 8 bytes a row; G 128 rows of 8 bytes; 128 x 16 coefs
    assert roofline.gram_bytes("gf2", 10, 64) == 160 + 1024
    assert roofline.orthogonalize_bytes("gf2", 10, 64) == 400 + 2048


def test_the_cells_sizes():
    # dlog 100k x 99k, 25.3M entries: 202.4 MB of matrix a direction, and
    # (100k + 99k) rows of 16 bytes at n = 4
    per_dir = roofline.spmv_bytes("narrow", 100000, 99000, 25300000, 4) / 2
    assert per_dir == 25300000 * 8 + 199000 * 16
    # GF(2) 500k x 499k, 72M entries at n = 128: indices only, 16 bytes a row
    per_dir = roofline.spmv_bytes("gf2", 500000, 499000, 72000000, 128) / 2
    assert per_dir == 72000000 * 4 + 999000 * 16
    assert roofline.bound_s(3.35e12) == 1.0


@pytest.mark.parametrize("name", ["roofline.py", "trace.py",
                                  "reference/check.py",
                                  "metrics/spmv_roofline.py",
                                  "metrics/block_roofline.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((HERE / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] == "block_lanczos_tpu_torch"
                       for n in names), (name, names)


def test_kernel_names_and_families():
    assert trace.kernel_name("void gram_mod_kernel<4, 4>(int*)") == \
        "gram_mod_kernel"
    assert trace.kernel_name("spmv_ell_kernel(int const*)") == \
        "spmv_ell_kernel"
    fam = ("spmv", "gram", "orthogonalize")
    assert trace.family_of("orthogonalize_mma_kernel", fam) == \
        "orthogonalize"
    assert trace.family_of("semi_inverse_kernel", fam) is None


def test_trace_arithmetic():
    # markers (spin_kernel) at 0 (the solve's start), 12 and 65 (block
    # syncs) and 99-100 (its end); the rest is the device's work
    t = trace.from_device_events(
        [("spmv_ell_kernel", 10, 20), ("spin_kernel(long)", 65, 65.5),
         ("gram_kernel", 15, 30), ("at::cuda::(anonymous namespace)::spin_kernel(long)", 0, 0.5),
         ("Memcpy HtoD", 50, 60), ("spin_kernel(long)", 12, 12.5),
         ("spmv_ell_kernel", 70, 75), ("spin_kernel(long)", 99, 100)])
    assert t.solve == (0, 100) and t.blocks == [12, 65]
    assert t.busy_intervals() == [(10, 30), (50, 60), (70, 75)]
    assert t.busy_us() == 35 and t.window_us() == 100
    # ops starting inside [12, 65): gram (15) and the copy (50)
    assert t.loop_device_us() == 25
    assert t.loop_device_us(("spmv",)) is None
    gaps = t.idle_gaps()
    assert gaps[0] == (trace.AFTER_LOOP, 25e-6)
    assert (trace.BEFORE_LOOP, 10e-6) in gaps
    assert (trace.LOOP, 20e-6) in gaps
    assert sum(g for _, g in gaps) == pytest.approx(65e-6)
    top = t.top_ops(2)
    assert [n for n, _ in top] == ["spmv_ell_kernel", "gram_kernel"]
    assert [s for _, s in top] == pytest.approx([15e-6, 15e-6])


def test_a_trace_without_markers_is_refused():
    with pytest.raises(RuntimeError, match="markers"):
        trace.from_device_events([("spmv_ell_kernel", 10, 20),
                                  ("spin_kernel(long)", 0, 1)])
