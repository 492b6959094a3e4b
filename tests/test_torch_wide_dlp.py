"""The benchmark's discrete-log configuration on the wide field
(portbench/configs/dlog-dlp240-p61.json): DLP-240's density with signed
coefficients in [-2^20, 2^20) held mod 2^61 - 1, at small sizes on the CPU
(the plain versions of the wide kernels):

  * the generator holds a coefficient -k as the residue p - k;
  * BlockLanczosWide's kernel blocks, at n = 4 and 32 and with zero
    entries stored on purpose, pass the benchmark's plain reference with
    every number 0, and the control's blocks (float64 residues, half the
    columns zeroed) fail it;
  * the same COO (negative residues, explicit zeros) gives the port and
    the JAX package's wide solver equal (v, p) at every iteration and an
    equal kernel;
  * layout.build's `slab` and the counters wide_slab_int32_ops /
    wide_slab_int64_ops, on one device and on a 1 x 1 mesh;
  * the cell dlp240-p61-n32 loads as a wide cell with its six per-layer
    metrics.
"""

import json
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from block_lanczos_tpu.models import lanczos_wide as jlw
from block_lanczos_tpu.ops import gfp_wide as jgw
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch.models import lanczos_wide as tlw
from block_lanczos_tpu_torch.ops import semi_inverse as tsi
from block_lanczos_tpu_torch.parallel import mesh
from block_lanczos_tpu_torch.parallel.distributed_wide import \
    ShardedBlockLanczosWide
from block_lanczos_tpu_torch.utils import mmio as tmmio
from block_lanczos_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import control, harness, matrix, spec  # noqa: E402
from portbench.reference import check  # noqa: E402

CONFIG = json.loads(
    (ROOT / "portbench" / "configs" / "dlog-dlp240-p61.json").read_text())
P = CONFIG["prime"]
SEED = 2**31 + 61
CLEAN = {"shape_bad": 0, "zero_columns": 0, "xM_nonzero": 0}


def small(nrows: int, ncols: int, draws: int) -> dict:
    """The configuration's law (prime, values) at a small shape."""
    return dict(CONFIG, nrows=nrows, ncols=ncols, row_draws=draws)


def with_zeros(coo: matrix.Coo, every: int) -> matrix.Coo:
    """The COO with every `every`-th entry's value set to 0, the entry
    kept (stored zeros, as the generator makes about 1 in 2^21)."""
    x = coo.x.copy()
    x[::every] = 0
    return matrix.Coo(coo.nrows, coo.ncols, coo.i, coo.j, x, coo.prime)


def torch_matrix(coo: matrix.Coo) -> tmmio.COOMatrix:
    return tmmio.COOMatrix(coo.nrows, coo.ncols, coo.nnz, coo.i, coo.j,
                           coo.x, coo.prime)


def test_config_is_the_wide_field_at_dlp240_density():
    assert CONFIG["field"] == "wide" == harness.field_of(P)
    assert P == (1 << 61) - 1
    assert CONFIG["row_draws"] == 253
    assert (CONFIG["value_low"], CONFIG["value_high"]) == (-(1 << 20),
                                                           1 << 20)
    assert CONFIG["solver"].endswith("lanczos_wide:BlockLanczosWide")
    assert CONFIG["mesh_solver"].endswith(
        "distributed_wide:ShardedBlockLanczosWide")


def test_generator_holds_negative_coefficients_as_p_minus_k():
    conf = small(400, 300, 40)
    coo = matrix.generate(conf, SEED, "cpu")
    assert coo.x.dtype == np.uint64 and coo.prime == P
    # the generator's draws again: columns first, then the values
    g = torch.Generator(device="cpu")
    g.manual_seed(SEED)
    torch.randint(0, conf["ncols"], (conf["nrows"] * conf["row_draws"],),
                  generator=g, dtype=torch.int64)
    drawn = torch.randint(conf["value_low"], conf["value_high"],
                          (coo.nnz,), generator=g,
                          dtype=torch.int64).numpy()
    want = np.array([v + P if v < 0 else v for v in drawn.tolist()],
                    dtype=np.uint64)
    np.testing.assert_array_equal(coo.x, want)
    assert (drawn < 0).sum() > coo.nnz // 3
    neg = coo.x > P // 2
    assert (P - coo.x[neg] <= 1 << 20).all() and (coo.x[~neg] < 1 << 20).all()
    # the narrow configuration's matrix of the same seed and shape has the
    # same entries: the columns are drawn before the values
    narrow_conf = json.loads((ROOT / "portbench" / "configs" /
                              "dlog-dlp240-p30.json").read_text())
    other = matrix.generate(dict(narrow_conf, nrows=400, ncols=300,
                                 row_draws=40), SEED, "cpu")
    np.testing.assert_array_equal(other.i, coo.i)
    np.testing.assert_array_equal(other.j, coo.j)


@pytest.mark.parametrize("n,shape,zeros", [
    (4, (240, 200, 10), 0),
    (32, (300, 250, 12), 0),
    (4, (240, 200, 10), 7),
], ids=["n4", "n32", "n4-stored-zeros"])
def test_blocks_pass_the_reference_and_the_control_fails(n, shape, zeros):
    coo = matrix.generate(small(*shape), SEED + n, "cpu")
    if zeros:
        coo = with_zeros(coo, zeros)
        assert (coo.x == 0).sum() == -(-coo.nnz // zeros)
    res = tlw.BlockLanczosWide(torch_matrix(coo), n=n, device="cpu").solve()
    assert res.v_nonzero and res.product_zero and not res.stopped_by_limit
    e = check.prepare(coo.nrows, coo.ncols, coo.i, coo.j, coo.x, P)
    assert len(e.vals) == np.count_nonzero(coo.x)     # zeros dropped
    assert check.judge(e, res.kernel) == CLEAN
    rounded = control.transform("wide", coo, SEED)(res.kernel, 0)
    assert check.judge(e, rounded)["xM_nonzero"] > 0
    assert check.judge(e, control.half_zeroed(res.kernel, 0)) == dict(
        CLEAN, zero_columns=n - n // 2)


def _unpair(a):
    return jgw.np_unpair(np.asarray(a)).astype(np.int64)


def test_iterates_and_kernel_match_jax_on_signed_residues_and_zeros():
    coo = with_zeros(matrix.generate(small(96, 72, 6), SEED, "cpu"), 11)
    assert (coo.x > P // 2).any() and (coo.x == 0).any()
    n = 4
    jm = jmmio.COOMatrix(coo.nrows, coo.ncols, coo.nnz, coo.i, coo.j, coo.x,
                         P)
    js = jlw.BlockLanczosWide(jm, n=n)
    step = jax.jit(partial(jlw.iteration_step, js.f, js.mp_rows, js.np_rows,
                           True))
    ts = tlw.BlockLanczosWide(torch_matrix(coo), n=n, device="cpu")
    jv = js.initial_block()
    jp = jnp.zeros((js.np_rows, n, 2), jnp.uint32)
    v = ts.initial_block()
    np.testing.assert_array_equal(v.numpy(), _unpair(jv))
    p = torch.zeros_like(v)
    state = tsi.new_state("cpu")
    for it in range(6):
        jv, jp = step(js.first_op, js.second_op, jv, jp)[:2]
        tlw.iteration_step(ts.f, ts.mp_rows, ts.np_rows, True, ts.first_op,
                           ts.second_op, v, p, state)
        np.testing.assert_array_equal(v.numpy(), _unpair(jv),
                                      err_msg=f"v, iteration {it}")
        np.testing.assert_array_equal(p.numpy(), _unpair(jp),
                                      err_msg=f"p, iteration {it}")
    want = jlw.BlockLanczosWide(jm, n=n).solve()
    got = tlw.BlockLanczosWide(torch_matrix(coo), n=n, device="cpu").solve()
    assert want.v_nonzero and want.product_zero
    assert got.iterations == want.iterations
    np.testing.assert_array_equal(got.kernel,
                                  np.asarray(want.kernel).astype(np.uint64))


def _layout(rec):
    (build,) = [s for s in rec.spans if s.name == "layout.build"]
    return build.attrs, rec.counters


@pytest.fixture
def one_rank(tmp_path):
    """A world of this one process and its 1 x 1 grid on the CPU."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield mesh.make_grid(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


def _full_width(coo: matrix.Coo) -> matrix.Coo:
    """The COO with one full-width residue, which no int32 holds."""
    x = coo.x.copy()
    x[len(x) // 2] = P // 3
    return matrix.Coo(coo.nrows, coo.ncols, coo.i, coo.j, x, coo.prime)


@pytest.mark.parametrize("wide_value", [False, True],
                         ids=["signed-law", "one-full-width-residue"])
@pytest.mark.parametrize("right", [False, True], ids=["left", "right"])
def test_one_device_layout_names_its_slab(wide_value, right):
    coo = with_zeros(matrix.generate(small(120, 90, 8), SEED, "cpu"), 13)
    if wide_value:
        coo = _full_width(coo)
    slab = "int64" if wide_value else "int32"
    with profiling.recording() as rec:
        s = tlw.BlockLanczosWide(torch_matrix(coo), n=4, right=right,
                                 device="cpu")
    attrs, counters = _layout(rec)
    assert attrs == {"slab": (slab, slab)}
    assert counters == {f"wide_slab_{slab}_ops": 2}
    want = torch.int64 if wide_value else torch.int32
    assert s.first_op.vals.dtype == s.second_op.vals.dtype == want
    # recording off: the same layout, nothing counted
    assert tlw.BlockLanczosWide(torch_matrix(coo), n=4,
                                device="cpu").sp.fwd.vals.dtype == want


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["mesh", "mesh-overlap"])
@pytest.mark.parametrize("wide_value", [False, True],
                         ids=["signed-law", "one-full-width-residue"])
def test_mesh_layout_names_its_slab(one_rank, wide_value, overlap):
    coo = matrix.generate(small(160, 120, 8), SEED, "cpu")
    if wide_value:
        coo = _full_width(coo)
    with profiling.recording() as rec:
        ShardedBlockLanczosWide(torch_matrix(coo), n=4, grid=one_rank,
                                overlap=overlap)
    attrs, counters = _layout(rec)
    ops = 4 if overlap else 2
    if not wide_value:
        assert attrs == {"slab": ("int32", "int32")}
        assert counters == {"wide_slab_int32_ops": ops}
        return
    # the full-width residue lies in one row chunk of each direction: a
    # direction with any operator on the int64 slab reads "int64"
    assert attrs == {"slab": ("int64", "int64")}
    assert counters["wide_slab_int64_ops"] == 2
    assert sum(counters.values()) == ops


def test_cell_loads_as_a_wide_cell_with_its_per_layer_metrics():
    cell = spec.load("dlp240-p61-n32")
    assert cell.chips == 1
    assert cell.config["field"] == "wide" == harness.field_of(
        cell.config["prime"])
    assert cell.traffic["n"] == 32 and cell.traffic["name"] == "solves-n32"
    assert {m["name"] for m in cell.end_to_end} == {"solve_s", "iter_ms",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "layout_s", "v0_s", "device_ms_per_iter", "spmv_roofline",
        "block_roofline", "idle_share"}
    narrow = spec.load("dlp240-p30-n32")
    # the same pattern per seed: only the values and the field differ
    for key in ("nrows", "ncols", "row_draws"):
        assert cell.config[key] == narrow.config[key]
