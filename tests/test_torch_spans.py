"""The port's spans and counters (block_lanczos_tpu_torch/utils/profiling.py)
inside the six solvers, on the CPU:

  * under `profiling.recording()` a solve of each field, on one device and
    on a 1 x 1 gloo mesh, records exactly the named spans of its layout and
    its solve, each child inside its parent and under the parent the
    contract names, all spans of the solve sharing its id, each span with
    exactly its contract's attributes (the `solve` span's
    launches_per_iteration empty on the CPU, where no wrapper launches a
    kernel);
  * the counters: iterations_done is the iterations + 1 (the stopping
    probe), blocks the on_iteration calls, and the `block` spans' and the
    `solve` span's attributes add up to them; with sync_every fixed,
    iterations_issued is the block schedule;
  * recording off: `span()` is the shared no-op, nothing is recorded and
    the clock is not read;
  * `SolveResult.elapsed` is perf_counter's (the epoch clock may jump),
    on_iteration's `start` the epoch's;
  * checkpoint saves and loads are spans; trace(path) puts the spans into
    its Chrome trace, over the CPU ops they cover.
"""

import json
import os
import time

import numpy as np
import pytest
import torch.distributed as dist

from block_lanczos_tpu_torch.models import lanczos as tl
from block_lanczos_tpu_torch.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu_torch.models.lanczos_wide import BlockLanczosWide
from block_lanczos_tpu_torch.parallel import mesh
from block_lanczos_tpu_torch.parallel.distributed import ShardedBlockLanczos
from block_lanczos_tpu_torch.parallel.distributed_gf2 import \
    ShardedBlockLanczosGF2
from block_lanczos_tpu_torch.parallel.distributed_wide import \
    ShardedBlockLanczosWide
from block_lanczos_tpu_torch.utils import checkpoint, gen, mmio, profiling

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P61 = (1 << 61) - 1

# each named span of a solve and its parent; the field's others below
PARENT = {"layout.build": "layout", "layout.upload": "layout",
          "solve.v0": "solve", "v0.draw": "solve.v0", "v0.pack": "solve.v0",
          "v0.upload": "solve.v0", "solve.prepare": "solve",
          "solve.loop": "solve", "block": "solve.loop",
          "block.issue": "block", "block.sync": "block",
          "block.callback": "block", "solve.final": "solve",
          "final.check": "solve.final", "layout.dedup": "layout",
          "final.download": "solve.final", "final.unpack": "solve.final",
          "final.gather": "solve.final", "block.agree": "block"}
COMMON = {"layout", "layout.build", "layout.upload", "solve", "solve.v0",
          "v0.draw", "v0.pack", "v0.upload", "solve.prepare", "solve.loop",
          "block", "block.issue", "block.sync", "block.callback",
          "solve.final", "final.check"}
FIELD = {"narrow": {"final.download"},
         "gf2": {"layout.dedup", "final.download", "final.unpack"},
         "wide": {"final.download"}}
MESH = {"narrow": {"final.gather", "block.agree"},
        "gf2": {"layout.dedup", "final.gather", "final.unpack",
                "block.agree"},
        "wide": {"final.gather", "block.agree"}}
# each span's attribute names (none where unnamed); the field's others below
ATTRS = {"layout": {"field"}, "v0.draw": {"device"},
         "block": {"issued", "done"},
         "solve": {"field", "iterations", "iterations_issued",
                   "iterations_done", "blocks", "launches_per_iteration"}}
FIELD_ATTRS = {"narrow": {}, "gf2": {"final.unpack": {"device"}},
               "wide": {"layout.build": {"slab"}}}
MESH_ATTRS = {"narrow": {}, "gf2": {}, "wide": {"layout.build": {"slab"}}}


def _matrix(field):
    """(matrix, n) of a tiny solve of the field."""
    if field == "narrow":
        return mmio.load_mtx(os.path.join(GOLDEN, "left_p65537_n4.mtx"),
                             65537), 4
    if field == "gf2":
        return mmio.load_mtx(os.path.join(GOLDEN, "left_p2_n32.mtx"), 2), 32
    i, j, x = gen.random_sparse(96, 64, 5, seed=7)
    return mmio.COOMatrix(96, 64, len(i), i.astype(np.int32),
                          j.astype(np.int32),
                          (x.astype(np.uint64) % P61), P61), 4


SINGLE = {"narrow": tl.BlockLanczos, "gf2": BlockLanczosGF2,
          "wide": BlockLanczosWide}
SHARDED = {"narrow": ShardedBlockLanczos, "gf2": ShardedBlockLanczosGF2,
           "wide": ShardedBlockLanczosWide}


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def _check_tree(rec, expected):
    """Exactly the expected names recorded; each span inside its parent,
    under the parent PARENT names, with its parent's solve id; one solve id
    for the whole solve."""
    by_id = {s.id: s for s in rec.spans}
    assert {s.name for s in rec.spans} == expected, \
        {s.name for s in rec.spans} ^ expected
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.solve == s.id
            continue
        up = by_id[s.parent]
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, s
        assert s.solve == up.solve
        if s.name in PARENT:
            assert up.name == PARENT[s.name], (s.name, up.name)
    (solve,) = _named(rec, "solve")
    under = [s for s in rec.spans if s.name.split(".")[0] in
             ("solve", "v0", "block", "final")]
    assert {s.solve for s in under} == {solve.id}


def _check_attrs(rec, field_attrs):
    """Each span's attribute names those of ATTRS and the field's, and no
    other; the `solve` span launches no wrapper on the CPU."""
    want = dict(ATTRS, **field_attrs)
    for s in rec.spans:
        assert set(s.attrs) == want.get(s.name, set()), (s.name, s.attrs)
    (solve,) = _named(rec, "solve")
    assert set(solve.attrs["launches_per_iteration"]) == set()


def _check_counters(rec, res, calls):
    c = rec.counters
    assert c["iterations_done"] == res.iterations + 1     # the probe
    assert c["blocks"] == calls == len(_named(rec, "block"))
    blocks = _named(rec, "block")
    assert sum(b.attrs["issued"] for b in blocks) == c["iterations_issued"]
    assert sum(b.attrs["done"] for b in blocks) == c["iterations_done"]
    (solve,) = _named(rec, "solve")
    assert solve.attrs["iterations"] == res.iterations
    assert solve.attrs["iterations_issued"] == c["iterations_issued"]
    assert solve.attrs["iterations_done"] == c["iterations_done"]
    assert solve.attrs["blocks"] == c["blocks"]
    assert isinstance(solve.attrs["launches_per_iteration"], dict)
    assert c["iterations_issued"] >= c["iterations_done"]


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_one_device_solve_records_every_span_and_counter(field):
    M, n = _matrix(field)
    calls = []
    with profiling.recording() as rec:
        s = SINGLE[field](M, n=n, device="cpu")
        res = s.solve(on_iteration=lambda *a: calls.append(a[1]))
    assert res.v_nonzero and res.product_zero
    _check_tree(rec, COMMON | FIELD[field])
    _check_attrs(rec, FIELD_ATTRS[field])
    _check_counters(rec, res, len(calls))


@pytest.mark.parametrize("field", ["narrow", "gf2", "wide"])
def test_mesh_solve_records_every_span_and_counter(field, tmp_path):
    M, n = _matrix(field)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        grid = mesh.make_grid(1, 1, "cpu")
        calls = []
        with profiling.recording() as rec:
            s = SHARDED[field](M, n=n, grid=grid)
            res = s.solve(on_iteration=lambda *a: calls.append(a[1]))
    finally:
        dist.destroy_process_group()
    assert res.v_nonzero and res.product_zero
    _check_tree(rec, COMMON - {"final.download"} | MESH[field])
    _check_attrs(rec, MESH_ATTRS[field])
    _check_counters(rec, res, len(calls))
    # the single-device solver runs the same iterations
    with profiling.recording() as one:
        SINGLE[field](M, n=n, device="cpu").solve()
    assert one.counters["iterations_done"] == rec.counters["iterations_done"]


@pytest.mark.parametrize("sync_every,stop_after", [(3, 10), (4, -1)],
                         ids=["stopped-3-3-3-1", "converged-blocks-of-4"])
def test_iterations_issued_follows_the_fixed_schedule(sync_every,
                                                       stop_after):
    M, n = _matrix("narrow")
    with profiling.recording() as rec:
        res = tl.BlockLanczos(M, n=n, sync_every=sync_every,
                              device="cpu").solve(stop_after=stop_after)
    issued = [b.attrs["issued"] for b in sorted(_named(rec, "block"))]
    if stop_after > 0:
        assert res.stopped_by_limit and res.iterations == 10
        assert issued == [3, 3, 3, 1]
        assert rec.counters["iterations_done"] == 10
    else:       # the probe ends the last block of 4: ceil((I + 1) / 4)
        blocks = -(-(res.iterations + 1) // 4)
        assert issued == [4] * blocks
        assert rec.counters["iterations_done"] == res.iterations + 1
    assert rec.counters["iterations_issued"] == sum(issued)
    assert rec.counters["blocks"] == len(issued)


def test_recording_off_records_nothing_and_reads_no_clock(monkeypatch):
    M, n = _matrix("gf2")

    def no_clock():
        raise AssertionError("a span read the clock with recording off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    sp = profiling.span("solve", field="narrow")
    assert sp is profiling.NOOP and profiling.span("block") is sp
    with sp as inner:
        inner.set(iterations=1)
    assert profiling.count("blocks", 3) is None
    res = BlockLanczosGF2(M, n=n, device="cpu").solve(stop_after=3)
    assert res.iterations == 3
    monkeypatch.undo()
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_nested_recording_and_a_raising_span():
    with profiling.recording() as outer:
        with profiling.span("a"):
            with profiling.recording() as inner:
                with profiling.span("b"):
                    profiling.count("k", 2)
            with pytest.raises(ValueError):
                with profiling.span("c", x=1):
                    raise ValueError
        profiling.count("k")
    assert [s.name for s in inner.spans] == ["b"] and \
        inner.counters == {"k": 2}
    assert [s.name for s in outer.spans] == ["c", "a"]
    c, a = outer.spans
    assert c.parent == a.id and c.solve == a.id and c.attrs == {"x": 1}
    assert outer.counters == {"k": 1}
    assert profiling.span("d") is profiling.NOOP


def test_elapsed_is_perf_counters_and_start_the_epochs(monkeypatch):
    M, n = _matrix("narrow")
    real = time.time
    jumps = iter(range(1, 10 ** 6))

    def jumping():              # the epoch clock stepped by NTP, say
        return real() + 3600.0 * next(jumps)

    starts = []
    monkeypatch.setattr(time, "time", jumping)
    res = tl.BlockLanczos(M, n=n, device="cpu").solve(
        on_iteration=lambda *a: starts.append(a[-1]))
    monkeypatch.undo()
    assert 0 < res.elapsed < 600
    assert starts and len(set(starts)) == 1
    assert starts[0] > real() + 1800      # the loop's epoch start


def test_checkpoint_save_and_load_are_spans(tmp_path):
    M, n = _matrix("narrow")
    s = tl.BlockLanczos(M, n=n, sync_every=2, device="cpu")
    mgr = checkpoint.CheckpointManager(str(tmp_path), interval_s=0.0,
                                       solver=s)

    def save(solver, iteration, v, p_blk, start):
        mgr.maybe_save(iteration, v, p_blk, start)

    with profiling.recording() as rec:
        s.solve(stop_after=4, on_iteration=save)
        state = checkpoint.load_checkpoint(str(tmp_path))
    saves = _named(rec, "checkpoint.save")
    assert len(saves) == mgr.saves >= 1
    by_id = {x.id: x for x in rec.spans}
    assert all(by_id[x.parent].name == "block.callback" for x in saves)
    assert saves[-1].attrs["iteration"] == state["iteration"] == 4
    (load,) = _named(rec, "checkpoint.load")
    assert load.parent is None


def test_trace_writes_the_spans_over_the_ops_they_cover(tmp_path):
    M, n = _matrix("narrow")
    s = tl.BlockLanczos(M, n=n, device="cpu")
    with profiling.trace(str(tmp_path / "t")):
        res = s.solve(stop_after=3)
    assert res.iterations == 3
    with open(tmp_path / "t" / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert {"solve", "solve.loop", "block", "block.issue",
            "block.sync"} <= set(spans)
    assert spans["solve"]["args"]["iterations_issued"] == 3
    loop = spans["solve.loop"]
    # the plain SpMV's scatters run inside the loop's span on one clock
    ops = [e for e in events if e.get("ph") == "X"
           and "index_add" in str(e.get("name", ""))]
    assert ops
    slack = 500.0     # us: the anchor's placement
    assert all(loop["ts"] - slack <= e["ts"] and
               e["ts"] + e["dur"] <= loop["ts"] + loop["dur"] + slack
               for e in ops)
