"""Tracing of the port: spans and counters recorded inside the solvers, and
a Chrome trace that puts them beside the device's kernels.

  * `span(name, **attrs)`: a context manager around one piece of a layer's
    work (the contract of names is below).  Each span records its name,
    start and end (`time.perf_counter_ns()`), its parent's id and its solve
    id: the id of its outermost span, so that every span of one `solve()`
    call shares the `solve` span's id.  `.set(**attrs)` adds attributes
    before it closes.
  * `count(name, k=1)`: adds k to a counter.
  * `recording()`: turns both on for a block and yields the in-memory
    buffer (a `Recording`: its spans as `Span` tuples, in the order they
    closed, and its counters); nothing is written until the caller asks.
    With recording off `span()` returns the one shared no-op `NOOP` and
    `count()` returns at once: one global read a call, no clock read.
  * `trace(path)`: torch.profiler around the block (the CPU and, where
    CUDA is available, the card's kernels) with recording on; writes a
    Chrome trace, `path/trace.json`, viewable in Perfetto or
    chrome://tracing, with the spans as a host track of their own.

The solvers record these spans, each under the one it is indented under:

    layout, with layout.dedup, layout.build, layout.upload    constructors
    solve                                                     every solve()
      solve.v0, with v0.draw (attribute device), and on the   v0 from xoshiro
        CPU v0.pack, v0.upload
      solve.resume                                            a resume_state
      solve.prepare                                           kernels, state
      solve.loop                                              the blocks
        block, with block.issue, block.sync, block.callback,
        and on a mesh block.agree
      solve.final, with final.download (a mesh: final.gather),
        final.unpack, final.check
    checkpoint.save (in a block.callback that saves), checkpoint.load

and the counters iterations_issued, iterations_done (the stopping probe
included) and blocks (models/lanczos.py::blocked_solve_loop),
v0_draws_device, the v0 draws made on the card (ops/xoshiro.py::LaneDraw;
the single-device solvers on CUDA: v0.draw's device "cuda"), and
wide_slab_int32_ops / wide_slab_int64_ops, the wide operators built on
each slab (ops/wide_ops.py::make_wide_op); the wide solvers' layout.build
names each direction's slab, "int32" or "int64", in its attribute slab
(first product, second).  Spans
never wait for the device: `block.issue` ends when the host has issued the
block's launches, so a full launch queue shows inside it, and the device's
time shows in `block.sync`.  Nothing is recorded finer than a block of
iterations: no span, counter or clock read inside an iteration, a kernel
wrapper or a collective.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import torch

TRACE_FILE = "trace.json"
# the record_function that ties perf_counter to the profiler's clock
ANCHOR = "profiling.anchor"


class Span(NamedTuple):
    """One closed span; `solve` is the id of its outermost span."""
    id: int
    parent: int | None
    solve: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class Recording:
    """The buffer of one `recording()` block: `spans`, a Span a closed
    span, and `counters`, {name: total}."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._open = []       # the open spans, innermost last
        self._next_id = 0


class _OpenSpan:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "solve", "t0")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        rec = self.rec
        self.id = rec._next_id
        rec._next_id += 1
        outer = rec._open[-1] if rec._open else None
        self.parent = None if outer is None else outer.id
        self.solve = self.id if outer is None else outer.solve
        rec._open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._open.remove(self)
        rec.spans.append(Span(self.id, self.parent, self.solve, self.name,
                              self.t0, t1, self.attrs))
        return False


class _NoSpan:
    """The span of recording off: records nothing."""
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()
_active: Recording | None = None      # recording() sets it for its block


def span(name: str, **attrs):
    """A span of `name` (a context manager), or NOOP with recording off."""
    rec = _active
    if rec is None:
        return NOOP
    return _OpenSpan(rec, name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add k to the counter `name` (nothing with recording off)."""
    rec = _active
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + k


@contextlib.contextmanager
def recording():
    """Record spans and counters for the block; yields the Recording.  A
    recording() inside another takes its block's spans for itself."""
    global _active
    outer, _active = _active, Recording()
    try:
        yield _active
    finally:
        _active = outer


def _anchor_ns() -> int:
    """A record_function of the profiler at this perf_counter_ns (the
    midpoint of the stamps around it); warmed first, so that its entry
    costs microseconds."""
    from torch.profiler import record_function
    with record_function(ANCHOR + ".warm"):
        pass
    t0 = time.perf_counter_ns()
    with record_function(ANCHOR):
        pass
    return (t0 + time.perf_counter_ns()) // 2


def _span_events(rec: Recording, offset_us: float, pid: int) -> list:
    """The spans as complete events of the host track `pid`, on the
    trace's clock (microseconds = perf_counter_ns / 1e3 + offset_us)."""
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": "block_lanczos spans"}}]
    for s in rec.spans:
        args = {"id": s.id, "parent": s.parent, "solve": s.solve,
                **s.attrs}
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": 0, "ts": s.start_ns / 1e3 + offset_us,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(path: str):
    """Profile the block with recording on and write its Chrome trace to
    path/trace.json, the spans on a host track of their own; yields the
    torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    prof = profile(activities=activities)
    with recording() as rec:
        prof.start()
        anchor_ns = _anchor_ns()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            _export(prof, os.path.join(path, TRACE_FILE), rec, anchor_ns)


def _export(prof, out: str, rec: Recording, anchor_ns: int) -> None:
    """The profiler's Chrome trace at `out`, with the spans of `rec` on a
    host track placed by the anchor."""
    prof.export_chrome_trace(out)
    with open(out) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    anchor = next(e for e in events if e.get("name") == ANCHOR
                  and e.get("ph") == "X")
    offset_us = anchor["ts"] + anchor.get("dur", 0) / 2 - anchor_ns / 1e3
    pid = max((e["pid"] for e in events if isinstance(e.get("pid"), int)),
              default=0) + 1
    events.extend(_span_events(rec, offset_us, pid))
    with open(out, "w") as fh:
        json.dump(doc, fh, default=str)
