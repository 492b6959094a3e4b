"""The traced solve: device operations read from one torch.profiler
session that records the device's activity only.

The harness puts a marker on the device (`mark`: PyTorch's one-thread spin
kernel) just before the solve and just after it, and at each block sync
(the solver's on_iteration callback).  The device runs its stream in
order, so the first and last markers bound the solve, and the loop runs
from the first block marker to the last: the host syncs at each, so every
kernel of the loop's blocks starts after the first and ends before the
last.  No host event is needed, so the profiler records no operator on
the host and slows its issue by the device's activity tracing alone.
`kernel_name` and `family_of` are utils/profile_solve.py's `kernel_name`
and `wrapper_of`, copied here so that the yardstick does not move with
the program.
"""

from __future__ import annotations

import dataclasses

# the kernel torch.cuda._sleep launches, named in the trace as
# "at::cuda::(anonymous namespace)::spin_kernel(long)"
MARKER = "spin_kernel"
BEFORE_LOOP, LOOP, AFTER_LOOP = ("solve.before_loop", "solve.loop",
                                 "solve.after_loop")


def kernel_name(key: str) -> str:
    """The bare device kernel name of a profiler event key:
    "spmv_ell_kernel(...)" or "void gram_mod_kernel<4, 4>(...)" ->
    "spmv_ell_kernel", "gram_mod_kernel"."""
    return (key.split("(")[0].split("<")[0].split() or [""])[-1]


def family_of(kernel: str, families) -> str | None:
    """The family whose name is the kernel's longest prefix
    (orthogonalize_mma_kernel -> orthogonalize); None for none."""
    return max((f for f in families if kernel.startswith(f)), key=len,
               default=None)


@dataclasses.dataclass
class Trace:
    ops: list              # (name, start_us, end_us) of each device op
    solve: tuple           # (start_us, end_us): the first and last markers
    blocks: list           # start_us of each block's marker, in order
    counts: dict           # events read, by kind (for the log)

    def loop_window(self):
        """(first, last) block markers, or None without two of them."""
        return (self.blocks[0], self.blocks[-1]) if len(self.blocks) >= 2 \
            else None

    def loop_device_us(self, families=None) -> float | None:
        """Device microseconds of the ops that started inside the loop
        (all of them, or those of kernels in `families`); None when the
        loop has no two marks or no such op ran."""
        win = self.loop_window()
        if win is None:
            return None
        total, seen = 0.0, False
        for name, t0, t1 in self.ops:
            if not win[0] <= t0 < win[1]:
                continue
            if families is not None and family_of(kernel_name(name),
                                                  families) is None:
                continue
            total += t1 - t0
            seen = True
        return total if seen else None

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals within the solve,
        as sorted disjoint (start, end) pairs."""
        s0, s1 = self.solve
        spans = sorted((max(t0, s0), min(t1, s1)) for _, t0, t1 in self.ops
                       if t1 > s0 and t0 < s1)
        merged = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return [tuple(m) for m in merged]

    def busy_us(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals())

    def window_us(self) -> float:
        return self.solve[1] - self.solve[0]

    def phase_of(self, t: float) -> str:
        """The phase the host was in at t: before the first block marker, in
        the loop, or after the last."""
        if not self.blocks or t < self.blocks[0]:
            return BEFORE_LOOP
        return LOOP if t < self.blocks[-1] else AFTER_LOOP

    def idle_gaps(self) -> list:
        """(phase, seconds) of every gap in the device's work within the
        solve, longest first."""
        gaps, t = [], self.solve[0]
        for t0, t1 in self.busy_intervals() + [(self.solve[1],) * 2]:
            if t0 > t:
                gaps.append((self.phase_of(t), (t0 - t) / 1e6))
            t = max(t, t1)
        return sorted(gaps, key=lambda g: -g[1])

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the k device ops that took most time within
        the solve, by bare kernel name."""
        s0, s1 = self.solve
        by = {}
        for name, t0, t1 in self.ops:
            if t1 > s0 and t0 < s1:
                key = kernel_name(name) or name
                by[key] = by.get(key, 0.0) + (t1 - t0) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]


def mark() -> None:
    """A marker on the current CUDA stream: one spin kernel of one cycle."""
    import torch
    torch.cuda._sleep(1)


def _is_device(event) -> bool:
    return str(event.device_type()).rsplit(".", 1)[-1] in ("CUDA", "GPU")


def _times_us(event):
    if hasattr(event, "start_ns"):
        t0 = event.start_ns() / 1e3
        return t0, t0 + event.duration_ns() / 1e3
    t0 = event.start_us()
    return t0, t0 + event.duration_us()


def from_device_events(events, counts=None) -> Trace:
    """The Trace of (name, start_us, end_us) device events: the markers
    bound the solve and its blocks, the rest are the device's work."""
    ops, marks = [], []
    for name, t0, t1 in events:
        (marks if MARKER in name else ops).append((name, t0, t1))
    marks.sort(key=lambda m: m[1])
    if len(marks) < 2:
        names = sorted({kernel_name(n) or n for n, _, _ in ops})[:20]
        raise RuntimeError(f"the profiler recorded {len(marks)} markers "
                           f"among {len(ops)} device events ({counts}): "
                           f"{names}")
    return Trace(ops=ops, solve=(marks[0][1], marks[-1][2]),
                 blocks=[m[1] for m in marks[1:-1]],
                 counts=counts or {})


def collect(prof) -> Trace:
    """The Trace of a finished torch.profiler session."""
    events, counts = [], {"device": 0, "host": 0}
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            events.append((e.name(), *_times_us(e)))
            counts["device"] += 1
        else:
            counts["host"] += 1
    return from_device_events(events, counts)
