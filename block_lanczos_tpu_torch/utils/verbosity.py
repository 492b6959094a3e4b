"""Progress / ETA reporting ("verbosity engine").

Reproduces the reference's behavior (reference:
sequential/lanczos_modp.c:494-529): at most one progress line per second
with seconds-per-iteration and a wall-clock ETA, plus a one-time
expected-duration print.
"""

from __future__ import annotations

import time


def format_duration(seconds: float) -> str:
    d, rem = divmod(int(seconds), 86400)
    h, rem = divmod(rem, 3600)
    m, s = divmod(rem, 60)
    parts = []
    if d:
        parts.append(f"{d} j")
    if h:
        parts.append(f"{h} h")
    if m:
        parts.append(f"{m} min")
    parts.append(f"{s} s")
    return " ".join(parts)


class VerbosityEngine:
    def __init__(self, expected_iterations: int, extra_time: float = 0.0,
                 min_interval_s: float = 1.0, out=None):
        self.expected_iterations = expected_iterations
        self.extra_time = extra_time
        self.min_interval = min_interval_s
        self.n_iterations = 0
        self._eta_printed = False
        self._last_print = 0.0
        self._out = out

    def _print(self, msg, end="\n"):
        print(msg, end=end, flush=True, file=self._out)

    def tick(self, start_time: float):
        self.n_iterations += 1
        # a solve that converges at iteration 0 has no rate to report, and
        # the reference prints no progress line either
        if self.n_iterations <= 0:
            self.n_iterations = 0
            return
        elapsed = (time.time() - start_time) + self.extra_time
        if elapsed - self._last_print < self.min_interval:
            return
        self._last_print = elapsed
        per_iteration = elapsed / self.n_iterations
        estimated = self.expected_iterations * per_iteration
        if not self._eta_printed:
            self._print(f"    - Expected duration : {format_duration(estimated)}")
            self._eta_printed = True
        eta = time.ctime(start_time + estimated)
        self._print(
            f"\r    - iteration {self.n_iterations} / "
            f"{self.expected_iterations}. {per_iteration:.3f}s per iteration. "
            f"ETA: {eta}", end="")
