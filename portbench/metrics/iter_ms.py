"""iter_ms: the loop time of every solve in the window (first block's
callback to the last one's, host clock) over the iterations between
them, in ms."""


def read(rec):
    loops = [s.loop() for s in rec.solves if s.loop() is not None]
    iters = sum(i for _, i in loops)
    if rec.trace is not None or not iters:
        return None
    return sum(t for t, _ in loops) / iters * 1e3
