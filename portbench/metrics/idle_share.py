"""idle_share: 1 - (the union of device operation time) / wall over the
one whole traced solve, v0 and the final steps included, in %."""


def read(rec):
    t = rec.trace
    if t is None or not t.window_us():
        return None
    return 100 * (1 - t.busy_us() / t.window_us())
