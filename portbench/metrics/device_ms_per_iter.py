"""device_ms_per_iter: the device time of every operation inside the
traced solve's loop over the loop's iterations, in ms."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    loop = rec.solves[0].loop()
    us = t.loop_device_us()
    if loop is None or not loop[1] or us is None:
        return None
    return us / 1e3 / loop[1]
