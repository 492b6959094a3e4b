"""block_roofline: the Gram and orthogonalize bytes bound of the loop's
iterations over those kernels' device time in the loop, in %."""

from portbench import roofline

FAMILIES = ("gram", "orthogonalize")


def read(rec):
    t = rec.trace
    if t is None:
        return None
    loop = rec.solves[0].loop()
    us = t.loop_device_us(FAMILIES)
    if loop is None or not loop[1] or not us:
        return None
    N, n = rec.config["nrows"], rec.traffic["n"]
    nbytes = (roofline.gram_bytes(rec.field, N, n)
              + roofline.orthogonalize_bytes(rec.field, N, n))
    return 100 * roofline.bound_s(nbytes) * loop[1] / (us / 1e6)
