"""spmv_roofline: the SpMV bytes bound of the loop's iterations over the
device time of the SpMV kernels in the loop, in %."""

from portbench import roofline

FAMILIES = ("spmv",)


def read(rec):
    t = rec.trace
    if t is None:
        return None
    loop = rec.solves[0].loop()
    us = t.loop_device_us(FAMILIES)
    if loop is None or not loop[1] or not us:
        return None
    c = rec.config
    nbytes = roofline.spmv_bytes(rec.field, c["nrows"], c["ncols"], rec.nnz,
                                 rec.traffic["n"])
    return 100 * roofline.bound_s(nbytes) * loop[1] / (us / 1e6)
