"""v0_s: one initial_block() call on the set-up solver (host clock,
synchronised): the xoshiro draw, its packing and upload."""


def read(rec):
    return rec.v0_s if rec.trace is not None else None
