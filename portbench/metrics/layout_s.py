"""layout_s: the solver's constructor (host clock): the program's layout
of the matrix, built on the host and moved to the device."""


def read(rec):
    return rec.layout_s if rec.trace is not None else None
