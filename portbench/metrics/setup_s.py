"""setup_s: process start to the first solve of the window (host clock):
CUDA init, loading (and in a fresh checkout building) the kernels, the
matrix, the solver's layout and the warm-up solve."""


def read(rec):
    return rec.t_setup_end - rec.t_start if rec.trace is None else None
