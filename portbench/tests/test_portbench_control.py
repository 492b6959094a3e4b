"""The control at a size a test run holds: the program's blocks pass the
reference, the control's (the precision below, or one bit flipped over
GF(2)) and the half-zeroed blocks fail it."""

import pytest

from portbench import control, matrix
from portbench.tests import tiny


@pytest.mark.parametrize("config", tiny.CONFIGS, ids=lambda c: c["name"])
def test_control_fails_where_the_program_passes(config):
    seed = 2**31 + 101
    rec = tiny.run(config, seed)
    coo = matrix.generate(config, seed, "cpu")
    got = control.readings(rec, coo, seed)
    assert got["solves"] >= 1
    assert all(v == 0 for v in got["program"].values()), got
    assert not got["program_fails"], got
    assert got["control_fails"] and got["half_fails"], got
    assert got["control"]["xM_nonzero"] > 0
    n = tiny.TRAFFIC[config["name"]]["n"]
    assert got["half"]["zero_columns"] == got["solves"] * (n - n // 2)
