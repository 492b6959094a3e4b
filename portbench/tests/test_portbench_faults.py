"""A run with the timed path broken underneath reports correct false: a
step that leaves v and p as they were, half of the product's rows left
out, and an answer altered where solve() produces it.  (The exchange
between chips does not exist in a one-card cell.)"""

import numpy as np
import pytest
import torch

from block_lanczos_tpu_torch.models import lanczos, lanczos_gf2
from block_lanczos_tpu_torch.ops import spmm
from block_lanczos_tpu_torch.ops.semi_inverse import (FROZEN, INV_OK,
                                                      K_DONE, STOP)
from portbench import harness
from portbench.tests import tiny


def _state_unchanged(v, p_blk, Av, rhs, d, *rest):
    """The recurrence step's bookkeeping without its update."""
    state = rest[-1]
    halt = (state[STOP] != 0) | (state[INV_OK] == 0)
    frozen = state[FROZEN] != 0
    state[K_DONE] += (~frozen).to(state.dtype)
    state[FROZEN] = (frozen | halt).to(state.dtype)


def _half_rows(spmv):
    def broken(*args, **kwargs):
        out = spmv(*args, **kwargs)
        out[out.shape[0] // 2:] = 0
        return out
    return broken


def _altered(solve):
    def broken(self, *args, **kwargs):
        res = solve(self, *args, **kwargs)
        kernel = np.array(res.kernel, copy=True)
        kernel[len(kernel) // 3, 0] ^= 1
        res.kernel = kernel
        return res
    return broken


FAULTS = {
    "state_unchanged": {
        "tiny-narrow": (lanczos, "orthogonalize", lambda f: _state_unchanged),
        "tiny-gf2": (lanczos_gf2, "orthogonalize_gf2",
                     lambda f: _state_unchanged)},
    "half_the_rows": {
        "tiny-narrow": (spmm, "spmv", _half_rows),
        "tiny-gf2": (lanczos_gf2, "spmv_gf2", _half_rows)},
    "answer_altered": {
        "tiny-narrow": (lanczos.BlockLanczos, "solve", _altered),
        "tiny-gf2": (lanczos_gf2.BlockLanczosGF2, "solve", _altered)},
}


@pytest.mark.parametrize("config", tiny.CONFIGS, ids=lambda c: c["name"])
def test_a_sound_run_is_correct(config):
    rec = tiny.run(config)
    assert harness.failed(rec) == 0 and rec.judged


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("config", tiny.CONFIGS, ids=lambda c: c["name"])
def test_a_broken_path_is_not_correct(fault, config, monkeypatch):
    owner, attr, make = FAULTS[fault][config["name"]]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    torch.manual_seed(0)
    rec = tiny.run(config)
    assert harness.failed(rec) > 0
    assert any(v["value"] > v["limit"] for v in harness.checks(rec).values())
