"""What a later cell can ask for by data alone runs through the harness:
the wide field (a configuration), a mesh grid of one rank or of one
process a device, and a checkpoint interval (traffic keys)."""

import time

import pytest

from portbench import harness
from portbench.tests import tiny

MESH = {"tiny-narrow":
        "block_lanczos_tpu_torch.parallel.distributed:ShardedBlockLanczos",
        "tiny-gf2":
        "block_lanczos_tpu_torch.parallel.distributed_gf2:"
        "ShardedBlockLanczosGF2"}


def test_wide_field_config():
    config = dict(tiny.NARROW, name="tiny-wide", prime=(1 << 61) - 1,
                  nrows=120, ncols=80,
                  solver="block_lanczos_tpu_torch.models.lanczos_wide:"
                         "BlockLanczosWide")
    rec = harness.run_cell(config, tiny.TRAFFIC["tiny-narrow"], 9, 0.0,
                           False, "cpu", time.perf_counter())
    assert rec.field == "wide" and rec.judged
    assert harness.failed(rec) == 0


@pytest.mark.parametrize("config", tiny.CONFIGS, ids=lambda c: c["name"])
def test_mesh_grid_and_checkpoints(config, tmp_path):
    config = dict(config, mesh_solver=MESH[config["name"]])
    traffic = dict(tiny.TRAFFIC[config["name"]], grid=[1, 1],
                   checkpoint_s=1e-3)
    rec = harness.run_cell(config, traffic, 5, 0.0, False, "cpu",
                           time.perf_counter(), tmp_path / "ck")
    assert rec.judged and harness.failed(rec) == 0
    assert (tmp_path / "ck" / "manifest.json").exists()


def test_a_larger_grid_needs_its_ranks():
    traffic = dict(tiny.TRAFFIC["tiny-narrow"], grid=[2, 1])
    config = dict(tiny.NARROW, mesh_solver=MESH["tiny-narrow"])
    assert harness.grid_ranks(traffic) == 2
    with pytest.raises(ValueError, match="run_ranks"):
        harness.run_cell(config, traffic, 5, 0.0, False, "cpu",
                         time.perf_counter())


@pytest.mark.parametrize("config", tiny.CONFIGS, ids=lambda c: c["name"])
def test_a_2x2_grid_runs_a_process_a_rank(config):
    """Four gloo ranks on the CPU, as four cards would run under NCCL:
    rank 0's record comes back judged, every solve correct."""
    config = dict(config, mesh_solver=MESH[config["name"]])
    traffic = dict(tiny.TRAFFIC[config["name"]], grid=[2, 2])
    rec = harness.run_ranks(config, traffic, 2**31 + 5, 0.5, False,
                            ["cpu"] * 4, time.perf_counter())
    assert rec.judged and len(rec.judged) == len(rec.solves) >= 1
    assert harness.failed(rec) == 0
