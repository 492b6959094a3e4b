"""The port's CLI: byte-identical kernel files on the CPU (narrow field and
GF(2), salvage and --no-dedup against the JAX package's CLI), the
checkpoint flags and --overlap running (their checks:
test_torch_checkpoint*.py, test_torch_mesh_overlap.py), and honest
refusals (exit code 2) for mesh flags that cannot run (the mesh's own
runs: test_torch_mesh_fields)."""

import os

import numpy as np
import pytest

from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils.gen import random_sparse
from block_lanczos_tpu_torch.utils import checker, cli, mmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name,prime,n,side", [
    ("left_pbig_n8_odd_dims", 1073741789, 8, "--left"),
    ("right_p65537_n4", 65537, 4, "--right"),
])
def test_cli_writes_the_golden_byte_for_byte(tmp_path, name, prime, n, side):
    mtx = os.path.join(GOLDEN, f"{name}.mtx")
    out = tmp_path / "kernel.mtx"
    assert cli.main(["--matrix", mtx, "--prime", str(prime), "--n", str(n),
                     side, "--output-file", str(out), "--device", "cpu"]) == 0
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()
    args = ["--matrix", mtx, "--kernel", str(out), "--prime", str(prime)]
    assert checker.main(args + ([side] if side == "--right" else [])) == 0


# (the arguments, the message): the mesh and multi-host flags where they
# cannot run (too many CUDA ranks for this or any host, a process index out
# of range, a multi-host flag without its rendezvous); each exits 2 before
# the matrix is loaded
REFUSED = [
    (["--devices", "4096", "--device", "cuda"],
     "4096 ranks on this host need 4096 CUDA devices"),
    (["--grid", "64", "64", "--device", "cuda"],
     "4096 ranks on this host need 4096 CUDA devices"),
    (["--coordinator", "localhost:1234", "--process-id", "3"],
     "--process-id 3 is not in [0, 1)"),
    (["--num-processes", "2"], "--num-processes needs --coordinator"),
    (["--process-id", "1"], "--process-id needs --coordinator"),
    (["--local-devices", "2"], "--local-devices needs --coordinator"),
    (["--grid", "2", "2", "--devices", "3"],
     "--devices 3 does not match the grid 2 x 2"),
]
REFUSED_IDS = [a[0] for a, _ in REFUSED[:-1]] + ["grid-and-devices"]


@pytest.mark.parametrize("extra,message", REFUSED, ids=REFUSED_IDS)
def test_cli_refuses_paths_of_later_slices(extra, message, tmp_path, capsys):
    """Exit code 2 and the reason, before the matrix is loaded (it does not
    exist)."""
    rc = cli.main(["--matrix", str(tmp_path / "absent.mtx"), "--prime",
                   "65537", "--n", "4", "--device", "cpu", *extra])
    assert rc == 2
    assert message in capsys.readouterr().err


# --overlap, refused by earlier slices: alone (the mesh over every device:
# one gloo rank on the CPU) and with --single, which ignores it
OVERLAP_FLAGS = [(["--overlap"], "sharded 1x1"),
                 (["--overlap", "--single"], "Block Lanczos\n")]
OVERLAP_IDS = ["--overlap", "overlap-and-single"]


@pytest.mark.parametrize("extra,header", OVERLAP_FLAGS, ids=OVERLAP_IDS)
def test_cli_runs_the_overlap_flag(extra, header, tmp_path, capfd):
    """The run writes the golden; its header (the rank's own output on the
    mesh) says which solver ran."""
    name = "left_p65537_n4"
    out = tmp_path / "kernel.mtx"
    assert cli.main(["--matrix", os.path.join(GOLDEN, f"{name}.mtx"),
                     "--prime", "65537", "--n", "4", "--device", "cpu",
                     "--output-file", str(out), *extra]) == 0
    assert header in capfd.readouterr().out
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()


# the checkpoint flags, refused by earlier slices, with what each run
# needs first (a checkpoint in the default directory to resume from)
CHECKPOINT_FLAGS = [
    (["--checkpoint"], None),
    (["--checkpoint", "30"], None),
    (["--load-checkpoint"], ["--stop-after", "3", "--checkpoint", "0"]),
    (["--checkpoint-dir", "cp"], None),
    (["--grid", "2", "2", "--checkpoint-dir", "cp"], None),
]
CHECKPOINT_IDS = ["--checkpoint", "--checkpoint", "--load-checkpoint",
                  "--checkpoint-dir", "mesh-and-checkpoint"]


@pytest.mark.parametrize("extra,prepare", CHECKPOINT_FLAGS,
                         ids=CHECKPOINT_IDS)
def test_cli_runs_the_checkpoint_flags(extra, prepare, tmp_path,
                                       monkeypatch, capsys):
    """The checkpoint flags run (default directory lanczos_checkpoint in
    the working directory) and write the golden; --load-checkpoint resumes
    from a checkpoint at iteration 3."""
    monkeypatch.chdir(tmp_path)
    name = "left_p65537_n4"
    args = ["--matrix", os.path.join(GOLDEN, f"{name}.mtx"), "--prime",
            "65537", "--n", "4", "--device", "cpu"]
    if prepare is not None:
        assert cli.main([*args, *prepare]) == 0
        assert os.path.isfile(tmp_path / "lanczos_checkpoint" /
                              "manifest.json")
        capsys.readouterr()
    out = tmp_path / "kernel.mtx"
    assert cli.main([*args, *extra, "--output-file", str(out)]) == 0
    if prepare is not None:
        assert "Resuming from iteration 3" in capsys.readouterr().out
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()


@pytest.mark.parametrize("extra", [["--single"],
                                   ["--num-processes", "1",
                                    "--process-id", "0"]],
                         ids=["single", "one-process"])
def test_cli_takes_the_jax_clis_one_device_flags(tmp_path, extra):
    """--single and the multi-host flags at their one-process values run
    and write the golden, as the JAX CLI does with them on one device."""
    name = "left_p65537_n4"
    out = tmp_path / "kernel.mtx"
    assert cli.main(["--matrix", os.path.join(GOLDEN, f"{name}.mtx"),
                     "--prime", "65537", "--n", "4", "--output-file",
                     str(out), "--device", "cpu", *extra]) == 0
    with open(os.path.join(GOLDEN, f"{name}.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()


@pytest.mark.parametrize("prime,n,device,cap", [
    (65537, 65, "cpu", 64), (2, 100, "cuda", 64), (2, 544, "cuda", 512)])
def test_cli_refuses_widths_above_the_caps_before_loading(
        tmp_path, capsys, prime, n, device, cap):
    """The matrix file does not exist: the refusal comes before loading."""
    rc = cli.main(["--matrix", str(tmp_path / "absent.mtx"), "--prime",
                   str(prime), "--n", str(n), "--device", device])
    assert rc == 2
    err = capsys.readouterr().err
    assert f"n <= {cap}" in err and "not supported by this port yet" in err


def test_cli_help_states_the_width_caps():
    text = " ".join(cli.build_parser().format_help().split())
    assert "n <= 64 in the narrow field" in text
    assert "n <= 512 over GF(2)" in text


def test_cli_takes_the_first_wide_prime(capsys):
    """2^30 + 3, the first prime above the narrow field's cap, takes the
    wide field (p >= 2^62 is refused: test_torch_wide_solver.py::
    test_cli_wide_caps)."""
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", "1073741827", "--n", "4",
                   "--stop-after", "2", "--device", "cpu"])
    assert rc == 0
    assert "wide field" in capsys.readouterr().err


def test_cli_stop_after_and_output_are_exclusive(tmp_path):
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    assert cli.main(["--matrix", mtx, "--prime", "65537", "--n", "4",
                     "--stop-after", "2", "--output-file",
                     str(tmp_path / "k.mtx"), "--device", "cpu"]) == 1
    assert cli.main(["--matrix", mtx, "--prime", "65537", "--n", "4",
                     "--stop-after", "2", "--no-checks", "--sync-every", "1",
                     "--device", "cpu"]) == 0


def test_cli_defaults_to_cuda_and_does_not_fall_back(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal is not testable")
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    assert cli.main(["--matrix", mtx, "--prime", "65537", "--n", "4"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_cli_gf2_writes_the_golden_byte_for_byte(tmp_path, capsys):
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    out = tmp_path / "kernel.mtx"
    assert cli.main(["--matrix", mtx, "--prime", "2", "--n", "32",
                     "--output-file", str(out), "--device", "cpu"]) == 0
    assert "GF(2) bitsliced path" in capsys.readouterr().err
    with open(os.path.join(GOLDEN, "left_p2_n32.kernel.mtx"), "rb") as fh:
        assert out.read_bytes() == fh.read()
    assert checker.main(["--matrix", mtx, "--kernel", str(out),
                         "--prime", "2"]) == 0


def _write(tmp_path, name, i, j, x, nrows, ncols):
    path = str(tmp_path / name)
    mmio.write_coo_mtx(path, nrows, ncols, i, j, x)
    return path


def _both_clis(tmp_path, mtx, flags):
    """Run the port's CLI (CPU) and the JAX package's (single device) with
    the same flags; returns the two kernel files' bytes."""
    outs = []
    for name, main, extra in (("t", cli.main, ["--device", "cpu"]),
                              ("j", jcli.main, ["--single"])):
        out = tmp_path / f"{name}.mtx"
        assert main(["--matrix", mtx, *flags, "--output-file", str(out),
                     *extra]) == 0
        outs.append(out.read_bytes())
    return outs


@pytest.mark.parametrize("dedup", [[], ["--no-dedup"]],
                         ids=["dedup", "no-dedup"])
def test_cli_dedup_choice_matches_the_jax_cli(tmp_path, dedup):
    """Columns 200..209 copy columns 0..9: the left-kernel operator has
    duplicate lines, so the two settings give different kernels, each
    byte-identical to the JAX package's."""
    i, j, x = random_sparse(300, 200, 6, seed=3)
    x = x | 1
    cp = j < 10
    mtx = _write(tmp_path, "dup.mtx", np.concatenate([i, i[cp]]),
                 np.concatenate([j, j[cp] + 200]),
                 np.concatenate([x, x[cp]]), 300, 210)
    t, jx = _both_clis(tmp_path, mtx, ["--prime", "2", "--n", "32",
                                       *dedup])
    assert t == jx


@pytest.mark.parametrize("extra", [[], ["--salvage-restarts", "2"]],
                         ids=["salvage", "salvage-restarts"])
def test_cli_salvage_writes_a_checked_kernel(tmp_path, extra, capsys):
    """The seed-9 right-kernel instance breaks down on the reference's
    operator (--no-dedup): --salvage writes the verified vectors, the
    port's checker accepts them, and the file equals the JAX CLI's."""
    i, j, x = random_sparse(64, 96, 5, seed=9)
    mtx = _write(tmp_path, "seed9.mtx", i, j, x, 64, 96)
    t, jx = _both_clis(tmp_path, mtx, ["--prime", "2", "--n", "32",
                                       "--right", "--no-dedup", "--no-checks",
                                       "--salvage", *extra])
    assert t == jx
    assert "KO: vt*M != 0" in capsys.readouterr().out
    assert checker.main(["--matrix", mtx, "--kernel",
                         str(tmp_path / "t.mtx"), "--prime", "2",
                         "--right"]) == 0


def test_cli_gf2_defaults_to_cuda_and_does_not_fall_back(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA refusal is not testable")
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    assert cli.main(["--matrix", mtx, "--prime", "2", "--n", "32"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
