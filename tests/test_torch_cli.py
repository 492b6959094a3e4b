"""The port's CLI: byte-identical kernel files on the CPU, and honest
refusals (exit code 2) for the paths this port does not cover yet."""

import os

import pytest

from block_lanczos_tpu_torch.utils import checker, cli

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


REFUSED = [
    ["--devices", "2"], ["--grid", "1", "1"], ["--overlap"],
    ["--checkpoint"], ["--checkpoint", "30"], ["--load-checkpoint"],
    ["--salvage"], ["--salvage-restarts", "1"],
]


@pytest.mark.parametrize("extra", REFUSED, ids=[a[0] for a in REFUSED])
def test_cli_refuses_paths_of_later_slices(extra, capsys):
    mtx = os.path.join(GOLDEN, "left_p65537_n4.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", "65537", "--n", "4",
                   "--device", "cpu", *extra])
    assert rc == 2
    assert "not supported" in capsys.readouterr().err


@pytest.mark.parametrize("prime,n", [(1073741827, 4), (2, 32), (2, 64)])
def test_cli_refuses_fields_of_later_slices(prime, n, capsys):
    mtx = os.path.join(GOLDEN, "left_p2_n32.mtx")
    rc = cli.main(["--matrix", mtx, "--prime", str(prime), "--n", str(n),
                   "--device", "cpu"])
    assert rc == 2
    assert "not supported" in capsys.readouterr().err


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
