"""Checkpoints of the port on one device: twins of the JAX package's
tests/test_checkpoint_cli.py and of tests/test_robustness.py's
checkpoint tests, on the port's CLI and classes (CPU), tolerance zero.

  * save / load / validate_meta / the manager's throttle and request_save,
    as the JAX package's;
  * a solve stopped, saved and resumed in a fresh solver ends at the
    uninterrupted kernel, for the three fields; the CLI's --checkpoint /
    --load-checkpoint round trip writes the uninterrupted file byte for
    byte, its checks refuse a mismatched checkpoint with the JAX CLI's
    messages and exit 1;
  * the blocks cross over to the JAX on-disk forms and back unchanged
    (bit 31 of a GF(2) word too), and a JAX wide state handed to the wide
    solver untranslated is refused, not misread;
  * SIGTERM raised from inside the iteration callback at a fixed
    iteration: the CLI saves, exits 143, and the resumed run writes the
    uninterrupted file (no timing race: the signal is sent by the run
    itself).
"""

import os
import signal

import numpy as np
import pytest
import torch

from block_lanczos_tpu_torch import convert
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.models.lanczos_gf2 import BlockLanczosGF2
from block_lanczos_tpu_torch.models.lanczos_wide import BlockLanczosWide
from block_lanczos_tpu_torch.utils import checker
from block_lanczos_tpu_torch.utils import checkpoint as ckpt
from block_lanczos_tpu_torch.utils import cli, gen, mmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NARROW = os.path.join(GOLDEN, "left_p65537_n4.mtx")
GF2 = os.path.join(GOLDEN, "left_p2_n32.mtx")
P55 = 36028797018963913   # the JAX test's 55-bit prime
CPU = ["--device", "cpu"]


def _wide_mtx(tmp_path):
    path = str(tmp_path / "mw.mtx")
    gen.write_random_mtx(path, 96, 64, 5, seed=7)
    return path


# field -> (solver class, matrix maker, prime, n)
FIELDS = {
    "narrow": (BlockLanczos, lambda t: NARROW, 65537, 4),
    "gf2": (BlockLanczosGF2, lambda t: GF2, 2, 32),
    "wide": (BlockLanczosWide, _wide_mtx, P55, 4),
}


def _run(argv):
    return cli.main([*argv, *CPU])


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    v = np.arange(12, dtype=np.uint32).reshape(6, 2)
    p = (v * 7) % 65537
    ckpt.save_checkpoint(d, v, p, iteration=5, elapsed=1.5,
                         meta={"prime": 65537})
    state = ckpt.load_checkpoint(d)
    np.testing.assert_array_equal(state["v"], v)
    np.testing.assert_array_equal(state["p"], p)
    assert state["iteration"] == 5 and state["prime"] == 65537
    # overwrite is atomic and versionless: a second save fully replaces
    ckpt.save_checkpoint(d, v + 1, p, iteration=6, elapsed=2.0)
    state = ckpt.load_checkpoint(d)
    assert state["iteration"] == 6
    np.testing.assert_array_equal(state["v"], v + 1)
    assert not [f for f in os.listdir(d) if f.startswith(".ckpt_tmp_")]


@pytest.mark.parametrize("field", list(FIELDS))
def test_resume_matches_uninterrupted(tmp_path, field):
    """Run to completion; then stop mid-way, save through a manager bound
    to the solver (the JAX on-disk form), resume in a FRESH solver: the
    kernels are bit-identical."""
    cls, mtx, prime, n = FIELDS[field]
    M = mmio.load_mtx(mtx(tmp_path), prime)
    full = cls(M, n=n, device="cpu").solve()
    solver = cls(M, n=n, sync_every=1, device="cpu")
    d = str(tmp_path / "ck")
    mgr = ckpt.CheckpointManager(d, interval_s=3600.0, solver=solver)
    k = max(1, full.iterations // 2)

    def save_at_k(slv, iteration, v, p_blk, start):
        if iteration == k:
            mgr.request_save()
        mgr.maybe_save(iteration, v, p_blk, start)

    part = solver.solve(stop_after=k + 2, on_iteration=save_at_k)
    assert part.iterations == k + 2 and mgr.saves == 1
    state = ckpt.load_checkpoint(d)
    assert state["iteration"] == k
    want = {"narrow": (np.uint32, 2), "gf2": (np.uint32, 2),
            "wide": (np.uint32, 3)}[field]
    assert state["v"].dtype == want[0] and state["v"].ndim == want[1]
    resumed = cls(M, n=n, device="cpu").solve(
        resume_state=convert.FROM_NUMPY[field](state, "cpu"))
    assert resumed.iterations == full.iterations
    np.testing.assert_array_equal(resumed.kernel, full.kernel)
    assert resumed.v_nonzero and resumed.product_zero


@pytest.mark.parametrize("field", list(FIELDS))
def test_cli_checkpoint_resume(tmp_path, field, capsys):
    """--stop-after k --checkpoint 0 saves at k; --load-checkpoint runs to
    the end and writes the uninterrupted run's file byte for byte, which
    the checker accepts (the JAX tests' CLI resume and GF(2) / wide
    round trips)."""
    _, mtx, prime, n = FIELDS[field]
    mtx = mtx(tmp_path)
    base = ["--matrix", mtx, "--prime", str(prime), "--n", str(n)]
    ckdir = str(tmp_path / "ck")
    full, res = str(tmp_path / "full.mtx"), str(tmp_path / "res.mtx")
    assert _run([*base, "--output-file", full]) == 0
    assert _run([*base, "--stop-after", "2", "--checkpoint", "0",
                 "--checkpoint-dir", ckdir]) == 0
    state = ckpt.load_checkpoint(ckdir)
    assert state["iteration"] == 2 and state["field"] == field
    capsys.readouterr()
    assert _run([*base, "--load-checkpoint", "--checkpoint-dir", ckdir,
                 "--output-file", res]) == 0
    assert f"Resuming from iteration 2 ({ckdir})" in capsys.readouterr().out
    with open(full, "rb") as a, open(res, "rb") as b:
        assert a.read() == b.read()
    assert checker.check_kernel_file(mtx, res, prime) is True


def test_cli_validation(tmp_path):
    assert _run(["--matrix", NARROW, "--prime", "65537", "--output-file",
                 "x", "--stop-after", "3"]) == 1
    # beyond even the wide cap (2^62) -> rejected
    assert _run(["--matrix", NARROW, "--prime", str(2**62 + 1)]) == 1
    # 2^31 - 1 exceeds the reference's 2^30 - 35 cap; the wide path takes it
    assert _run(["--matrix", NARROW, "--prime", str(2**31 - 1),
                 "--stop-after", "2", "--no-checks"]) == 0


def test_cli_checkpoint_meta_mismatch(tmp_path, capsys):
    """Resuming with conflicting {prime, n, right, shape} is refused with
    the JAX CLI's messages and exit 1."""
    ckdir = str(tmp_path / "ck")
    assert _run(["--matrix", NARROW, "--prime", "65537", "--n", "4",
                 "--stop-after", "4", "--checkpoint", "0",
                 "--checkpoint-dir", ckdir]) == 0
    capsys.readouterr()

    def resume(extra, mtx=NARROW):
        return _run(["--matrix", mtx, "--load-checkpoint",
                     "--checkpoint-dir", ckdir, "--stop-after", "6", *extra])

    assert resume(["--prime", "65537", "--n", "8"]) == 1
    assert "n: checkpoint has 4" in capsys.readouterr().err
    assert resume(["--prime", "65521", "--n", "4"]) == 1
    assert "prime: checkpoint has 65537" in capsys.readouterr().err
    assert resume(["--prime", "65537", "--n", "4", "--right"]) == 1
    assert "right: checkpoint has False" in capsys.readouterr().err
    other = str(tmp_path / "other.mtx")
    gen.write_random_mtx(other, 64, 48, 3, seed=9)
    assert resume(["--prime", "65537", "--n", "4"], other) == 1
    assert "nrows: checkpoint has" in capsys.readouterr().err
    # matching config resumes fine
    assert resume(["--prime", "65537", "--n", "4"]) == 0
    # a missing checkpoint dir and a corrupt manifest: clean errors
    assert _run(["--matrix", NARROW, "--prime", "65537", "--n", "4",
                 "--load-checkpoint", "--checkpoint-dir",
                 str(tmp_path / "nope")]) == 1
    assert "cannot load checkpoint" in capsys.readouterr().err
    with open(os.path.join(ckdir, ckpt.MANIFEST), "w") as fh:
        fh.write("{not json")
    assert resume(["--prime", "65537", "--n", "4"]) == 1
    assert "cannot load checkpoint" in capsys.readouterr().err


def test_cli_checkpoint_dedup_mismatch(tmp_path, capsys):
    """A GF(2) checkpoint written under one dedup setting is refused on
    resume under the other (m_eff fingerprints the effective operator),
    with the hint; the matching setting resumes."""
    i, j, x = gen.random_sparse(64, 96, 5, seed=9)
    mtx = str(tmp_path / "dup.mtx")
    mmio.write_coo_mtx(mtx, 64, 96, i, j, x)
    ckdir = str(tmp_path / "ck")
    base = ["--matrix", mtx, "--prime", "2", "--n", "32", "--right",
            "--no-checks", "--checkpoint-dir", ckdir]
    assert _run([*base, "--stop-after", "1", "--checkpoint", "0",
                 "--sync-every", "1"]) == 0
    capsys.readouterr()
    assert _run([*base, "--load-checkpoint", "--stop-after", "2",
                 "--no-dedup"]) == 1
    err = capsys.readouterr().err
    assert "m_eff: checkpoint has" in err and "--no-dedup" in err
    assert _run([*base, "--load-checkpoint", "--stop-after", "2"]) == 0


def test_validate_meta_ignores_unknown_and_legacy():
    """Manifests from older versions (no field/shape keys) still resume."""
    ckpt.validate_meta({"iteration": 3, "prime": 65537},
                       {"prime": 65537, "n": 4, "field": "narrow"})
    with pytest.raises(ckpt.CheckpointMismatch):
        ckpt.validate_meta({"prime": 65537}, {"prime": 2})
    with pytest.raises(ckpt.CheckpointMismatch, match="m_eff"):
        ckpt.validate_meta({"m_eff": 90}, {"m_eff": 96})


def test_manager_request_save_bypasses_schedule(tmp_path):
    """request_save (the SIGTERM path) saves at the next callback even when
    neither the timer nor the iteration due-check would fire."""
    v = np.zeros((8, 2), np.uint32)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), interval_s=3600.0)
    assert mgr.maybe_save(1, v, v, 0.0) is False
    assert mgr.maybe_save(2, v, v, 0.0) is False   # sets a far next-check
    mgr.request_save(signal.SIGTERM)
    assert mgr.maybe_save(3, v, v, 0.0) is True    # bypasses both gates
    assert mgr.save_requested is False             # consumed
    assert mgr.signum == signal.SIGTERM            # the exit still to come
    state = ckpt.load_checkpoint(str(tmp_path / "ck"))
    assert state["iteration"] == 3
    assert mgr.maybe_save(4, v, v, 0.0) is False   # schedule resumes


def test_checkpoint_manager_iteration_throttle(tmp_path, monkeypatch):
    """maybe_save does not re-examine the clock every call: between due
    checks it returns False from the iteration target alone."""
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), interval_s=3600.0)
    v = np.zeros((8, 2), np.uint32)
    assert mgr.maybe_save(1, v, v, 0.0) is False
    assert mgr.maybe_save(2, v, v, 0.0) is False
    target = mgr._next_check_iter
    assert target > 2
    calls = []
    real = ckpt.time.time
    monkeypatch.setattr(ckpt.time, "time",
                        lambda: calls.append(1) or real())
    for it in range(3, min(target, 50)):
        assert mgr.maybe_save(it, v, v, 0.0) is False
    assert not calls  # throttled calls never read the clock
    monkeypatch.undo()
    # interval 0: saves on every due-check and keeps making progress
    mgr2 = ckpt.CheckpointManager(str(tmp_path / "ck2"), interval_s=0.0)
    assert mgr2.maybe_save(1, v, v, real()) is True
    assert mgr2.saves == 1


def _write_zero_mod_p_mtx(path, p, nrows=16, ncols=8, k=4):
    """Every coefficient = 0 mod p: the solve converges at iteration 0."""
    with open(path, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{nrows} {ncols} {k}\n")
        for t in range(k):
            fh.write(f"{t + 1} {t + 1} {p * (t + 1)}\n")


@pytest.mark.parametrize("p,n", [(65537, 4), (2, 32), (P55, 4)],
                         ids=["narrow", "gf2", "wide"])
def test_cli_zero_mod_p_with_checkpointing(tmp_path, p, n):
    """iteration == 0 does not break the checkpoint due-check path."""
    mtx = str(tmp_path / "zero.mtx")
    _write_zero_mod_p_mtx(mtx, p)
    assert _run(["--matrix", mtx, "--prime", str(p), "--n", str(n),
                 "--checkpoint", "0",
                 "--checkpoint-dir", str(tmp_path / "ck")]) == 0


@pytest.mark.parametrize("field", list(FIELDS))
def test_blocks_cross_to_the_jax_forms_and_back(field):
    """TO_NUMPY gives the JAX solvers' dtypes and layouts; FROM_NUMPY
    brings the same blocks back (GF(2): bit 31 survives the view)."""
    rng = np.random.default_rng(3)
    if field == "narrow":
        v = rng.integers(0, 65537, (13, 4)).astype(np.int32)
    elif field == "gf2":
        v = rng.integers(-(1 << 31), 1 << 31, (13, 2)).astype(np.int32)
        v[0, 0] = np.int32(-(1 << 31))        # bit 31 alone
    else:
        v = rng.integers(0, P55, (13, 4)).astype(np.int64)
        v[0, 0] = P55 - 1
    port = {"v": torch.from_numpy(v), "p": torch.from_numpy(v[::-1].copy()),
            "iteration": 7}
    disk = convert.TO_NUMPY[field](port)
    assert disk["v"].dtype == np.uint32 and disk["iteration"] == 7
    if field == "wide":
        assert disk["v"].shape == (13, 4, 2)
        assert int(disk["v"][0, 0, 1]) << 32 | int(disk["v"][0, 0, 0]) \
            == P55 - 1
    else:
        assert disk["v"].shape == v.shape
    if field == "gf2":
        assert disk["v"][0, 0] == 1 << 31
    back = convert.FROM_NUMPY[field](disk, "cpu")
    assert back["iteration"] == 7
    for name in ("v", "p"):
        assert back[name].dtype == port[name].dtype
        assert torch.equal(back[name], port[name])


def test_wide_solver_refuses_an_untranslated_jax_state(tmp_path):
    """(rows, n, 2) uint32 pairs pass the [0, p) range check; the shape
    check refuses them before any solve."""
    M = mmio.load_mtx(_wide_mtx(tmp_path), P55)
    solver = BlockLanczosWide(M, n=4, device="cpu")
    pairs = np.zeros((solver.np_rows, 4, 2), np.uint32)
    pairs[0, 0, 0] = 5
    with pytest.raises(ValueError, match=r"must be \(rows, 4\)"):
        solver.solve(resume_state={"v": pairs, "p": pairs, "iteration": 1})


@pytest.mark.parametrize("field", list(FIELDS))
def test_cli_sigterm_from_the_callback_saves_exits_143_and_resumes(
        tmp_path, field, monkeypatch, capsys):
    """The signal is raised inside the run's own iteration callback at
    iteration 2 (the manager's maybe_save, wrapped), so it always lands
    mid-solve: the handler requests the save, the same callback persists
    it, the run exits 128 + 15; --load-checkpoint then writes the
    uninterrupted file byte for byte."""
    _, mtx, prime, n = FIELDS[field]
    mtx = mtx(tmp_path)
    base = ["--matrix", mtx, "--prime", str(prime), "--n", str(n)]
    full, res = str(tmp_path / "full.mtx"), str(tmp_path / "res.mtx")
    ckdir = str(tmp_path / "ck")
    assert _run([*base, "--output-file", full]) == 0
    real = ckpt.CheckpointManager.maybe_save

    def signalling(self, iteration, *a, **kw):
        if iteration == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, iteration, *a, **kw)

    monkeypatch.setattr(ckpt.CheckpointManager, "maybe_save", signalling)
    before = signal.getsignal(signal.SIGTERM)
    rc = _run([*base, "--sync-every", "1", "--checkpoint", "3600",
               "--checkpoint-dir", ckdir, "--output-file", res])
    assert rc == 128 + signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == before  # handlers put back
    assert "Received signal 15; state checkpointed" in capsys.readouterr().err
    assert ckpt.load_checkpoint(ckdir)["iteration"] == 2
    assert not os.path.exists(res)
    monkeypatch.undo()
    assert _run([*base, "--load-checkpoint", "--checkpoint-dir", ckdir,
                 "--output-file", res]) == 0
    with open(full, "rb") as a, open(res, "rb") as b:
        assert a.read() == b.read()
