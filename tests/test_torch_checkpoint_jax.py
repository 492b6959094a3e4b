"""Checkpoints across the two packages, for the three fields (CPU,
tolerance zero).

  * a checkpoint the JAX solver writes at iteration k (through the JAX
    package's CheckpointManager, as its CLI does) resumes in the port's
    CLI, and one the port's CLI writes (--stop-after k --checkpoint 0)
    resumes in the same JAX solver (one trace of its step, which the wide
    field's takes ~10 s to make); both end at the uninterrupted run's
    kernel file, byte for byte;
  * the port's CLI writes the JAX CLI's manifest: the same keys, the same
    run values, the same arrays;
  * a JAX mesh checkpoint in a permuted band layout (with `rowmap`, a
    skewed matrix on an 8-device mesh) resumes in the port, bit-exactly;
  * a JAX per-host step directory (the multi-process format, laid out as
    the JAX package's save_checkpoint_global writes it) loads to the same
    state in both packages' load_checkpoint, and resumes in the port.
"""

import json
import os

import numpy as np
import pytest

from block_lanczos_tpu.models.lanczos import BlockLanczos as JNarrow
from block_lanczos_tpu.models.lanczos_gf2 import BlockLanczosGF2 as JGF2
from block_lanczos_tpu.models.lanczos_wide import BlockLanczosWide as JWide
from block_lanczos_tpu.parallel.distributed import \
    ShardedBlockLanczos as JSharded
from block_lanczos_tpu.parallel.mesh import make_mesh
from block_lanczos_tpu.utils import checkpoint as jckpt
from block_lanczos_tpu.utils import cli as jcli
from block_lanczos_tpu.utils import mmio as jmmio
from block_lanczos_tpu_torch import convert
from block_lanczos_tpu_torch.models.lanczos import BlockLanczos
from block_lanczos_tpu_torch.utils import checkpoint as ckpt
from block_lanczos_tpu_torch.utils import cli, gen, mmio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P55 = 36028797018963913
PRIME = 1073741789


def _wide_mtx(tmp_path):
    path = str(tmp_path / "mw.mtx")
    gen.write_random_mtx(path, 96, 64, 5, seed=7)
    return path


# field -> (matrix maker, prime, n, the iteration to stop and save at, the
# JAX solver class)
FIELDS = {
    "narrow": (lambda t: os.path.join(GOLDEN, "left_p65537_n4.mtx"), 65537,
               4, 7, JNarrow),
    "gf2": (lambda t: os.path.join(GOLDEN, "left_p2_n32.mtx"), 2, 32, 2,
            JGF2),
    "wide": (_wide_mtx, P55, 4, 5, JWide),
}
RUN_KEYS = ("matrix", "prime", "n", "right", "field", "nrows", "ncols",
            "nnz", "m_eff")


def _port(argv):
    return cli.main([*argv, "--device", "cpu"])


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("field", list(FIELDS))
def test_either_package_resumes_the_others_checkpoint(tmp_path, field):
    mtx, prime, n, k, jcls = FIELDS[field]
    mtx = mtx(tmp_path)
    base = ["--matrix", mtx, "--prime", str(prime), "--n", str(n)]
    full = str(tmp_path / "full.mtx")
    assert _port([*base, "--output-file", full]) == 0
    tdir, jdir = str(tmp_path / "port_ck"), str(tmp_path / "jax_ck")
    assert _port([*base, "--stop-after", str(k), "--checkpoint", "0",
                  "--sync-every", "1", "--checkpoint-dir", tdir]) == 0
    tstate = ckpt.load_checkpoint(tdir)

    # the JAX solver saves at k through its own manager, with the run meta
    # its CLI would write; then, resumed from the port's file, it solves on
    js = jcls(jmmio.load_mtx(mtx, prime), n=n, sync_every=1)
    mgr = jckpt.CheckpointManager(jdir, interval_s=0.0, meta={
        key: tstate[key] for key in RUN_KEYS})
    js.solve(stop_after=k, on_iteration=lambda slv, it, v, p_blk, start:
             mgr.maybe_save(it, v, p_blk, start))
    jstate = jckpt.load_checkpoint(jdir)
    assert jstate["iteration"] == tstate["iteration"] == k
    for name in ("v", "p"):
        assert jstate[name].dtype == tstate[name].dtype == np.uint32
        assert jstate[name].shape[1:] == tstate[name].shape[1:]
        rows = min(len(jstate[name]), len(tstate[name]))
        np.testing.assert_array_equal(jstate[name][:rows],
                                      tstate[name][:rows])
        assert not jstate[name][rows:].any()
        assert not tstate[name][rows:].any()

    t_out, j_out = str(tmp_path / "t.mtx"), str(tmp_path / "j.mtx")
    assert _port([*base, "--load-checkpoint", "--checkpoint-dir", jdir,
                  "--output-file", t_out]) == 0
    res = js.solve(resume_state=tstate)
    assert res.v_nonzero and res.product_zero
    jmmio.write_kernel_mtx(j_out, res.kernel, js.n_eff, n)
    assert _bytes(t_out) == _bytes(full)
    assert _bytes(j_out) == _bytes(full)


@pytest.mark.parametrize("field", ["narrow", "gf2"])
def test_cli_manifest_is_the_jax_clis(tmp_path, field):
    """Both CLIs at --stop-after k --checkpoint 0: the same manifest keys
    and run values, the same arrays in state.npz."""
    mtx, prime, n, k, _ = FIELDS[field]
    argv = ["--matrix", mtx(tmp_path), "--prime", str(prime), "--n", str(n),
            "--stop-after", str(k), "--checkpoint", "0", "--sync-every", "1"]
    tdir, jdir = str(tmp_path / "port_ck"), str(tmp_path / "jax_ck")
    assert _port([*argv, "--checkpoint-dir", tdir]) == 0
    assert jcli.main([*argv, "--single", "--checkpoint-dir", jdir]) == 0
    with open(os.path.join(tdir, ckpt.MANIFEST)) as a, \
            open(os.path.join(jdir, jckpt.MANIFEST)) as b:
        tm, jm = json.load(a), json.load(b)
    assert set(tm) == set(jm)
    for key in ("iteration", "shape") + RUN_KEYS:
        assert tm[key] == jm[key], key
    with np.load(os.path.join(tdir, ckpt.ARRAYS)) as zt, \
            np.load(os.path.join(jdir, jckpt.ARRAYS)) as zj:
        assert zt.files == zj.files
        for name in zt.files:
            assert zt[name].dtype == zj[name].dtype
            np.testing.assert_array_equal(zt[name], zj[name])


def _row_skewed_matrix(nrows, ncols, density, seed, prime=PRIME, alpha=1.2):
    """Power-law ROW weights (tests/test_skewed_sharded.py's shape): the
    port's random_sparse_skewed, transposed."""
    i, j, x = gen.random_sparse_skewed(ncols, nrows, density, seed=seed,
                                       alpha=alpha)
    order = np.lexsort((i, j))
    return (j[order].astype(np.int32), i[order].astype(np.int32),
            (x[order] % prime).astype(np.uint32))


SKEW = (400, 300, 6, 11)   # nrows, ncols, density, seed: permuted on 8


@pytest.fixture(scope="module")
def jax_mesh_states():
    """The skewed matrix (both packages' COO), the JAX mesh's band-layout
    (v, p) after iterations 2 and 3 on 8 devices, and its rowmap."""
    nrows, ncols, density, seed = SKEW
    i, j, x = _row_skewed_matrix(nrows, ncols, density, seed)
    JM = jmmio.COOMatrix(nrows, ncols, len(x), i, j, x, PRIME)
    TM = mmio.COOMatrix(nrows, ncols, len(x), i, j, x, PRIME)
    sharded = JSharded(JM, n=4, mesh=make_mesh(8), sync_every=1)
    assert not sharded.row_map.identity
    saved = {}

    def grab(slv, iteration, v, p_blk, start):
        saved[iteration] = (np.asarray(v), np.asarray(p_blk))

    sharded.solve(stop_after=3, on_iteration=grab)
    return TM, saved, sharded.row_map.rowmap()


def _port_solve(TM, stop_after, state=None):
    return BlockLanczos(TM, n=4, device="cpu").solve(
        stop_after=stop_after, resume_state=None if state is None
        else convert.FROM_NUMPY["narrow"](state, "cpu"))


def test_jax_mesh_rowmap_checkpoint_resumes_in_the_port(tmp_path,
                                                        jax_mesh_states):
    """The JAX mesh saves its permuted band layout with its rowmap; both
    packages' load_checkpoint read the same state, and the port's solver
    undoes the layout and ends where the port's straight solve ends."""
    TM, saved, rowmap = jax_mesh_states
    d = str(tmp_path / "ck")
    jckpt.save_checkpoint(d, *saved[3], 3, elapsed=0.0,
                          meta={"field": "narrow"}, rowmap=rowmap)
    state, jstate = ckpt.load_checkpoint(d), jckpt.load_checkpoint(d)
    assert set(state) == set(jstate)
    for key in ("v", "p", "rowmap"):
        assert state[key].dtype == jstate[key].dtype
        np.testing.assert_array_equal(state[key], jstate[key])
    np.testing.assert_array_equal(state["rowmap"], rowmap)
    np.testing.assert_array_equal(_port_solve(TM, 6, state).kernel,
                                  _port_solve(TM, 6).kernel)


def _write_step_directory(d, v, p, iteration, hosts, rowmap, meta):
    """The JAX package's per-host format (save_checkpoint_global,
    block_lanczos_tpu/utils/checkpoint.py:64-125) for `hosts` processes,
    each holding a band of rows as one shard per array, and its
    manifest."""
    step = f"step_{iteration:09d}"
    os.makedirs(os.path.join(d, step))
    band = len(v) // hosts
    arrays = {}
    for pid in range(hosts):
        payload = {"iteration": np.int64(iteration)}
        if pid == 0:
            payload["rowmap"] = rowmap
        for name, arr in (("v", v), ("p", p)):
            start = [pid * band] + [0] * (arr.ndim - 1)
            payload[f"{name}0_data"] = arr[pid * band:(pid + 1) * band]
            payload[f"{name}0_start"] = np.asarray(start, np.int64)
            payload[f"{name}_count"] = np.int64(1)
            arrays[name] = {"shape": list(arr.shape),
                            "dtype": str(arr.dtype)}
        np.savez_compressed(os.path.join(d, step, f"shard_{pid}.npz"),
                            **payload)
    manifest = {"iteration": iteration, "elapsed": 1.25, "timestamp": 0.0,
                "shape": list(v.shape), "step_dir": step,
                "shard_files": hosts, "arrays": arrays}
    manifest.update(meta)
    with open(os.path.join(d, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def test_jax_step_directory_loads_alike_in_both_packages(tmp_path,
                                                         jax_mesh_states):
    """A two-host step directory of the JAX mesh's band layout: both
    load_checkpoint functions give the same state, which the port resumes
    to its straight solve's kernel; a torn step (a shard at another
    iteration) is refused by both."""
    TM, saved, rowmap = jax_mesh_states
    d = str(tmp_path / "ck")
    _write_step_directory(d, *saved[2], 2, 2, rowmap,
                          {"field": "narrow", "prime": PRIME, "n": 4})
    jstate, tstate = jckpt.load_checkpoint(d), ckpt.load_checkpoint(d)
    assert set(jstate) == set(tstate)
    for key in jstate:
        if isinstance(jstate[key], np.ndarray):
            assert jstate[key].dtype == tstate[key].dtype
            np.testing.assert_array_equal(jstate[key], tstate[key])
        else:
            assert jstate[key] == tstate[key]
    np.testing.assert_array_equal(_port_solve(TM, 5, tstate).kernel,
                                  _port_solve(TM, 5).kernel)

    torn = os.path.join(d, "step_000000002", "shard_1.npz")
    with np.load(torn) as z:
        payload = {k: z[k] for k in z.files}
    payload["iteration"] = np.int64(1)
    np.savez_compressed(torn, **payload)
    for load in (jckpt.load_checkpoint, ckpt.load_checkpoint):
        with pytest.raises(ValueError, match="torn checkpoint"):
            load(d)
