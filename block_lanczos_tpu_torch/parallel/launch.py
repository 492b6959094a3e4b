"""Spawning the local ranks of a mesh.

One helper, `spawn`, starts K ranks on this host (torch.multiprocessing,
start method "spawn"), each of which joins the world
(multihost.init_distributed) and runs fn(rank, world_size, device, *args).
The CLI, the tests and chip_smoke.py all launch through it:

  * a rank's device: `devices[k]` for local rank k (CUDA ranks on their own
    cards over NCCL; several gloo ranks may share one card or the CPU);
  * the CUDA kernels are built once, here, before any rank starts (each
    rank then loads the built libraries);
  * when a rank fails, the others are killed and `spawn` raises
    RankFailed, with the failing rank's traceback; so does a wall-clock
    limit `wall_s`, when given;
  * the ranks' return values come back in local-rank order;
  * `preempt`, a shared int the caller also hands its ranks: while they
    run, the first SIGTERM or SIGINT to this process is stored there (the
    ranks, which do not receive it, poll it: utils/cli.py saves a
    checkpoint and exits), and a second kills the ranks, then this process
    by the signal's default action.

Several hosts: every host runs `spawn` with the same init method and world
size, and rank_offset = its first global rank.
"""

from __future__ import annotations

import os
import queue as queue_mod
import signal
import tempfile
import threading
import time

import torch
import torch.multiprocessing as mp

from block_lanczos_tpu_torch.parallel import multihost


class RankFailed(RuntimeError):
    """A rank of a spawned mesh failed, or the mesh outlived its limit."""


def _worker(local_rank, fn, args, init_method, world_size, rank_offset,
            backend, devices, timeout_s, results):
    import torch.distributed as dist
    device = torch.device(devices[local_rank])
    if device.type == "cpu":   # the host's cores, shared among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    rank = rank_offset + local_rank
    multihost.init_distributed(init_method, world_size, rank, backend,
                               timeout_s, device)
    try:
        out = fn(rank, world_size, device, *args)
    finally:
        dist.destroy_process_group()
    results.put((local_rank, out))


def _drain(results, got: dict) -> None:
    while True:
        try:
            k, out = results.get_nowait()
        except queue_mod.Empty:
            return
        got[k] = out


def _forward_signals(preempt, procs):
    """SIGTERM and SIGINT to this process while `procs` run: the first is
    stored in `preempt` (a shared int, 0 until then), a second kills the
    processes and then this one by the signal's default action.  Returns
    what puts the old handlers back (nothing to do outside the main
    thread, which alone takes handlers)."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None

    def on_signal(signum, frame):
        if preempt.value == 0:
            preempt.value = int(signum)
            return
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    old = {sig: signal.signal(sig, on_signal)
           for sig in (signal.SIGTERM, signal.SIGINT)}
    return lambda: [signal.signal(sig, h) for sig, h in old.items()]


def spawn(fn, devices, args=(), *, backend: str = "gloo",
          init_method: str | None = None, world_size: int | None = None,
          rank_offset: int = 0,
          timeout_s: float = multihost.DEFAULT_TIMEOUT_S,
          wall_s: float | None = None, preempt=None) -> list:
    """Run fn(rank, world_size, device, *args) on len(devices) local ranks
    and return their results in local-rank order.

    fn must be importable (a module-level function) and its arguments and
    result picklable.  init_method defaults to a file store in a fresh
    temporary directory (one host); world_size to the local rank count.
    timeout_s bounds each collective, wall_s the whole run.  preempt
    (a multiprocessing RawValue("i"), also in `args`) takes the signals
    this process receives while the ranks run.
    """
    devices = [str(d) for d in devices]
    nprocs = len(devices)
    world_size = nprocs if world_size is None else int(world_size)
    if any(torch.device(d).type == "cuda" for d in devices):
        from block_lanczos_tpu_torch import kernels
        kernels.load_all()
    with tempfile.TemporaryDirectory(prefix="bl_mesh_") as tmp:
        if init_method is None:
            init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = mp.get_context("spawn").Queue()
        ctx = mp.start_processes(
            _worker, args=(fn, tuple(args), init_method, world_size,
                           rank_offset, backend, devices, timeout_s,
                           results),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if wall_s is None else time.monotonic() + wall_s
        got = {}
        restore = (None if preempt is None
                   else _forward_signals(preempt, ctx.processes))
        try:
            while True:
                _drain(results, got)
                if ctx.join(timeout=0.05):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise RankFailed(f"the mesh outlived its {wall_s} s limit")
            _drain(results, got)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RankFailed(str(e)) from e
        finally:
            if restore is not None:
                restore()
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    if len(got) != nprocs:
        raise RankFailed(f"ranks {sorted(set(range(nprocs)) - set(got))} "
                         "returned nothing")
    return [got[k] for k in range(nprocs)]
