"""Process setup for a mesh (the port's counterpart of the reference's
`jax.distributed` setup in ``scripts/multihost_rehearsal.py``).

- `init_from_env` joins a process started by ``torchrun --nproc-per-node
  N`` to its group (``env://``; NCCL by default, one card per rank, the
  card ``cuda:{LOCAL_RANK}``).
- `spawn` starts `nprocs` fresh processes and joins them into one group
  over a ``file://`` rendezvous in a temporary directory, so that
  concurrent test workers never meet on a port.  It returns each rank's
  result; a rank that raises (or dies) makes it raise with that rank's
  traceback after the other ranks are stopped, so nothing hangs in an
  exchange that will never complete.  Before spawning ranks that use a
  card it builds every kernel library in the parent (`ops.build.build_all`),
  so that the ranks load them instead of each running nvcc.

Every group gets a timeout (`TIMEOUT_S`): a collective that a peer never
joins raises instead of blocking for ever.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 300.0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_from_env(backend: str = "nccl", timeout_s: float = TIMEOUT_S) -> int:
    """Join the group that torchrun describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); under NCCL also select the
    card ``cuda:{LOCAL_RANK}``.  Returns this process's rank."""
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def _rank_main(fn, rank: int, world: int, backend: str, device: Optional[str],
               init_method: str, timeout_s: float, args: tuple, results) -> None:
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, device, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], nprocs: int, backend: str = "gloo",
          devices: Optional[Sequence[Optional[str]]] = None, args: tuple = (),
          timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in `nprocs` new processes that form
    one process group over `backend`; return the results in rank order.

    `fn` must be importable by name (a module-level function) and its
    arguments and result picklable.  `devices` gives each rank its device
    (``"cpu"``, ``"cuda:0"``, ...; None leaves it to `fn`).  Raises
    RuntimeError with the traceback of the first rank that fails, and
    TimeoutError if the ranks have not all finished within `timeout_s`;
    either way every rank is stopped first."""
    devices = list(devices) if devices is not None else [None] * nprocs
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if any(d is not None and torch.device(d).type == "cuda" for d in devices):
        raise ValueError("the frozen reference runs no process on the card")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nprocs, backend, devices[r], init, timeout_s,
                                   args, results), daemon=True)
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        try:
            _collect(procs, results, out, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.is_alive() and len(out) < nprocs:
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(nprocs)]


def _collect(procs, results, out: dict, deadline: float) -> None:
    """Read every rank's result into `out`; raise on the first failure."""
    quiet_since = {}
    while len(out) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.1)
        except queue.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in out or p.exitcode is None:
                    continue
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                       "without reporting")
                # exited cleanly: its result is still in the pipe, or lost
                if now - quiet_since.setdefault(r, now) > 10.0:
                    raise RuntimeError(f"rank {r} exited without a result")
            if now > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(out))} "
                                   "did not finish in time")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        out[rank] = payload
