"""History and restart I/O (port of the JAX package's `io/history.py`).

Two containers, chosen by the file's extension:

- **netCDF classic** (``.nc``) through the native backend (`io/netcdf.py`),
  files with WRF's dimension names (bottom_top/south_north/west_east),
  history written through the C++ quilt writer pool;
- **npz** when no C++ toolchain builds the backend.

Both hold the same bits as the reference's files, so that a file written by
either package reads back in the other.  The registry decides what goes in
each stream, as the Registry's `h`/`r` flags do: the history stream holds
`history_names(cfg)` plus the eta levels; the restart stream holds
`restart_names(cfg)` with the step and the time, raw IEEE bits for an
exact resume.

A dump leaves the device in one pass: every field's copy is queued into
one pinned host buffer, then one device synchronisation closes them all.
Under a process mesh `models.driver.Simulation` gathers the state to rank
0 first, which writes the global fields alone (`parallel.sharded.gather`).
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.io import netcdf as ncio
from wrfchem_arc_interactions_tpu_torch.registry.state import (
    State, history_names, restart_names,
)

_EXECUTOR = ThreadPoolExecutor(max_workers=2)  # npz-fallback async writes
_PENDING: List[Future] = []                     # their futures, read by flush()

_DIM_BASES = ("bottom_top", "south_north", "west_east")
_ALIGN = 64


def gather(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host numpy copies of `tensors`.  From the GPU every copy is queued
    (``non_blocking``) into one pinned buffer, then one synchronisation
    waits for all of them; on the CPU the fields are copied (an async npz
    write may outlive the state)."""
    if not any(t.is_cuda for t in tensors.values()):
        return {n: t.detach().numpy().copy() for n, t in tensors.items()}
    offsets: Dict[str, Tuple[int, int]] = {}
    total = 0
    for n, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        offsets[n] = (total, nbytes)
        total += -(-nbytes // _ALIGN) * _ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    out = {}
    for n, t in tensors.items():
        off, nbytes = offsets[n]
        host = buf[off:off + nbytes].view(t.dtype).view(t.shape)
        host.copy_(t.detach(), non_blocking=True)
        out[n] = host
    torch.cuda.synchronize()
    return {n: h.numpy() for n, h in out.items()}


def _gather_names(state: State, names: Iterable[str]) -> Dict[str, np.ndarray]:
    return gather({n: state[n] for n in names if n in state})


def default_extension() -> str:
    return ".nc" if ncio.available() else ".npz"


def _dim_names(cfg: Config, name: str, shape) -> list:
    """WRF dimension names; lengths that differ from the mass-point grid
    get a length suffix so that netCDF dimension names stay unique per
    length."""
    expect = (cfg.domain.nz, cfg.domain.ny, cfg.domain.nx)
    # 1D z-coordinate arrays (znu/znw, length nz or nz+1) would otherwise
    # right-align against west_east; give them the WRF vertical dim name
    if len(shape) == 1 and shape[0] in (cfg.domain.nz, cfg.domain.nz + 1):
        return ["bottom_top" if shape[0] == cfg.domain.nz else "bottom_top_stag"]
    k = min(len(shape), 3)
    lead = [f"{name}_d{i}" for i in range(len(shape) - k)]
    tail = []
    for base, n, size in zip(_DIM_BASES[3 - k:], expect[3 - k:], shape[-k:]):
        tail.append(base if size == n else f"{base}{size}")
    return lead + tail


def _write_nc(path: str, cfg: Config, data: Dict[str, np.ndarray],
              attrs: Dict[str, float], async_write: bool) -> None:
    w = ncio.NetCDFWriter()
    for n, a in data.items():
        w.put_var(n, a, _dim_names(cfg, n, a.shape))
    for k, v in attrs.items():
        w.put_att(k, v)
    w.put_att("title", "wrfchem-arc-interactions-tpu")
    w.write(path, async_write=async_write)


def write_history(path: str, cfg: Config, grid: Grid, state: State,
                  time_s: float, async_write: bool = True) -> None:
    data = _gather_names(state, history_names(cfg))
    data["znu"] = grid.znu.cpu().numpy()
    data["znw"] = grid.znw.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".nc"):
        _write_nc(path, cfg, data, {"_time_s": float(time_s)}, async_write)
    else:
        data["_time_s"] = np.float64(time_s)
        if async_write:
            _PENDING.append(_EXECUTOR.submit(np.savez_compressed, path, **data))
        else:
            np.savez_compressed(path, **data)


def write_restart(path: str, cfg: Config, state: State, step_idx: int,
                  time_s: float) -> None:
    """Restart dump: every Registry `r` field, exact IEEE bits (synchronous:
    a restart is durable when the call returns)."""
    data = _gather_names(state, restart_names(cfg))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".nc"):
        _write_nc(path, cfg, data,
                  {"_step_idx": float(step_idx), "_time_s": float(time_s)},
                  async_write=False)
    else:
        data["_step_idx"] = np.int64(step_idx)
        data["_time_s"] = np.float64(time_s)
        np.savez(path, **data)


def read_restart(path: str, cfg: Config, state: State, mesh=None):
    """Load a restart into a copy of `state`; returns (state, step, time).
    Each field read comes back on its state tensor's device and in its
    dtype; fields absent from the file keep their values.  The file holds
    the global domain: with a process `mesh` (`parallel.mesh`) every rank
    reads it and keeps its block (`state` is the rank's block), so a
    restart written on one decomposition reads on any other."""
    if path.endswith(".nc"):
        f, attrs = ncio.read_netcdf(path)
        step = int(attrs["_step_idx"])
        time_s = float(attrs["_time_s"])
    else:
        with np.load(path) as z:
            f = {k: z[k] for k in z.files}
        step = int(f["_step_idx"])
        time_s = float(f["_time_s"])
    out = dict(state)
    for n in restart_names(cfg):
        if n in f:
            ref = state[n]
            a = torch.from_numpy(np.ascontiguousarray(f[n]))
            if mesh is not None:
                a = mesh.cut(a)
            out[n] = a.to(device=ref.device, dtype=ref.dtype)
    return out, step, time_s


def read_history(path: str):
    """Read one history dump back: (fields dict, time_s)."""
    if path.endswith(".nc"):
        f, attrs = ncio.read_netcdf(path)
        return f, float(attrs["_time_s"])
    with np.load(path) as z:
        f = {k: z[k] for k in z.files}
    return f, float(f.pop("_time_s"))


def flush() -> None:
    """Block until pending async writes land (end-of-run barrier): both the
    native quilt pool and the npz thread pool.  Raises if a write failed."""
    while _PENDING:
        _PENDING.pop(0).result()
    if ncio.available():
        ncio.drain()
