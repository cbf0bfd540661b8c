"""Model sanity guards (port of the JAX package's `utils/checks.py`): the
CFL-violation and NaN detection that aborts with a location.

`stability_diagnostics` returns reduced scalars on the state's device,
through the `HaloOps` global reductions (`all_reduce` over a process
mesh, so every rank sees the same values and raises together); the
host-side `guard` brings them over in one copy and raises with the
offending location (global indices), like the reference's "cfl > 2 in
domain d01 at (i,j,k)" fatal message.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

_KEYS = ("cfl_x", "cfl_y", "cfl_z", "w_max", "theta_finite")


def stability_diagnostics(state: State, grid: Grid, dt: float, hx) -> Dict[str, torch.Tensor]:
    """Global max CFL numbers and w amplitude (0-d tensors; pmax-reduced)."""
    u_cfl = state["u"].abs().max() * dt * grid.rdx
    v_cfl = state["v"].abs().max() * dt * grid.rdy
    ph_full = grid.phb + state["ph"]
    dz = torch.clamp((ph_full[1:] - ph_full[:-1]) / c.G, min=1.0)
    w_c = 0.5 * (state["w"][:-1] + state["w"][1:])
    w_cfl = (w_c.abs() / dz).max() * dt
    return {
        "cfl_x": hx.pmax(u_cfl),
        "cfl_y": hx.pmax(v_cfl),
        "cfl_z": hx.pmax(w_cfl),
        "w_max": hx.pmax(state["w"].abs().max()),
        "theta_finite": all_finite(state["t"], hx),
    }


def all_finite(a: torch.Tensor, hx) -> torch.Tensor:
    """Whether `a` is finite on every block of `hx`'s mesh (a 0-d bool on
    every rank, so that all ranks raise together: a rank that raised alone
    would leave the others waiting in their next exchange)."""
    bad = (~torch.isfinite(a)).any().to(torch.float32)
    return hx.pmax(bad) == 0


def _global(idx, hx, shape):
    """A block's (k, j, i) index as the global one (numpy integers, as the
    reference's message prints them)."""
    k, j, i = idx
    m = hx.mesh
    if m is None:
        return k, j, i
    return k, j + m.iy * shape[-2], i + m.ix * shape[-1]


def guard(state: State, grid: Grid, dt: float, hx, step_idx: int,
          w_limit: float = 60.0, cfl_limit: float = 2.0) -> None:
    """Host-side check; raises FloatingPointError with the location on a
    violation (rerun from a restart file is the recovery)."""
    d = stability_diagnostics(state, grid, dt, hx)
    # the five scalars reach the host in one copy (float64 holds float32
    # values exactly)
    d = dict(zip(_KEYS, torch.stack([d[k].double() for k in _KEYS]).cpu().tolist()))
    if not d["theta_finite"]:
        t = state["t"].cpu().numpy()
        bad = np.argwhere(~np.isfinite(t))
        loc = tuple(_global(bad[0], hx, t.shape)) if len(bad) else "(on another block)"
        raise FloatingPointError(
            f"NaN in theta at step {step_idx}, first at (k,j,i)={loc}")
    if d["w_max"] > w_limit:
        w = state["w"].cpu().numpy()
        loc = tuple(_global(np.unravel_index(np.argmax(np.abs(w)), w.shape), hx, w.shape))
        raise FloatingPointError(
            f"|w| = {d['w_max']:.1f} m/s exceeds {w_limit} at step "
            f"{step_idx}, (k,j,i)={loc} — CFL/physics blowup")
    for ax in ("cfl_x", "cfl_y", "cfl_z"):
        if d[ax] > cfl_limit:
            raise FloatingPointError(
                f"{ax} = {d[ax]:.2f} > {cfl_limit} at step {step_idx}")
