"""Plain version of the port's fused multi-tracer RK-stage update (the
port's `ops/tracers_kernel.py`, frozen): the kernel's wrapper is replaced by
its plain version, on every device.  On the card the stack goes through it
`CUDA_SLICE` tracers at a time: each tracer's update is its own, and the
whole stack's temporaries at 500x500x60 would not fit beside the state.
"""

from __future__ import annotations

from typing import Optional

import torch

from port_bench.reference.wrf.dycore import advection as adv
from port_bench.reference.wrf.grid import Grid
from port_bench.reference.wrf.parallel.halo import HaloOps

def map_factor_sq(grid: Grid) -> Optional[torch.Tensor]:
    """msft^2 (ny, nx) of a projected grid, None on a flat one."""
    return grid.msft * grid.msft if grid.has_msf else None


def advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                             grid: Grid, hx: HaloOps, dts: float,
                             pt: Optional[torch.Tensor] = None, pd: bool = False,
                             clip: bool = False) -> torch.Tensor:
    """Plain version: the stacked (nt, ...) chain of `dycore.advection` in
    the operation order of the reference's scan body."""
    fx, fy, fz = adv.scalar_fluxes(q_pad, ru_pad, rv_pad, ww, 5, 3)
    if pd:
        fx, fy, fz = adv.pd_limit(q_pad, phi_old, fx, fy, fz, ru_pad, rv_pad, ww,
                                  dts, grid, hx)
    tend = adv.flux_div(fx, fy, fz, grid, m_h=map_factor_sq(grid))
    if pt is not None:
        tend = tend + mu_full[None, None] * pt
    qn = (phi_old + dts * tend) / mu_new[None, None]
    if clip:
        qn = torch.clamp(qn, min=0.0)
    return qn


CUDA_SLICE = 4           # tracers per plain pass on the card


def advect_tracers(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                   grid: Grid, hx: HaloOps, dts: float,
                   pt: Optional[torch.Tensor] = None, pd: bool = False,
                   clip: bool = False) -> torch.Tensor:
    """New stage values (nt, nz, ny, nx) of a tracer stack, by the plain
    version (in slices of tracers on the card)."""
    if q_pad.device.type != "cuda":
        return advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full,
                                        mu_new, grid, hx, dts, pt, pd, clip)
    out = torch.empty_like(phi_old)
    for a in range(0, q_pad.shape[0], CUDA_SLICE):
        b = a + CUDA_SLICE
        out[a:b] = advect_tracers_reference(
            q_pad[a:b], phi_old[a:b], ru_pad, rv_pad, ww, mu_full, mu_new, grid, hx, dts,
            None if pt is None else pt[a:b], pd, clip)
    return out
