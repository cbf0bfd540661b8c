"""Specified / relaxation lateral boundary conditions, the real-data
boundary scheme (port of the JAX package's `models/lateral_bc.py`;
canonical share/module_bc.F spec_bdy_* / relax_bdy_* behind specified =
.true. in &bdy_control).

The scheme (Davies & Turner 1977 as WRF implements it):

- a SPEC zone (the outermost ``spec_zone`` rows, default 1) where the
  prognostic fields are SET to the boundary values, interpolated linearly
  in time between two bracketing boundary snapshots (the wrfbdy stream);
- a RELAX zone (the next ``relax_zone`` rows, default 4) where the fields
  are nudged toward the boundary values with inward-decaying weights,
  F1 = w / (10 dt) on the deviation and F2 = w / (50 dt) on its Laplacian,
  w tapering from ~1 to 0 across the zone.

The zone weights are (ny, nx) masks made once; each step's update is a
few elementwise passes over each forced field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class LateralBoundary:
    """Boundary forcing: two bracketing snapshots of the forced fields.

    ``lo``/``hi``: full-domain target tensors by field name (only their
    boundary zones are read); ``t_lo``/``t_hi``: their model times [s].
    """

    lo: Dict[str, torch.Tensor]
    hi: Dict[str, torch.Tensor]
    t_lo: float
    t_hi: float

    def at_time(self, time_s) -> Dict[str, torch.Tensor]:
        """The targets at model time `time_s`, interpolated linearly and
        held at the ends; the weight is formed in the fields' type, as the
        reference forms it in its arrays' type."""
        dtype = next(iter(self.lo.values())).dtype
        t, t_lo, t_hi = (torch.tensor(float(x), dtype=dtype)
                         for x in (time_s, self.t_lo, self.t_hi))
        f = torch.clamp((t - t_lo) / torch.clamp(t_hi - t_lo, min=1e-6), 0.0, 1.0)
        return {k: (1.0 - f) * self.lo[k] + f * self.hi[k] for k in self.lo}

    def to(self, device: DeviceLike) -> "LateralBoundary":
        return dataclasses.replace(self, lo={k: v.to(device) for k, v in self.lo.items()},
                                   hi={k: v.to(device) for k, v in self.hi.items()})


def constant_boundary(fields: Dict[str, torch.Tensor]) -> LateralBoundary:
    """A time-invariant boundary target (a steady inflow)."""
    return LateralBoundary(lo=dict(fields), hi=dict(fields), t_lo=0.0, t_hi=1.0)


def zone_masks(ny: int, nx: int, spec_zone: int = 1, relax_zone: int = 4,
               x_sides: Tuple[bool, bool] = (True, True),
               y_sides: Tuple[bool, bool] = (True, True),
               dtype=np.float32):
    """(spec_mask, relax_w) numpy arrays: spec_mask is 1 in the outermost
    spec_zone rows; relax_w ramps from ~1 (just inside the spec zone) to 0
    at the inner edge of the relax zone with WRF's exponential taper."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    dist = np.full((ny, nx), 10 ** 9)
    if x_sides[0]:
        dist = np.minimum(dist, ii)
    if x_sides[1]:
        dist = np.minimum(dist, nx - 1 - ii)
    if y_sides[0]:
        dist = np.minimum(dist, jj)
    if y_sides[1]:
        dist = np.minimum(dist, ny - 1 - jj)
    spec = (dist < spec_zone).astype(dtype)
    n = dist - spec_zone + 1                      # 1..relax_zone inside the zone
    in_relax = (dist >= spec_zone) & (dist < spec_zone + relax_zone)
    # WRF taper: weight ~ (zone+1-n)/zone * exp(-(n-1)/2)
    w = np.where(in_relax,
                 (relax_zone + 1.0 - n) / relax_zone * np.exp(-(n - 1) / 2.0),
                 0.0).astype(dtype)
    return spec, w


@dataclasses.dataclass(frozen=True)
class SpecifiedBC:
    """The specified/relaxation boundary operator.

    ``spec_names`` are SET in the spec zone; ``relax_names`` are also
    nudged in the relax zone: every forced field but the geopotential,
    which the dycore re-diagnoses from mu and theta (nudging it fights the
    model's own hydrostatic adjustment).
    """

    spec_mask: torch.Tensor       # (ny, nx) 1 in the set zone
    relax_w: torch.Tensor         # (ny, nx) inward-decaying relax weight
    spec_names: Tuple[str, ...]
    relax_names: Tuple[str, ...]

    def apply(self, state: State, bdy: LateralBoundary, time_s, dt,
              hx: Optional[HaloOps] = None) -> State:
        """The state with the Davies zones applied toward `bdy` at `time_s`.
        On a block of a process mesh pass the model's `hx` (and the
        block's masks and boundary data): the deviation's Laplacian then
        takes its halo from the neighbouring blocks at seams, and
        edge-replicates only at the domain's edge."""
        ring = HaloOps(bc_x=BCKind.OPEN, bc_y=BCKind.OPEN,
                       mesh=None if hx is None else hx.mesh)
        tgt = bdy.at_time(time_s)
        out = dict(state)
        f1 = self.relax_w / (10.0 * dt)
        f2 = self.relax_w / (50.0 * dt)
        spec = self.spec_mask
        for name in self.spec_names:
            if name not in state or name not in tgt:
                continue
            q = state[name]
            t = tgt[name]
            if name in self.relax_names:
                dev = t - q
                # 5-point Laplacian of the deviation, edge-replicated at the
                # domain boundary (so it vanishes on the outermost ring),
                # exchanged at block seams
                devp = ring.pad(dev, 1)
                lap = (devp[..., 1:-1, 2:] + devp[..., 1:-1, :-2]
                       + devp[..., 2:, 1:-1] + devp[..., :-2, 1:-1]
                       - 4.0 * dev)
                q = q + dt * (f1 * dev + f2 * lap)
            out[name] = spec * t + (1.0 - spec) * q
        return out


def make_specified_bc(cfg, grid, names: Optional[Tuple[str, ...]] = None,
                      dtype: torch.dtype = torch.float32, mesh=None) -> SpecifiedBC:
    """The operator of `cfg`'s specified sides, its masks on `grid`'s
    device in `dtype` (float32, as the reference keeps them).  The masks
    are made on the global domain; with a process `mesh` each rank keeps
    its block of them."""
    d = cfg.domain
    dyn = cfg.dynamics
    x_on = dyn.bc_x == BCKind.SPECIFIED
    y_on = dyn.bc_y == BCKind.SPECIFIED
    spec, w = zone_masks(d.ny, d.nx, dyn.spec_zone, dyn.relax_zone,
                         x_sides=(x_on, x_on), y_sides=(y_on, y_on))
    if names is None:
        names = ("u", "v", "w", "t", "mu", "ph", "qv")
    relax = tuple(n for n in names if n != "ph")

    def put(a):
        t = torch.from_numpy(a)
        if mesh is not None:
            t = mesh.cut(t)
        return t.to(dtype=dtype, device=grid.device)

    return SpecifiedBC(spec_mask=put(spec), relax_w=put(w), spec_names=tuple(names),
                       relax_names=relax)
