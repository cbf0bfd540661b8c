"""Real-data initialisation, the real.exe analog (port of the JAX package's
`models/real.py`; canonical main/real_em.F and the vertical interpolation
and hydrostatic rebalance of share/input_wrf.F).

Pipeline, mirroring the met_em -> wrfinput/wrfbdy flow:

1. `AnalysisSnapshot` is the met_em.* analog: gridded analysis fields (T,
   qv, u, v on pressure levels, surface pressure, terrain) at one valid
   time, read from WPS intermediate files (`io.wps_intermediate`) or made
   by `synthetic_analysis`, a time-evolving baroclinic analysis.
2. `real_init` builds the model grid over the analysis terrain (and map
   projection), derives the base-state sounding from the domain-mean
   analysis profile, interpolates each column from pressure levels to the
   model's eta levels (linear in ln p) and rebalances hydrostatically
   (`ideal.balance_columns`).
3. `boundary_stream` turns consecutive snapshots into time-bracketed
   `LateralBoundary` segments for the Davies zones (the wrfbdy analog).

All of it runs on the host in numpy float64, as the reference does; only
the finished fields are cast and moved to the device.  The column
interpolation is vectorised over the columns and equals numpy's per-column
``np.interp`` bit for bit (the same arithmetic per element).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid.grid import Grid, make_grid
from wrfchem_arc_interactions_tpu_torch.models import ideal
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import (
    LateralBoundary, constant_boundary,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import State, build_state
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils.device import (
    DeviceLike, resolve_device, to_numpy64,
)


@dataclasses.dataclass(frozen=True)
class AnalysisSnapshot:
    """One gridded analysis valid time (the met_em.* file analog).

    3D arrays are (np_levels, ny, nx) with p_levels DECREASING (surface
    first, like the model's eta ordering); 2D arrays are (ny, nx).
    """

    time_s: float
    p_levels: np.ndarray      # (np,) [Pa], decreasing
    t: np.ndarray             # (np, ny, nx) temperature [K]
    qv: np.ndarray            # (np, ny, nx) vapor mixing ratio [kg/kg]
    u: np.ndarray             # (np, ny, nx) x-wind [m/s]
    v: np.ndarray             # (np, ny, nx) y-wind [m/s]
    p_sfc: np.ndarray         # (ny, nx) surface pressure [Pa]
    ht: np.ndarray            # (ny, nx) terrain height [m]


def synthetic_analysis(cfg: Config, times_s: Sequence[float],
                       delta_t: float = 10.0, u0: float = 12.0,
                       advect_speed: float = 15.0,
                       terrain_amp: float = 0.0) -> List[AnalysisSnapshot]:
    """A time-evolving baroclinic analysis: a meridional temperature
    gradient (delta_t across the domain) with westerly shear, and a warm
    anomaly that advects eastward at ``advect_speed`` so that the inflow
    boundary changes between snapshots; a Gaussian ridge of height
    `terrain_amp` across x.  20 pressure levels from 1000 to 150 hPa."""
    d = cfg.domain
    ny, nx = d.ny, d.nx
    n_lev = 20
    p_levels = np.linspace(1000e2, 150e2, n_lev)          # decreasing
    yy = (np.arange(ny) + 0.5) / ny - 0.5                 # -0.5..0.5
    xx = (np.arange(nx) + 0.5) / nx
    out = []
    ht = (terrain_amp * np.exp(-((np.arange(nx) - nx / 2.0) / (nx / 8.0)) ** 2)
          [None, :] * np.ones((ny, 1)))
    for t_s in times_s:
        # reference T profile ~ standard atmosphere in p
        t_ref = 288.0 * (p_levels / 1000e2) ** 0.19
        t3 = np.broadcast_to(t_ref[:, None, None], (n_lev, ny, nx)).copy()
        # meridional gradient, decaying aloft
        decay = np.clip((p_levels - 200e2) / 800e2, 0.0, 1.0)
        t3 += -delta_t * yy[None, :, None] * decay[:, None, None]
        # eastward-advecting warm anomaly (what the west boundary sees)
        xc = (0.2 + advect_speed * t_s / (nx * d.dx)) % 1.0
        dist = np.minimum(np.abs(xx - xc), 1.0 - np.abs(xx - xc))
        bump = 3.0 * np.exp(-(dist / 0.12) ** 2)
        t3 += bump[None, None, :] * decay[:, None, None]
        # thermal-wind-ish shear: u grows with height, stronger with dT/dy
        zfac = np.log(1000e2 / p_levels)
        u3 = (u0 + 8.0 * zfac[:, None, None] * (0.5 + yy[None, :, None]))
        u3 = np.broadcast_to(u3, (n_lev, ny, nx)).copy()
        v3 = np.zeros((n_lev, ny, nx))
        # moisture: ~80% RH near the surface, decaying aloft
        es = 611.2 * np.exp(17.67 * (t3 - 273.15) / (t3 - 29.65))
        qvs = 0.622 * es / np.maximum(p_levels[:, None, None] - es, 1.0)
        qv3 = 0.8 * qvs * np.clip((p_levels / 1000e2)[:, None, None] ** 3,
                                  0.02, 1.0)
        # surface pressure: hydrostatic reduction over terrain
        p_sfc = 1000e2 * np.exp(-ht / (c.R_D * t3[0] / c.G))
        out.append(AnalysisSnapshot(
            time_s=float(t_s), p_levels=p_levels, t=t3, qv=qv3, u=u3, v=v3,
            p_sfc=p_sfc, ht=ht))
    return out


def _interp_ln_p(p_target: np.ndarray, p_levels: np.ndarray,
                 field: np.ndarray) -> np.ndarray:
    """Column-wise linear-in-ln(p) interpolation of (np, ny, nx) `field` to
    (nz, ny, nx) target pressures, held at the end values outside the
    analysis levels (persistence below the lowest and above the highest).

    Every column shares the source levels, so one search places every
    target; each element then takes numpy's ``np.interp`` arithmetic:
    the end value outside, the level's value on a level, else
    ``slope * (x - x_j) + f_j`` with ``slope = (f_j+1 - f_j) / (x_j+1 - x_j)``.
    """
    ln_src = np.log(p_levels)[::-1]                  # increasing
    f_src = field[::-1]
    n = len(ln_src)
    ln_t = np.log(np.maximum(p_target, 1.0))
    j = np.searchsorted(ln_src, ln_t, side="right") - 1     # x_j <= x < x_j+1
    jc = np.clip(j, 0, n - 2)
    x0, x1 = ln_src[jc], ln_src[jc + 1]
    f0 = np.take_along_axis(f_src, jc, axis=0)
    f1 = np.take_along_axis(f_src, jc + 1, axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        inner = (f1 - f0) / (x1 - x0) * (ln_t - x0) + f0
    out = np.where(ln_t == x0, f0, inner)
    out = np.where(j < 0, f_src[0], out)
    return np.where(j >= n - 1, f_src[n - 1], out)


def _mean_theta_of_z(snap: AnalysisSnapshot) -> Callable:
    """Base-state sounding theta(z) from the domain-mean analysis profile
    (keeps the perturbations small everywhere)."""
    t_mean = snap.t.mean(axis=(1, 2))
    p = snap.p_levels
    theta = t_mean * (c.P0 / p) ** c.RCP
    # hydrostatic heights of the analysis levels from the mean profile
    z = np.zeros_like(p)
    for k in range(1, len(p)):
        t_half = 0.5 * (t_mean[k - 1] + t_mean[k])
        z[k] = z[k - 1] + c.R_D * t_half / c.G * np.log(p[k - 1] / p[k])
    z_grid, th_grid = z.copy(), theta.copy()

    def theta_of_z(zq):
        return np.interp(np.asarray(zq, np.float64), z_grid, th_grid)

    return theta_of_z


def interp_to_model(grid: Grid, snap: AnalysisSnapshot,
                    n_outer: int = 2) -> Dict[str, np.ndarray]:
    """Interpolate one snapshot to the model grid and rebalance
    hydrostatically: full-domain float64 numpy fields {u, v, w, t, mu, ph,
    qv}, a state fill or a boundary target."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    znu = to_numpy64(grid.znu)
    mub = to_numpy64(grid.mub)
    p_top = grid.p_top
    mu_est = np.asarray(snap.p_sfc, np.float64) - p_top
    t_pert = mu_pert = ph_pert = None
    for _ in range(n_outer):
        # target full pressures at mass levels from the current mu estimate
        p_t = znu[:, None, None] * mu_est[None] + p_top
        t_col = _interp_ln_p(p_t, snap.p_levels, snap.t)
        qv_col = np.maximum(_interp_ln_p(p_t, snap.p_levels, snap.qv), 0.0)
        theta = t_col * (c.P0 / p_t) ** c.RCP
        t_pert, mu_pert, ph_pert, _ = ideal.balance_columns(
            grid, theta, qv_col, p_sfc=np.asarray(snap.p_sfc, np.float64))
        mu_est = mub + mu_pert
    p_t = znu[:, None, None] * mu_est[None] + p_top
    u_col = _interp_ln_p(p_t, snap.p_levels, snap.u)
    v_col = _interp_ln_p(p_t, snap.p_levels, snap.v)
    qv_col = np.maximum(_interp_ln_p(p_t, snap.p_levels, snap.qv), 0.0)
    return {
        "u": u_col, "v": v_col,
        "w": np.zeros((nz + 1, ny, nx)),
        "t": t_pert, "mu": mu_pert, "ph": ph_pert, "qv": qv_col,
    }


def _put(a: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dtype).to(device)


def real_init(cfg: Config, snapshots: Sequence[AnalysisSnapshot], projection=None,
              device: DeviceLike = None, dtype: torch.dtype = torch.float32
              ) -> Tuple[Grid, State, List[LateralBoundary]]:
    """The real.exe pipeline on `device` (default ``cuda``; raises if there
    is none and the CPU was not asked for): (grid, balanced initial state,
    boundary segments) from a time-ordered analysis sequence."""
    dev = resolve_device(device)
    snap0 = snapshots[0]
    grid = make_grid(cfg, _mean_theta_of_z(snap0), dev,
                     terrain=snap0.ht if np.any(snap0.ht != 0.0) else None,
                     projection=projection, dtype=dtype)
    fields0 = interp_to_model(grid, snap0)
    state = build_state(cfg, dev, dtype)
    for k, v in fields0.items():
        if k in state:
            state[k] = _put(v, dev, dtype)
    segments = boundary_stream(grid, cfg, snapshots, dtype)
    return grid, state, segments


def boundary_stream(grid: Grid, cfg: Config, snapshots: Sequence[AnalysisSnapshot],
                    dtype: torch.dtype = torch.float32) -> List[LateralBoundary]:
    """Bracketing `LateralBoundary` segments between consecutive snapshots
    on the grid's device (the wrfbdy_d01 stream analog): `Simulation`
    interpolates in time within a segment, and the caller sets
    ``sim.boundary`` to the next one as model time crosses its end.  One
    snapshot gives one constant segment."""
    targets = [{k: _put(v, grid.device, dtype) for k, v in interp_to_model(grid, s).items()}
               for s in snapshots]
    segs = [LateralBoundary(lo=a, hi=b, t_lo=float(sa.time_s), t_hi=float(sb.time_s))
            for a, b, sa, sb in zip(targets[:-1], targets[1:], snapshots[:-1],
                                    snapshots[1:])]
    return segs or [constant_boundary(targets[0])]
