"""Ideal-case initialisation (port of the JAX package's `models/ideal.py`;
canonical dyn_em/module_initialize_<case>.F).

The initial state satisfies the discrete hydrostatic balance of the model's
own operators, so an unperturbed column is a stationary point of
`dycore.solve.step` to rounding.  The construction runs on the host in numpy
float64 from the float32 grid (as the reference reads its float32 grid
back), and only the finished fields are cast and moved to the device.

Ported cases: ``squall2d_x`` (BASELINE config 2/3's case), ``warm_bubble``
and ``quiescent``; the others come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid import Grid, make_grid
from wrfchem_arc_interactions_tpu_torch.models import soundings
from wrfchem_arc_interactions_tpu_torch.registry.state import State, build_state
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils.device import (
    DeviceLike, resolve_device, to_numpy64,
)
from wrfchem_arc_interactions_tpu_torch.utils.support import SLICE_PHYS


def _eps_w_np(qtot: np.ndarray, fnm: np.ndarray, fnp: np.ndarray) -> np.ndarray:
    """numpy mirror of ops.stencil.avg_z_centers_to_faces for 1/(1+qtot)."""
    eps = 1.0 / (1.0 + qtot)
    shp = (-1,) + (1,) * (eps.ndim - 1)
    inner = fnp[1:].reshape(shp) * eps[:-1] + fnm[1:].reshape(shp) * eps[1:]
    return np.concatenate([eps[:1], inner, eps[-1:]], axis=0)


def balance_columns(grid: Grid, theta: np.ndarray, qv: np.ndarray,
                    p_sfc=c.P0, n_iter: int = 30):
    """Hydrostatically balance (theta, qv) columns on the model grid.

    theta, qv: (nz, ny, nx) float64 full fields.  Returns (t_pert, mu_pert,
    ph_pert, p_half) as float64 numpy arrays.
    """
    p_sfc = np.asarray(p_sfc, np.float64)
    znu = to_numpy64(grid.znu)
    dnw = to_numpy64(grid.dnw)
    dn = np.zeros_like(znu)
    dn[1:] = znu[1:] - znu[:-1]
    fnm = to_numpy64(grid.fnm)
    fnp = to_numpy64(grid.fnp)
    nz = len(znu)

    theta = np.asarray(theta, np.float64)
    qv = np.asarray(qv, np.float64)
    theta_m = theta * (1.0 + c.RVOVRD * qv)
    eps_w = _eps_w_np(qv, fnm, fnp)
    inv_eps_w = 1.0 / eps_w

    p_top = grid.p_top
    mu_d = np.full(theta.shape[1:], p_sfc - p_top)
    p = np.empty_like(theta)
    for _ in range(n_iter):
        # march the moist hydrostatic pressure down from p_top, then scale
        # the column dry mass so the surface pressure matches p_sfc
        p[-1] = p_top + (znu[-1] - 0.0) * mu_d * inv_eps_w[-1]
        for k in range(nz - 2, -1, -1):
            p[k] = p[k + 1] - dn[k + 1] * mu_d * inv_eps_w[k + 1]
        p_sfc_col = p[0] - (znu[0] - 1.0) * mu_d * inv_eps_w[0]
        resid = np.max(np.abs(p_sfc_col - p_sfc))
        mu_d = mu_d * (p_sfc - p_top) / (p_sfc_col - p_top)
        if resid < 1e-9:
            break

    alpha_d = (c.R_D * theta_m / c.P0) * (p / c.P0) ** c.CVPM
    phb = to_numpy64(grid.phb)
    ph = np.empty((nz + 1,) + theta.shape[1:])
    ph[0] = phb[0]
    for k in range(nz):
        ph[k + 1] = ph[k] - dnw[k] * mu_d * alpha_d[k]

    t_pert = theta - c.T0
    mu_pert = mu_d - to_numpy64(grid.mub)
    ph_pert = ph - phb
    return t_pert, mu_pert, ph_pert, p


def _z_half(grid: Grid) -> np.ndarray:
    z_w = to_numpy64(grid.phb) / c.G
    return 0.5 * (z_w[:-1] + z_w[1:])


def _bubble(grid: Grid, amplitude: float, xc: Optional[float], zc: float,
            xr: float, zr: float, yc: Optional[float] = None,
            yr: Optional[float] = None) -> np.ndarray:
    """Cosine-squared thermal perturbation (nz, ny, nx); xc=None is uniform
    in x, yc=None uniform in y."""
    x = (np.arange(grid.nx) + 0.5) * grid.dx
    y = (np.arange(grid.ny) + 0.5) * grid.dy
    z = _z_half(grid)
    dist2 = ((z - zc) / zr) ** 2
    if xc is not None:
        dist2 = dist2 + ((x[None, None, :] - xc) / xr) ** 2
    if yc is not None:
        dist2 = dist2 + ((y[None, :, None] - yc) / yr) ** 2
    dist = np.sqrt(dist2)
    return np.where(dist < 1.0, amplitude * np.cos(0.5 * np.pi * dist) ** 2, 0.0)


def init_balanced(cfg: Config, grid: Grid,
                  theta_full: np.ndarray, qv: np.ndarray,
                  u: Optional[np.ndarray] = None,
                  v: Optional[np.ndarray] = None,
                  tsk: Optional[float] = None,
                  p_sfc=c.P0) -> State:
    """Build a state on the grid's device from full (theta, qv) fields and
    optional winds."""
    state = build_state(cfg, grid.device)
    t_pert, mu_pert, ph_pert, p = balance_columns(grid, theta_full, qv, p_sfc)

    def put(a, shape=None):
        a = np.asarray(a, np.float64)
        if shape is not None:
            a = np.broadcast_to(a, shape)
        return torch.from_numpy(np.array(a)).to(
            dtype=state["t"].dtype, device=grid.device)

    state["t"] = put(t_pert)
    state["mu"] = put(mu_pert)
    state["ph"] = put(ph_pert)
    if "qv" in state:
        state["qv"] = put(qv)
    if u is not None:
        state["u"] = put(u, state["u"].shape)
    if v is not None:
        state["v"] = put(v, state["v"].shape)
    if tsk is None:
        tsk = float(theta_full[0].mean() * (p[0].mean() / c.P0) ** c.RCP)
    state["tsk"] = torch.full_like(state["tsk"], tsk)
    return state


def warm_bubble(cfg: Config, grid: Grid, amplitude: float = 2.0,
                zc: float = 1500.0, xr: float = 4000.0, zr: float = 1500.0,
                three_d: bool = False, xc_frac: float = 0.5) -> State:
    """Dry rising warm bubble — the basic dycore validation case."""
    theta0 = to_numpy64(grid.t_init)
    xc = xc_frac * grid.nx * grid.dx
    yc = 0.5 * grid.ny * grid.dy if three_d else None
    yr = xr if three_d else None
    theta = theta0 + _bubble(grid, amplitude, xc, zc, xr, zr, yc, yr)
    qv = np.zeros((grid.nz, grid.ny, grid.nx))
    return init_balanced(cfg, grid, theta, qv)


def squall_line_x(cfg: Config, grid: Grid, bubble_amp: float = 3.0,
                  shear_depth: float = 2500.0, u_shear: float = -12.0) -> Tuple[State, Grid]:
    """2D (x-z) squall line: Weisman-Klemp sounding, low-level shear, line
    thermal trigger (canonical module_initialize_squall2d_x.F)."""
    z = _z_half(grid)
    theta_fn = soundings.weisman_klemp_theta()
    rh_fn = soundings.weisman_klemp_rh()
    theta0 = theta_fn(z)
    # first-guess pressure from the grid base state for qv, then once more
    # from the balanced pressure
    pb = to_numpy64(grid.pb)
    qv = soundings.qv_from_rh(theta0, pb, rh_fn(z))
    _, _, _, p = balance_columns(grid, theta0, qv)
    qv = soundings.qv_from_rh(theta0, p, rh_fn(z))
    theta = theta0 + _bubble(grid, bubble_amp, 0.5 * grid.nx * grid.dx, 1500.0,
                             4000.0, 1500.0)
    u_prof = np.where(z < shear_depth, u_shear * (1.0 - z / shear_depth), 0.0)
    state = init_balanced(cfg, grid, theta, qv, u=u_prof)
    return state, grid


def make_case(cfg: Config, case: str = "warm_bubble", device: DeviceLike = None,
              **kw):
    """(grid, state) for a named ideal case, on `device` (default ``cuda``;
    raises if there is none and the CPU was not asked for)."""
    dev = resolve_device(device)
    if case == "warm_bubble":
        grid = make_grid(cfg, soundings.constant_n2_theta(), dev)
        return grid, warm_bubble(cfg, grid, **kw)
    if case == "squall2d_x":
        grid = make_grid(cfg, soundings.weisman_klemp_theta(), dev)
        state, grid = squall_line_x(cfg, grid, **kw)
        return grid, state
    if case == "quiescent":
        grid = make_grid(cfg, soundings.constant_n2_theta(), dev)
        theta = to_numpy64(grid.t_init)
        qv = np.zeros((grid.nz, grid.ny, grid.nx))
        return grid, init_balanced(cfg, grid, theta, qv)
    raise NotImplementedError(f"ideal case {case!r} is not ported yet; it comes "
                              f"with {SLICE_PHYS}")
