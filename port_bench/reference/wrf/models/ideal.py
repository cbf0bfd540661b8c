"""Ideal-case initialisation (port of the JAX package's `models/ideal.py`;
canonical dyn_em/module_initialize_<case>.F).

The initial state satisfies the discrete hydrostatic balance of the model's
own operators, so an unperturbed column is a stationary point of
`dycore.solve.step` to rounding.  The construction runs on the host in numpy
float64 from the float32 grid (as the reference reads its float32 grid
back), and only the finished fields are cast and moved to the device.

Ported cases: every case of the reference on a flat grid (``warm_bubble``,
``quiescent``, ``squall2d_x`` and ``squall2d_y``, ``grav2d_x``,
``seabreeze2d_x``, ``quarter_ss``, ``b_wave``, ``les`` and
``tropical_cyclone``), and ``hill2d_x`` over terrain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from port_bench.reference.wrf.config import Config
from port_bench.reference.wrf.grid import Grid, make_grid
from port_bench.reference.wrf.models import soundings
from port_bench.reference.wrf.registry.state import State, build_state
from port_bench.reference.wrf.utils import constants as c
from port_bench.reference.wrf.utils.device import (
    DeviceLike, resolve_device, to_numpy64,
)


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
    if "tslb" in state:       # Noah soil columns: isothermal at tsk, moist
        state["tslb"] = torch.full_like(state["tslb"], tsk)
        state["smois"] = torch.full_like(state["smois"], 0.25)
    if "tmn" in state:
        state["tmn"] = torch.full_like(state["tmn"], tsk)
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


def squall_line_y(cfg: Config, grid: Grid, bubble_amp: float = 3.0,
                  shear_depth: float = 2500.0,
                  v_shear: float = -12.0) -> Tuple[State, Grid]:
    """2D (y-z) squall line, the y-axis mirror of `squall_line_x`
    (canonical module_initialize_squall2d_y.F): low-level v-shear and a
    thermal line uniform in x."""
    z = _z_half(grid)
    theta_fn = soundings.weisman_klemp_theta()
    rh_fn = soundings.weisman_klemp_rh()
    theta0 = theta_fn(z)
    pb = to_numpy64(grid.pb)
    qv = soundings.qv_from_rh(theta0, pb, rh_fn(z))
    _, _, _, p = balance_columns(grid, theta0, qv)
    qv = soundings.qv_from_rh(theta0, p, rh_fn(z))
    theta = theta0 + _bubble(grid, bubble_amp, None, 1500.0, 4000.0, 1500.0,
                             yc=0.5 * grid.ny * grid.dy, yr=4000.0)
    v_prof = np.where(z < shear_depth, v_shear * (1.0 - z / shear_depth), 0.0)
    state = init_balanced(cfg, grid, theta, qv, v=v_prof)
    return state, grid


def hill2d_x(cfg: Config, device: torch.device, hm: float = 100.0,
             a_half: float = 10000.0, u0: float = 10.0) -> Tuple[Grid, State]:
    """2D (x-z) flow over a witch-of-Agnesi hill, the mountain-wave case
    (canonical module_initialize_hill2d_x.F): constant-N sounding, uniform
    wind u0; the initial state is the discrete base state over the terrain,
    so the terrain-following pressure-gradient balance is exercised
    directly."""
    d = cfg.domain
    x = (np.arange(d.nx) + 0.5 - 0.5 * d.nx) * d.dx
    ht = hm / (1.0 + (x / a_half) ** 2)
    ht2d = np.broadcast_to(ht[None, :], (d.ny, d.nx))
    grid = make_grid(cfg, soundings.constant_n2_theta(), device, terrain=ht2d)
    theta = to_numpy64(grid.t_init)
    qv = np.zeros((d.nz, d.ny, d.nx))
    p_sfc = to_numpy64(grid.mub) + grid.p_top
    return grid, init_balanced(cfg, grid, theta, qv, u=u0, p_sfc=p_sfc)


def grav2d_x(cfg: Config, device: torch.device, amplitude: float = -15.0,
             zc: float = 3000.0, xr: float = 4000.0,
             zr: float = 2000.0) -> Tuple[Grid, State]:
    """Straka density current (canonical module_initialize_grav2d_x.F): an
    isentropic 300 K base state and a -15 K cold blob aloft."""
    grid = make_grid(cfg, lambda z: np.full_like(np.asarray(z, np.float64), 300.0),
                     device)
    theta = to_numpy64(grid.t_init) + _bubble(grid, amplitude, 0.5 * grid.nx * grid.dx,
                                              zc, xr, zr)
    qv = np.zeros((grid.nz, grid.ny, grid.nx))
    return grid, init_balanced(cfg, grid, theta, qv)


def seabreeze2d_x(cfg: Config, device: torch.device, tsk_sea: float = 288.0,
                  delta_tsk: float = 10.0, qv_bl: float = 6e-3) -> Tuple[Grid, State]:
    """2D sea breeze (canonical module_initialize_seabreeze2d_x.F): a
    quiescent stable sounding ~1 K above the sea skin, over a skin that
    steps from sea (west half) to land `delta_tsk` warmer (east half)."""
    grid = make_grid(cfg, soundings.constant_n2_theta(theta0=tsk_sea + 1.0), device)
    ny, nx = grid.ny, grid.nx
    z = _z_half(grid)
    theta = to_numpy64(grid.t_init).copy()
    qv = np.where(z < 1500.0, qv_bl, qv_bl * np.exp(-(z - 1500.0) / 3000.0))
    state = init_balanced(cfg, grid, theta, qv, tsk=tsk_sea)
    land = (np.arange(nx) + 0.5) / nx >= 0.5
    tsk = np.where(land, tsk_sea + delta_tsk, tsk_sea)
    state["tsk"] = torch.from_numpy(np.array(np.broadcast_to(tsk, (ny, nx)))).to(
        dtype=state["tsk"].dtype, device=grid.device)
    if "tmn" in state:
        state["tmn"] = state["tsk"]
    if "tslb" in state:
        state["tslb"] = state["tsk"][None].expand(state["tslb"].shape).clone()
    return grid, state


def supercell_3d(cfg: Config, grid: Grid, bubble_amp: float = 3.0,
                 u_max: float = 30.0, shear_depth: float = 6000.0) -> State:
    """3D supercell: Weisman-Klemp sounding and a quarter-circle shear
    hodograph (canonical module_initialize_quarter_ss.F)."""
    z = _z_half(grid)
    theta0 = to_numpy64(grid.t_init)
    rh_fn = soundings.weisman_klemp_rh()
    pb = to_numpy64(grid.pb)
    qv = soundings.qv_from_rh(theta0, pb, rh_fn(z))
    _, _, _, p = balance_columns(grid, theta0, qv)
    qv = soundings.qv_from_rh(theta0, p, rh_fn(z))
    theta = theta0 + _bubble(grid, bubble_amp, 0.5 * grid.nx * grid.dx, 1500.0,
                             10000.0, 1500.0, yc=0.5 * grid.ny * grid.dy, yr=10000.0)
    # turning through the lowest 2 km, then unidirectional shear to
    # shear_depth, less a mean storm motion that keeps the cell in the domain
    frac = np.clip(z / shear_depth, 0.0, 1.0)
    turn = np.clip(z / 2000.0, 0.0, 1.0) * 0.5 * np.pi
    speed = u_max * frac
    u_prof = speed * np.sin(turn) - 0.5 * u_max
    v_prof = speed * (1.0 - np.cos(turn)) - 0.25 * u_max
    return init_balanced(cfg, grid, theta, qv, u=u_prof, v=v_prof)


def b_wave(cfg: Config, device: torch.device, delta_t: float = 12.0,
           ly_frac: float = 0.15, f0: float = 1.0e-4,
           perturb: float = 1.0) -> Tuple[Grid, State]:
    """Baroclinic-wave channel (canonical module_initialize_b_wave.F): a
    meridional tanh front, a small theta perturbation seeding the wave, and
    a zonal jet in discrete geostrophic balance with the model's own
    geopotential slope on the f-plane."""
    d = cfg.domain
    grid = make_grid(cfg, soundings.constant_n2_theta(), device, f0=f0)
    z = _z_half(grid)
    theta0 = to_numpy64(grid.t_init)
    y = (np.arange(d.ny) + 0.5) * d.dy
    yc = 0.5 * d.ny * d.dy
    ly = ly_frac * d.ny * d.dy
    fade = np.clip(1.0 - z / 12000.0, 0.0, 1.0)
    theta = theta0 + -delta_t * np.tanh((y[None, :, None] - yc) / ly) * fade
    if perturb:
        # seeded before the hydrostatic balancing
        x = (np.arange(d.nx) + 0.5) * d.dx
        lx = d.nx * d.dx
        theta = theta + (perturb
                         * np.exp(-((y[None, :, None] - yc) / ly) ** 2)
                         * np.sin(2.0 * np.pi * x[None, None, :] / lx)
                         * np.clip(1.0 - z / 9000.0, 0.0, 1.0))
    state = init_balanced(cfg, grid, theta, np.zeros_like(theta))
    # p is uniform on eta surfaces, so f u_g = -dPhi/dy on eta
    ph_full = to_numpy64(grid.phb) + to_numpy64(state["ph"])
    phi_m = 0.5 * (ph_full[:-1] + ph_full[1:])
    u_g = -np.gradient(phi_m, d.dy, axis=1) / f0
    u_g[:, 0, :] = u_g[:, 1, :]
    u_g[:, -1, :] = u_g[:, -2, :]
    state["u"] = torch.from_numpy(u_g).to(dtype=state["u"].dtype, device=grid.device)
    return grid, state


def les_cbl(cfg: Config, device: torch.device, theta_sfc: float = 300.0,
            inv_height: float = 1000.0) -> Tuple[Grid, State]:
    """Convective-boundary-layer LES (canonical module_initialize_les.F): a
    mixed layer capped by an inversion, driven by
    ``cfg.physics.tke_heat_flux``, with seeded sub-K perturbations in the
    lower half of the mixed layer."""
    def theta_of_z(z):
        z = np.asarray(z)
        return np.where(z < inv_height, theta_sfc, theta_sfc + 0.01 * (z - inv_height))

    grid = make_grid(cfg, theta_of_z, device)
    theta = to_numpy64(grid.t_init).copy()
    rng = np.random.default_rng(7)
    z = _z_half(grid)
    theta += np.where(z < 0.5 * inv_height, rng.uniform(-0.1, 0.1, theta.shape), 0.0)
    state = init_balanced(cfg, grid, theta, np.zeros_like(theta), tsk=theta_sfc + 2.0)
    return grid, state


def tropical_cyclone(cfg: Config, device: torch.device, v_max: float = 15.0,
                     r_max: float = 80e3, z_decay: float = 12000.0, sst: float = 302.0,
                     f0: float = 5.0e-5) -> Tuple[Grid, State]:
    """Axisymmetric warm-core vortex on an f-plane over a warm SST
    (canonical module_initialize_tropical_cyclone.F): tangential wind
    v_max (r/r_m) exp(1 - r/r_m) fading to zero at z_decay, and a warm core
    in thermal-wind balance with it, theta'(r, z) = -(theta0/g)
    integral_r^R dG/dz dr' with G = f v_t + v_t^2/r, integrated on a radial
    profile through the centre column and sampled by radius."""
    d = cfg.domain

    def rh_of_z(z):
        return np.clip(0.95 - 0.55 * np.asarray(z) / 14000.0, 0.25, 0.95)

    grid = make_grid(cfg, soundings.weisman_klemp_theta(), device, f0=f0, lat0=15.0)
    z = _z_half(grid)
    theta0 = to_numpy64(grid.t_init)
    x = (np.arange(d.nx) + 0.5) * d.dx
    y = (np.arange(d.ny) + 0.5) * d.dy
    xc, yc = 0.5 * d.nx * d.dx, 0.5 * d.ny * d.dy
    dx_ = x[None, :] - xc
    dy_ = y[:, None] - yc
    r = np.maximum(np.sqrt(dx_ ** 2 + dy_ ** 2)[None], 1.0)

    fade = np.where(z < z_decay,
                    np.cos(0.5 * np.pi * np.clip(z / z_decay, 0.0, 1.0)) ** 2, 0.0)
    vt = v_max * (r / r_max) * np.exp(1.0 - r / r_max) * fade

    nr = 200
    r1 = np.maximum(np.linspace(0.0, max(xc, yc) * 1.5, nr), 1.0)
    z1 = z[:, d.ny // 2, d.nx // 2]
    fade1 = np.where(z1 < z_decay,
                     np.cos(0.5 * np.pi * np.clip(z1 / z_decay, 0.0, 1.0)) ** 2, 0.0)
    vt1 = v_max * (r1[None, :] / r_max) * np.exp(1.0 - r1[None, :] / r_max) \
        * fade1[:, None]
    g1 = f0 * vt1 + vt1 ** 2 / r1[None, :]
    dg1dz = np.gradient(g1, axis=0) / np.gradient(z1)[:, None]
    cum = np.cumsum((dg1dz * np.gradient(r1)[None, :])[:, ::-1], axis=1)[:, ::-1]
    th1 = -(300.0 / c.G) * cum
    th_pert = np.stack([np.interp(r[0], r1, th1[k]) for k in range(d.nz)])

    theta = theta0 + th_pert
    p_mass = c.P0 * np.exp(-z / 8000.0)          # rough p for the qv of the RH profile
    qv = soundings.qv_from_rh(theta, p_mass, rh_of_z(z))
    state = init_balanced(cfg, grid, theta, qv, tsk=sst)

    def put(a):
        return torch.from_numpy(a).to(dtype=state["u"].dtype, device=grid.device)

    # u = -v_t sin(phi), v = v_t cos(phi)
    state["u"] = put(-vt * (dy_[None] / r))
    state["v"] = put(vt * (dx_[None] / r))
    return grid, state


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
    if case == "squall2d_y":
        grid = make_grid(cfg, soundings.weisman_klemp_theta(), dev)
        state, grid = squall_line_y(cfg, grid, **kw)
        return grid, state
    if case == "grav2d_x":
        return grav2d_x(cfg, dev, **kw)
    if case == "seabreeze2d_x":
        return seabreeze2d_x(cfg, dev, **kw)
    if case == "quarter_ss":
        grid = make_grid(cfg, soundings.weisman_klemp_theta(), dev)
        return grid, supercell_3d(cfg, grid, **kw)
    if case == "b_wave":
        return b_wave(cfg, dev, **kw)
    if case == "les":
        return les_cbl(cfg, dev, **kw)
    if case == "tropical_cyclone":
        return tropical_cyclone(cfg, dev, **kw)
    if case == "hill2d_x":
        return hill2d_x(cfg, dev, **kw)
    if case == "quiescent":
        grid = make_grid(cfg, soundings.constant_n2_theta(), dev)
        theta = to_numpy64(grid.t_init)
        qv = np.zeros((grid.nz, grid.ny, grid.nx))
        return grid, init_balanced(cfg, grid, theta, qv)
    raise ValueError(case)
