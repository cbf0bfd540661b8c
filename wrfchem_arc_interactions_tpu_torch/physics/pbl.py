"""Surface layer and YSU-style PBL mixing (port of the JAX package's
`physics/pbl.py`; canonical phys/module_sf_sfclay.F revised MM5 similarity
and module_bl_ysu.F).

Column-local: bulk-similarity surface fluxes, then a YSU-shaped K-profile
mixing of theta, qv, u and v, vertically implicit.  The four fields share
the tridiagonal coefficients, so they are solved as one stack: one pass of
`dycore.tridiag.thomas` (a Python loop over z) for all four, with the
arithmetic of four separate solves per element.  The land surface is the
slab energy balance or the Noah LSM (`physics.lsm`), shared with MYNN
through `apply_surface_update`.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import SFSurface
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.physics import lsm
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

Z0 = 0.1                  # roughness length [m]
PRT = 1.0                 # turbulent Prandtl number (neutral)
SLAB_DEPTH_HEAT = 5.0e4   # slab heat capacity [J/m2/K]
EMISS = 0.98


def surface_fluxes(t_air0, q_air0, p0, rho0, u0, v0, z1, tsk, beta_moist=0.3):
    """Bulk similarity fluxes, all (ny, nx): (hfx, qfx, ust, cd, ch_wind),
    ch_wind the exchange velocity C_h |U| [m/s] the Noah LSM needs."""
    wind = torch.sqrt(u0 ** 2 + v0 ** 2) + 0.1
    lnz = torch.log(z1 / Z0)
    cd_n = (c.KARMAN / lnz) ** 2
    # stability adjustment (bulk Richardson)
    pii0 = (p0 / c.P0) ** c.RCP
    th_air = t_air0 / pii0
    th_sfc = tsk / pii0
    rib = c.G * z1 * (th_air - th_sfc) / (th_air * wind ** 2)
    fac = torch.where(rib < 0.0,
                      1.0 + 7.0 * torch.abs(rib) / (1.0 + 5.0 * torch.sqrt(torch.abs(rib))),
                      1.0 / (1.0 + 10.0 * torch.clamp(rib, 0.0, 0.2)) ** 2)
    cd = cd_n * fac
    ch = cd / PRT
    ust = torch.sqrt(cd) * wind
    hfx = rho0 * c.CP * ch * wind * (th_sfc - th_air) * pii0
    es = 611.2 * torch.exp(c.SVP2 * (tsk - c.SVPT0) / (tsk - c.SVP3))
    qsat_sfc = c.EP_2 * es / torch.clamp(p0 - es, min=1.0)
    qfx = rho0 * ch * wind * beta_moist * (qsat_sfc - q_air0)
    return hfx, qfx, ust, cd, ch * wind


def pbl_height(thv, z, ust, hfx, rho0):
    """Bulk-Richardson PBL height (YSU criterion Rib_cr = 0.25): the lowest
    level where it is crossed, else the top level.  Returns (height, index)."""
    thv0 = thv[0] + torch.where(hfx > 0, 1.5 * hfx / (rho0 * c.CP)
                                / torch.clamp(ust, min=0.1), 0.0)
    rib = c.G * (thv - thv0[None]) * z / (thv0[None] * torch.clamp(ust[None], min=0.1) ** 2
                                          + 1.0)
    above = rib > 0.25
    idx = torch.argmax(above.to(torch.int32), dim=0)
    idx = torch.where(above.any(dim=0), idx, z.shape[0] - 1)
    return torch.gather(z, 0, idx[None])[0], idx


def _implicit_mix_many(qs: Sequence[torch.Tensor], sfc_fluxes: Sequence,
                       k_w, rho_w, rho_c, dz_c, dz_w, dt):
    """Implicit vertical diffusion d/dz(K d/dz) of fields (nz, ...) that
    share K, each with an optional surface flux: a x[k-1] + b x[k] +
    c x[k+1] = d, solved for all of them as one stack along a new axis 1."""
    lam = dt / (rho_c * dz_c)
    flux_coef = rho_w * k_w / dz_w                       # (nz-1, ...)
    zeros = torch.zeros_like(rho_c[:1])
    c_up = torch.cat([flux_coef, zeros], dim=0)          # upper face of k
    c_dn = torch.cat([zeros, flux_coef], dim=0)          # lower face of k
    a = -lam * c_dn
    cc = -lam * c_up
    b = 1.0 + lam * (c_up + c_dn)
    d = torch.stack(list(qs), dim=1)
    for i, flux in enumerate(sfc_fluxes):
        if flux is not None:
            d[0, i] = d[0, i] + dt * flux / (rho_c[0] * dz_c[0])
    return thomas(a[:, None], b[:, None], cc[:, None], d).unbind(1)


def column_geometry(state: State, grid: Grid, cfg: Config):
    """Diagnostics and heights the PBL schemes share: (diag, pii, t_air, rho,
    z_agl, dz_c, dz_w, rho_w)."""
    diag = diagnose(state, grid, cfg.moist_species())
    pii = (diag.p_full / c.P0) ** c.RCP
    t_air = diag.theta * pii
    rho = 1.0 / (diag.alpha_d * diag.eps_ratio)
    z_w = (grid.phb + state["ph"]) / c.G
    z_c = 0.5 * (z_w[:-1] + z_w[1:])
    z_agl = z_c - z_w[0]
    dz_c = z_w[1:] - z_w[:-1]
    dz_w = z_c[1:] - z_c[:-1]
    rho_w = 0.5 * (rho[1:] + rho[:-1])
    return diag, pii, t_air, rho, z_agl, dz_c, dz_w, rho_w


def surface_and_pbl(state: State, grid: Grid, cfg: Config,
                    dt: float) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Surface fluxes, YSU mixing and the land-surface update: returns the
    state with hfx, qfx, ust, pblh and the surface fields, and the held
    tendencies of th, qv, u and v."""
    diag, pii, t_air, rho, z_agl, dz_c, dz_w, rho_w = column_geometry(state, grid, cfg)
    beta, noah = soil_moisture_beta(state, cfg)
    qv = state.get("qv", torch.zeros_like(t_air))
    hfx, qfx, ust, cd, ch_wind = surface_fluxes(
        t_air[0], qv[0], diag.p_full[0], rho[0], state["u"][0], state["v"][0],
        z_agl[0], state["tsk"], beta_moist=beta)

    thv = diag.theta * (1.0 + c.EP_1 * qv)
    h_pbl, _ = pbl_height(thv, z_agl, ust, hfx, rho[0])

    # YSU K-profile: K = karman w_s z (1 - z/h)^2 inside the PBL, at least 1
    zr = torch.clamp(z_agl / torch.clamp(h_pbl[None], min=10.0), 0.0, 1.0)
    wstar = torch.where(hfx > 0,
                        (c.G / 300.0 * torch.clamp(hfx, min=0.0) / (rho[0] * c.CP)
                         * torch.clamp(h_pbl, min=10.0)) ** (1.0 / 3.0), 0.0)
    wscale = (ust ** 3 + 0.6 * wstar ** 3) ** (1.0 / 3.0)
    k_prof = c.KARMAN * wscale[None] * z_agl * (1.0 - zr) ** 2
    k_prof = torch.clamp(k_prof, min=1.0)
    k_w = 0.5 * (k_prof[1:] + k_prof[:-1])

    # surface drag on momentum as the flux -rho cd |U| u
    wind0 = torch.sqrt(state["u"][0] ** 2 + state["v"][0] ** 2) + 0.1
    theta_new, qv_new, u_new, v_new = _implicit_mix_many(
        (diag.theta, qv, state["u"], state["v"]),
        (hfx / c.CP / pii[0], qfx, -rho[0] * cd * wind0 * state["u"][0],
         -rho[0] * cd * wind0 * state["v"][0]),
        k_w, rho_w, rho, dz_c, dz_w, dt)

    tend = {
        "th": (theta_new - diag.theta) / dt,
        "qv": (qv_new - qv) / dt,
        "u": (u_new - state["u"]) / dt,
        "v": (v_new - state["v"]) / dt,
    }
    out = dict(state)
    out["hfx"] = hfx
    out["qfx"] = qfx
    out["ust"] = ust
    out["pblh"] = h_pbl
    out = apply_surface_update(state, out, hfx, qfx, ch_wind, beta, noah,
                               rho[0], t_air[0], dt)
    return out, tend


def soil_moisture_beta(state: State, cfg: Config):
    """(beta_moist, noah_active): the Noah soil-moisture availability when
    the Noah LSM is configured, else the slab's 0.3."""
    if cfg.physics.sf_surface_physics == SFSurface.NOAH and "smois" in state:
        return lsm.soil_beta(state["smois"][0]), True
    return 0.3, False


def apply_surface_update(state: State, out: dict, hfx, qfx, ch_wind, beta,
                         noah: bool, rho0, t_air0, dt: float) -> dict:
    """The land-surface update every PBL scheme shares: the Noah soil
    columns, or the slab energy balance when radiation supplies fluxes."""
    if noah and "swdown" in state:
        qfx_pot = qfx / beta                        # potential evaporation
        ra = 1.0 / torch.clamp(ch_wind, min=1e-4)
        rain = state.get("rainnc", 0.0)
        if "rainc" in state:
            rain = rain + state["rainc"]
        prev = state.get("rain_prev", rain)
        precip_rate = torch.clamp(rain - prev, min=0.0) / dt
        upd = lsm.noah_step(state, hfx, qfx_pot, ra, rho0, precip_rate,
                            state["swdown"], state["glw"], dt, t_air0=t_air0)
        out["tsk"] = upd["tsk"]
        out["tslb"] = upd["tslb"]
        out["smois"] = upd["smois"]
        out["qfx"] = upd["qfx_eff"]
        if "snow" in upd:
            out["snow"] = upd["snow"]
        if "rain_prev" in state:
            out["rain_prev"] = rain
    elif "swdown" in state:
        net = ((1.0 - 0.2) * state["swdown"] + EMISS * state["glw"]
               - EMISS * c.STBOLT * state["tsk"] ** 4 - hfx - c.XLV * qfx)
        out["tsk"] = state["tsk"] + dt * net / SLAB_DEPTH_HEAT
    return out
