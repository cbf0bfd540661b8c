"""Large-timestep RHS terms: pressure gradient, buoyancy, Coriolis, omega
diagnosis, geopotential advection (port of the JAX package's
`dycore/big_step.py`; canonical module_big_step_utilities_em.F).

Horizontal-stencil inputs are PAD-padded tensors; outputs are interior-sized
coupled tendencies.  The arithmetic, the terrain branches (`grid.has_terrain`)
and the map-factor branches (`grid.has_msf`, real projections) included, is
transcribed operation for operation.

Map-scale factors: the coupled momentum variables are U = mu_d u / m_u,
V = mu_d v / m_v, W = mu_d w / m_t, and the code's omega (ww) carries
mu eta_dot.  Flux divergences pick up m^2 (mass points), the buoyancy of
the coupled W equation 1/m, and Coriolis generalises to the conformal
f_eff = f + u dm/dy (dm/dx = 0 for every supported projection).  With
m == 1 every branch reduces bit-exactly to the flat path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from port_bench.reference.wrf.dycore.diagnostics import ddz_center, ddz_faces
from port_bench.reference.wrf.grid import Grid
from port_bench.reference.wrf.ops.stencil import (
    avg_z_centers_to_faces, column_sum, win,
)
from port_bench.reference.wrf.utils.constants import G


def avg_x_to_u(a_pad, **kw):
    """Mass-point field -> u-face (i-1/2) average."""
    return 0.5 * (win(a_pad, 0, -1, **kw) + win(a_pad, 0, 0, **kw))


def avg_y_to_v(a_pad, **kw):
    return 0.5 * (win(a_pad, -1, 0, **kw) + win(a_pad, 0, 0, **kw))


def pgf_uv(p_pert_pad, ph_pert_pad, al_full_pad, eps_pad, mu_full_pad,
           grid: Grid, base_pads=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal pressure-gradient force for the coupled U and V equations:

      F_U = -mu_d alpha d(p')/dx - (alpha/alpha_d) [mu_b + d(p')/d(eta)] d(phi')/dx
            [+ eps d(phb)/dx (mu_d alpha_d/alb - mu_b - d(p')/d(eta)) over terrain]

    with alpha = eps * alpha_d the moist specific volume.  The terrain term
    is the perturbation form of the sloped-coordinate cross terms with the
    base gradient defined by the hydrostatic identity, so an atmosphere at
    rest over orography is an exact discrete steady state.  `base_pads`:
    PAD-padded {phb, mub, alb}, required (and only read) over terrain.
    """
    rdx, rdy = grid.rdx, grid.rdy
    terrain = grid.has_terrain and base_pads is not None
    al_moist_pad = eps_pad * al_full_pad

    dpdx = (win(p_pert_pad, 0, 0) - win(p_pert_pad, 0, -1)) * rdx
    mu_u = avg_x_to_u(mu_full_pad)
    al_u = avg_x_to_u(al_moist_pad)
    t1_u = -mu_u[None] * al_u * dpdx

    dpdn = ddz_center(win(p_pert_pad, 0, -1, ex=1), grid.znu)
    dpdn_u = 0.5 * (dpdn[..., :-1] + dpdn[..., 1:])
    dphdx_w = (win(ph_pert_pad, 0, 0) - win(ph_pert_pad, 0, -1)) * rdx
    dphdx = 0.5 * (dphdx_w[:-1] + dphdx_w[1:])
    eps_u = avg_x_to_u(eps_pad)
    mub_u = avg_x_to_u(base_pads["mub"])[None] if terrain else grid.mub[None]
    t2_u = -eps_u * (mub_u + dpdn_u) * dphdx

    dpdy = (win(p_pert_pad, 0, 0) - win(p_pert_pad, -1, 0)) * rdy
    mu_v = avg_y_to_v(mu_full_pad)
    al_v = avg_y_to_v(al_moist_pad)
    t1_v = -mu_v[None] * al_v * dpdy

    dpdn_y = ddz_center(win(p_pert_pad, -1, 0, ey=1), grid.znu)
    dpdn_v = 0.5 * (dpdn_y[:, :-1, :] + dpdn_y[:, 1:, :])
    dphdy_w = (win(ph_pert_pad, 0, 0) - win(ph_pert_pad, -1, 0)) * rdy
    dphdy = 0.5 * (dphdy_w[:-1] + dphdy_w[1:])
    eps_v = avg_y_to_v(eps_pad)
    mub_v = avg_y_to_v(base_pads["mub"])[None] if terrain else grid.mub[None]
    t2_v = -eps_v * (mub_v + dpdn_v) * dphdy

    fu = t1_u + t2_u
    fv = t1_v + t2_v
    if terrain:
        # dry alpha at faces; base-state gradients along eta surfaces
        ald_u = avg_x_to_u(al_full_pad)
        alb_u = avg_x_to_u(base_pads["alb"])
        dphbdx_w = (win(base_pads["phb"], 0, 0) - win(base_pads["phb"], 0, -1)) * rdx
        dphbdx = 0.5 * (dphbdx_w[:-1] + dphbdx_w[1:])
        fu = fu + eps_u * dphbdx * (mu_u[None] * ald_u / alb_u - mub_u - dpdn_u)
        ald_v = avg_y_to_v(al_full_pad)
        alb_v = avg_y_to_v(base_pads["alb"])
        dphbdy_w = (win(base_pads["phb"], 0, 0) - win(base_pads["phb"], -1, 0)) * rdy
        dphbdy = 0.5 * (dphbdy_w[:-1] + dphbdy_w[1:])
        fv = fv + eps_v * dphbdy * (mu_v[None] * ald_v / alb_v - mub_v - dpdn_v)
    return fu, fv


def buoyancy_w(p_pert, eps, mu_pert, grid: Grid) -> torch.Tensor:
    """g [ eps*dp'/deta + mub*(eps - 1) - mu' ] at w levels (nz+1, ny, nx),
    divided by m_t on a projected grid (the coupled W = mu w / m); the
    surface level is zeroed."""
    dpdn_w = ddz_faces(p_pert, grid)
    eps_w = avg_z_centers_to_faces(eps, grid.fnm, grid.fnp)
    buoy = G * (eps_w * dpdn_w + grid.mub[None] * (eps_w - 1.0) - mu_pert[None])
    if grid.has_msf:
        buoy = buoy / grid.msft[None]
    buoy[0] = 0.0
    return buoy


def coriolis_uv(u_pad, v_pad, mu_full_pad, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coriolis for coupled U, V: +(mu_u/m_u) f_eff v_bar_u,
    -(mu_v/m_v) f_eff u_bar_v (4-point averages of the opposing wind to the
    staggered point).  On a projected grid f varies with latitude and
    f_eff = f + u dm/dy is the conformal curvature; on a flat grid
    f_eff = f and m = 1."""
    f = grid.f[None]
    v_at_u = 0.25 * (win(v_pad, 0, -1) + win(v_pad, 1, -1)
                     + win(v_pad, 0, 0) + win(v_pad, 1, 0))
    u_at_v = 0.25 * (win(u_pad, -1, 0) + win(u_pad, -1, 1)
                     + win(u_pad, 0, 0) + win(u_pad, 0, 1))
    mu_u = avg_x_to_u(mu_full_pad)[None]
    mu_v = avg_y_to_v(mu_full_pad)[None]
    if grid.curvature:
        dmdy = grid.dmdy[None]
        feff_u = f + win(u_pad, 0, 0) * dmdy
        feff_v = f + u_at_v * dmdy
        fu = (mu_u / grid.msfu[None]) * feff_u * v_at_u
        fv = -(mu_v / grid.msfv[None]) * feff_v * u_at_v
    else:
        fu = mu_u * f * v_at_u
        fv = -mu_v * f * u_at_v
    return fu, fv


def omega_diagnosis(ru_pad, rv_pad, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d(mu)/dt, omega at w levels) from the coupled mass fluxes via the
    continuity equation; omega integrates upward from 0 at the surface and
    closes at the top by construction.  On a projected grid the level
    divergence is m^2 [dx(ru) + dy(rv)] of the coupled fluxes U = mu u / m."""
    div = ((win(ru_pad, 0, 1) - win(ru_pad, 0, 0)) * grid.rdx
           + (win(rv_pad, 1, 0) - win(rv_pad, 0, 0)) * grid.rdy)
    if grid.has_msf:
        div = (grid.msft * grid.msft)[None] * div
    dnw = grid.dnw.reshape(-1, 1, 1)
    dmudt = column_sum(dnw * div)
    incr = dnw * (-dmudt[None] - div)
    om = torch.cumsum(incr, dim=0)
    ww = torch.cat([torch.zeros_like(om[:1]), om], dim=0)
    return dmudt, ww


def rphi_tendency(u_pad, v_pad, ph_pert_pad, w, ww, mu_full, grid: Grid,
                  phb_pad=None) -> torch.Tensor:
    """R_phi = -(1/mu_d)[ U d(phi)/dx + V d(phi)/dy + omega d(phi)/d(eta)
    - g W ] at w levels, with u_pad/v_pad the coupled U, V (PAD-padded) and
    w the coupled W.  Over terrain the horizontal gradient includes the base
    geopotential's slope (`phb_pad`); on a projected grid the horizontal
    advection picks up m^2.  The surface level is zeroed."""
    fnm, fnp = grid.fnm, grid.fnp
    terrain = grid.has_terrain and phb_pad is not None
    u_w = avg_z_centers_to_faces(win(u_pad, 0, 0, ex=1), fnm, fnp)
    dphdx_w = (win(ph_pert_pad, 0, 0, ex=1) - win(ph_pert_pad, 0, -1, ex=1)) * grid.rdx
    if terrain:
        dphdx_w = dphdx_w + (win(phb_pad, 0, 0, ex=1) - win(phb_pad, 0, -1, ex=1)) * grid.rdx
    adv_x = 0.5 * (u_w[..., :-1] * dphdx_w[..., :-1] + u_w[..., 1:] * dphdx_w[..., 1:])

    v_w = avg_z_centers_to_faces(win(v_pad, 0, 0, ey=1), fnm, fnp)
    dphdy_w = (win(ph_pert_pad, 0, 0, ey=1) - win(ph_pert_pad, -1, 0, ey=1)) * grid.rdy
    if terrain:
        dphdy_w = dphdy_w + (win(phb_pad, 0, 0, ey=1) - win(phb_pad, -1, 0, ey=1)) * grid.rdy
    adv_y = 0.5 * (v_w[:, :-1, :] * dphdy_w[:, :-1, :] + v_w[:, 1:, :] * dphdy_w[:, 1:, :])

    ph = win(ph_pert_pad, 0, 0)
    znw = grid.znw.reshape(-1, 1, 1)
    dphdn_int = (ph[2:] - ph[:-2]) / (znw[2:] - znw[:-2])
    dphdn_top = (ph[-1:] - ph[-2:-1]) / (znw[-1:] - znw[-2:-1])
    # base-state part: d(phb)/d(eta) = -mub*alb (at w levels)
    alb_w = avg_z_centers_to_faces(grid.alb, fnm, fnp)
    dphbdn = -grid.mub[None] * alb_w
    dphdn = torch.cat([torch.zeros_like(ph[:1]), dphdn_int, dphdn_top], dim=0) + dphbdn
    adv_z = ww * dphdn

    adv_h = adv_x + adv_y
    if grid.has_msf:
        adv_h = (grid.msft * grid.msft)[None] * adv_h
    rphi = (-(adv_h + adv_z) + G * w) / mu_full[None]
    rphi[0] = 0.0
    return rphi
