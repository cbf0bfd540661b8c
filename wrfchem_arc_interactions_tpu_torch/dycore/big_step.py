"""Large-timestep RHS terms: pressure gradient, buoyancy, Coriolis, omega
diagnosis, geopotential advection (port of the JAX package's
`dycore/big_step.py`; canonical module_big_step_utilities_em.F).

Horizontal-stencil inputs are PAD-padded tensors; outputs are interior-sized
coupled tendencies.  The terrain and map-factor branches of the reference
come with a later slice (the solver refuses such grids before it gets here);
what remains is the flat-metric arithmetic, transcribed operation for
operation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import ddz_center, ddz_faces
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.stencil import avg_z_centers_to_faces, win
from wrfchem_arc_interactions_tpu_torch.utils.constants import G


def avg_x_to_u(a_pad, **kw):
    """Mass-point field -> u-face (i-1/2) average."""
    return 0.5 * (win(a_pad, 0, -1, **kw) + win(a_pad, 0, 0, **kw))


def avg_y_to_v(a_pad, **kw):
    return 0.5 * (win(a_pad, -1, 0, **kw) + win(a_pad, 0, 0, **kw))


def pgf_uv(p_pert_pad, ph_pert_pad, al_full_pad, eps_pad, mu_full_pad,
           grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal pressure-gradient force for the coupled U and V equations:

      F_U = -mu_d alpha d(p')/dx - (alpha/alpha_d) [mu_b + d(p')/d(eta)] d(phi')/dx

    with alpha = eps * alpha_d the moist specific volume.
    """
    rdx, rdy = grid.rdx, grid.rdy
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
    mub_u = grid.mub[None]
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
    mub_v = grid.mub[None]
    t2_v = -eps_v * (mub_v + dpdn_v) * dphdy

    return t1_u + t2_u, t1_v + t2_v


def buoyancy_w(p_pert, eps, mu_pert, grid: Grid) -> torch.Tensor:
    """g [ eps*dp'/deta + mub*(eps - 1) - mu' ] at w levels (nz+1, ny, nx);
    the surface level is zeroed."""
    dpdn_w = ddz_faces(p_pert, grid)
    eps_w = avg_z_centers_to_faces(eps, grid.fnm, grid.fnp)
    buoy = G * (eps_w * dpdn_w + grid.mub[None] * (eps_w - 1.0) - mu_pert[None])
    buoy[0] = 0.0
    return buoy


def coriolis_uv(u_pad, v_pad, mu_full_pad, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coriolis for coupled U, V: +mu_u f v_bar_u, -mu_v f u_bar_v (4-point
    averages of the opposing wind to the staggered point)."""
    f = grid.f[None]
    v_at_u = 0.25 * (win(v_pad, 0, -1) + win(v_pad, 1, -1)
                     + win(v_pad, 0, 0) + win(v_pad, 1, 0))
    u_at_v = 0.25 * (win(u_pad, -1, 0) + win(u_pad, -1, 1)
                     + win(u_pad, 0, 0) + win(u_pad, 0, 1))
    mu_u = avg_x_to_u(mu_full_pad)[None]
    mu_v = avg_y_to_v(mu_full_pad)[None]
    fu = mu_u * f * v_at_u
    fv = -mu_v * f * u_at_v
    return fu, fv


def omega_diagnosis(ru_pad, rv_pad, grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d(mu)/dt, omega at w levels) from the coupled mass fluxes via the
    continuity equation; omega integrates upward from 0 at the surface and
    closes at the top by construction."""
    div = ((win(ru_pad, 0, 1) - win(ru_pad, 0, 0)) * grid.rdx
           + (win(rv_pad, 1, 0) - win(rv_pad, 0, 0)) * grid.rdy)
    dnw = grid.dnw.reshape(-1, 1, 1)
    dmudt = torch.sum(dnw * div, dim=0)
    incr = dnw * (-dmudt[None] - div)
    om = torch.cumsum(incr, dim=0)
    ww = torch.cat([torch.zeros_like(om[:1]), om], dim=0)
    return dmudt, ww


def rphi_tendency(u_pad, v_pad, ph_pert_pad, w, ww, mu_full, grid: Grid) -> torch.Tensor:
    """R_phi = -(1/mu_d)[ U d(phi)/dx + V d(phi)/dy + omega d(phi)/d(eta)
    - g W ] at w levels, with u_pad/v_pad the coupled U, V (PAD-padded) and
    w the coupled W.  The surface level is zeroed."""
    fnm, fnp = grid.fnm, grid.fnp
    u_w = avg_z_centers_to_faces(win(u_pad, 0, 0, ex=1), fnm, fnp)
    dphdx_w = (win(ph_pert_pad, 0, 0, ex=1) - win(ph_pert_pad, 0, -1, ex=1)) * grid.rdx
    adv_x = 0.5 * (u_w[..., :-1] * dphdx_w[..., :-1] + u_w[..., 1:] * dphdx_w[..., 1:])

    v_w = avg_z_centers_to_faces(win(v_pad, 0, 0, ey=1), fnm, fnp)
    dphdy_w = (win(ph_pert_pad, 0, 0, ey=1) - win(ph_pert_pad, -1, 0, ey=1)) * grid.rdy
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
    rphi = (-(adv_h + adv_z) + G * w) / mu_full[None]
    rphi[0] = 0.0
    return rphi
