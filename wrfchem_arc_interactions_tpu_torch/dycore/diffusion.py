"""Subgrid turbulence / diffusion (port of the JAX package's
`dycore/diffusion.py`; canonical module_diffusion_em.F).

The 2D Smagorinsky closure on coordinate surfaces plus background khdif
(km_opt 3 and 4 alike, as in the reference), or the 1.5-order TKE closure
(km_opt=tke); the constant-K vertical diffusion (kvdif); and the 6th-order
numerical filter (diff_6th_opt 1 and 2 alike, as in the reference's
`_filter6`).  Tendencies are computed on uncoupled fields and returned as a
phys_tend dict ({u, v, th, <scalars>[, tke]}).  The scalars go through every
operator as one (nt, nz, ny, nx) stack, with the reference's per-scalar
arithmetic per element, so a hundred scalars cost the launches of one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import KMOpt
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.stencil import win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils import trace
from wrfchem_arc_interactions_tpu_torch.utils.device import pass_slices

CS_SMAG = 0.25


def smagorinsky_k(u_pad, v_pad, grid: Grid, cfg: Config):
    """Horizontal eddy viscosity K_h at mass points (2D deformation)."""
    rdx, rdy = grid.rdx, grid.rdy
    dudx = (win(u_pad, 0, 1) - win(u_pad, 0, 0)) * rdx
    dvdy = (win(v_pad, 1, 0) - win(v_pad, 0, 0)) * rdy
    dudy_c = (win(u_pad, 0, 0) - win(u_pad, -1, 0)) * rdy
    dvdx_c = (win(v_pad, 0, 0) - win(v_pad, 0, -1)) * rdx
    d12 = dudy_c + dvdx_c
    defor2 = (dudx - dvdy) ** 2 + d12 ** 2
    delta2 = grid.dx * grid.dy
    return (CS_SMAG ** 2) * delta2 * torch.sqrt(torch.clamp(defor2, min=0.0)) \
        + cfg.dynamics.khdif


def _hdiff(q_pad, k_pad, grid: Grid, pad=3):
    """del . (K del q) horizontal, 2nd order, K at mass points."""
    rdx2 = grid.rdx * grid.rdx
    rdy2 = grid.rdy * grid.rdy
    k_e = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, 1, pad=pad))
    k_w = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, -1, pad=pad))
    k_n = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 1, 0, pad=pad))
    k_s = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, -1, 0, pad=pad))
    q0 = win(q_pad, 0, 0, pad=pad)
    return (rdx2 * (k_e * (win(q_pad, 0, 1, pad=pad) - q0)
                    - k_w * (q0 - win(q_pad, 0, -1, pad=pad)))
            + rdy2 * (k_n * (win(q_pad, 1, 0, pad=pad) - q0)
                      - k_s * (q0 - win(q_pad, -1, 0, pad=pad))))


def _vdiff(q, kv, dz2):
    """Constant-K vertical diffusion d/dz(K dq/dz) on mass levels (z is
    axis -3; leading axes batch)."""
    dq = q[..., 1:, :, :] - q[..., :-1, :, :]
    zero = torch.zeros_like(q[..., :1, :, :])
    dq_up = torch.cat([dq, zero], dim=-3)
    dq_dn = torch.cat([zero, dq], dim=-3)
    return kv * (dq_up - dq_dn) / dz2


def _filter6(q_pad, factor: float, dt: float):
    """6th-order numerical filter in x and y (diff_6th_opt)."""
    wx = [win(q_pad, 0, m) for m in (-3, -2, -1, 0, 1, 2, 3)]
    wy = [win(q_pad, m, 0) for m in (-3, -2, -1, 0, 1, 2, 3)]
    coef = factor / (64.0 * dt)
    sx = (-wx[0] + 6 * wx[1] - 15 * wx[2] + 20 * wx[3] - 15 * wx[4] + 6 * wx[5] - wx[6])
    sy = (-wy[0] + 6 * wy[1] - 15 * wy[2] + 20 * wy[3] - 15 * wy[4] + 6 * wy[5] - wy[6])
    return -coef * (sx + sy)


CK_TKE = 0.10      # K = ck * l * sqrt(e)
CE_TKE = 0.93      # dissipation = ce * e^1.5 / l


def tke_exchange_and_tendency(state, grid: Grid, dz):
    """1.5-order TKE closure (km_opt=tke; canonical tke_rhs): (K_m at mass
    points, d(tke)/dt from shear and buoyancy production less
    dissipation), with the mixing length limited by sqrt(e)/N in stable
    air.  `torch.gradient` along z is the reference's `jnp.gradient`
    (central inside, one-sided at the ends)."""
    e = torch.clamp(state["tke"], min=1e-4)
    theta = state["t"] + c.T0
    delta = (grid.dx * grid.dy) ** 0.5
    dz1 = torch.clamp(dz, min=1.0)
    n2 = c.G / theta * (torch.gradient(theta, dim=0)[0] / dz1)
    dudz = torch.gradient(state["u"], dim=0)[0] / dz1
    dvdz = torch.gradient(state["v"], dim=0)[0] / dz1
    shear2 = dudz ** 2 + dvdz ** 2
    l_strat = torch.where(n2 > 1e-10,
                          0.76 * torch.sqrt(e / torch.clamp(n2, min=1e-10)), delta)
    l_mix = torch.clamp(l_strat, max=delta)
    k_m = CK_TKE * l_mix * torch.sqrt(e)
    k_h_fac = 1.0 + 2.0 * l_mix / delta          # inverse turbulent Prandtl number
    prod_s = k_m * shear2
    prod_b = -k_m * k_h_fac * n2
    dissip = CE_TKE * e ** 1.5 / torch.clamp(l_mix, min=1.0)
    return k_m, prod_s + prod_b - dissip


def diffusion_tendencies(state, grid: Grid, cfg: Config, hx: HaloOps, dt: float,
                         scalars: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """phys_tend contributions from subgrid mixing (uncoupled rates).  The
    scalars go through the operators stacked, in passes over slices of the
    stack (`utils.device.pass_slices`; config 5's 500x500x60 block, whose
    107 scalars would hold ~40 GB of temporaries in one, takes 6).  Each
    scalar's arithmetic is its own, so the passes give the one-pass result
    bit for bit.  On a mesh each pass pads its slice through the halo
    exchange: one exchange of the stack per pass."""
    dyn = cfg.dynamics
    g = hx.pad_many({"u": state["u"], "v": state["v"], "t": state["t"]}, 3)
    dtke = None
    if dyn.km_opt == KMOpt.TKE_15:
        ph_full = grid.phb + state["ph"]
        k_h, dtke = tke_exchange_and_tendency(state, grid,
                                              (ph_full[1:] - ph_full[:-1]) / 9.81)
    else:
        k_h = smagorinsky_k(g["u"], g["v"], grid, cfg)
    k_pad = hx.pad(k_h, 3)

    out: Dict[str, torch.Tensor] = {}
    out["u"] = _hdiff(g["u"], k_pad, grid)
    out["v"] = _hdiff(g["v"], k_pad, grid)
    out["th"] = _hdiff(g["t"], k_pad, grid)

    if dyn.kvdif > 0.0:
        ph_full = grid.phb + state["ph"]
        dz = (ph_full[1:] - ph_full[:-1]) / 9.81
        dz2 = dz * dz
        out["u"] = out["u"] + _vdiff(state["u"], dyn.kvdif, dz2)
        out["v"] = out["v"] + _vdiff(state["v"], dyn.kvdif, dz2)
        out["th"] = out["th"] + _vdiff(state["t"], dyn.kvdif, dz2)

    f = dyn.diff_6th_factor
    if dyn.diff_6th_opt:
        out["u"] = out["u"] + _filter6(g["u"], f, dt)
        out["v"] = out["v"] + _filter6(g["v"], f, dt)
        out["th"] = out["th"] + _filter6(g["t"], f, dt)

    for a, b in pass_slices(len(scalars), state["t"].numel()) if scalars else ():
        with trace.span("pass"):
            sc = torch.stack([state[q] for q in scalars[a:b]])
            sc_pad = hx.pad(sc, 3)
            sc_out = _hdiff(sc_pad, k_pad, grid)
            if dyn.kvdif > 0.0:
                sc_out = sc_out + _vdiff(sc, dyn.kvdif, dz2)
            if dyn.diff_6th_opt:
                sc_out = sc_out + _filter6(sc_pad, f, dt)
            del sc, sc_pad
            for i, q in enumerate(scalars[a:b]):
                out[q] = sc_out[i]
    if dtke is not None:
        out["tke"] = out.get("tke", 0.0) + dtke
    return out
