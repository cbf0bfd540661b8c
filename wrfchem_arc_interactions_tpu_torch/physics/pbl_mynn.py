"""MYNN-class level-2.5 TKE boundary layer (port of the JAX package's
`physics/pbl_mynn.py`; canonical phys/module_bl_mynn.F, Nakanishi & Niino
2009).

Prognostic QKE = 2 TKE; K_m = l q S_m and K_h = l q S_h with q = sqrt(QKE)
and the quasi-equilibrium level-2.5 stability functions solved from the
NN2009 closure constants; the master length is the Blackadar blend of kz
and 0.23 int(q z)/int(q), capped by 0.76 q/N in stable air.  QKE grows by
shear and buoyancy production with an implicit dissipation and mixes with
K_q = 3 l q S_m; theta and qv mix with K_h, u and v with K_m, each pair as
one stacked implicit solve (`pbl._implicit_mix_many`).  The surface layer
and the land surface are YSU's (`physics.pbl`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.physics.pbl import (
    _implicit_mix_many, apply_surface_update, column_geometry, pbl_height,
    soil_moisture_beta, surface_fluxes,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

# NN2009 closure constants
A1, A2 = 1.18, 0.665
B1, B2 = 24.0, 15.0
C1 = 0.137
QKE_MIN = 1e-4
GH_MIN, GH_MAX = -3.5, 0.0228          # Galperin realizability band


def stability_functions(gh):
    """Quasi-equilibrium level-2.5 (S_m, S_h) from G_h."""
    gh = torch.clamp(gh, GH_MIN, GH_MAX)
    sh = A2 * (1.0 - 6.0 * A1 / B1) / (1.0 - 3.0 * A2 * gh * (6.0 * A1 + B2))
    sm = (A1 * (1.0 - 3.0 * C1 - 6.0 * A1 / B1)
          + sh * gh * (18.0 * A1 * A1 + 9.0 * A1 * A2)) \
        / (1.0 - 9.0 * A1 * A2 * gh)
    return torch.clamp(sm, min=1e-4), torch.clamp(sh, min=1e-4)


def mynn_column(state: State, grid: Grid, cfg: Config,
                dt: float) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Surface fluxes and MYNN level-2.5 mixing; the contract of
    `pbl.surface_and_pbl`, with qke updated in the state."""
    diag, pii, t_air, rho, z_agl, dz_c, dz_w, rho_w = column_geometry(state, grid, cfg)
    beta, noah = soil_moisture_beta(state, cfg)
    qv = state.get("qv", torch.zeros_like(t_air))
    hfx, qfx, ust, cd, ch_wind = surface_fluxes(
        t_air[0], qv[0], diag.p_full[0], rho[0], state["u"][0], state["v"][0],
        z_agl[0], state["tsk"], beta_moist=beta)

    thv = diag.theta * (1.0 + c.EP_1 * qv)
    h_pbl, _ = pbl_height(thv, z_agl, ust, hfx, rho[0])

    qke = torch.clamp(state["qke"], min=QKE_MIN)
    q = torch.sqrt(qke)

    # master length scale (Blackadar blend)
    int_qz = torch.sum(q * z_agl * dz_c, dim=0)
    int_q = torch.sum(q * dz_c, dim=0)
    l_bl = torch.clamp(0.23 * int_qz / torch.clamp(int_q, min=1e-6), 10.0, 3000.0)
    l_s = c.KARMAN * torch.clamp(z_agl, min=1.0)
    l_mix = 1.0 / (1.0 / l_s + 1.0 / l_bl[None])
    # stable limit: l <= 0.76 q / N
    dz1 = torch.clamp(dz_c, min=1.0)
    n2 = c.G / torch.clamp(thv, min=100.0) * (torch.gradient(thv, dim=0)[0] / dz1)
    n_bv = torch.sqrt(torch.clamp(n2, min=1e-10))
    l_mix = torch.where(n2 > 1e-10, torch.minimum(l_mix, 0.76 * q / n_bv), l_mix)

    # G_h = -N^2 l^2 / q^2, clipped to realizability
    gh = -n2 * (l_mix / torch.clamp(q, min=1e-2)) ** 2
    sm, sh = stability_functions(gh)
    km = torch.clamp(l_mix * q * sm, 0.1, 2000.0)
    kh = torch.clamp(l_mix * q * sh, 0.1, 2000.0)
    km_w = 0.5 * (km[1:] + km[:-1])
    kh_w = 0.5 * (kh[1:] + kh[:-1])

    # QKE: production, implicit dissipation, vertical transport, surface value
    du_dz = torch.gradient(state["u"], dim=0)[0] / dz1
    dv_dz = torch.gradient(state["v"], dim=0)[0] / dz1
    shear2 = du_dz ** 2 + dv_dz ** 2
    p_s = km * shear2
    p_b = -kh * n2
    qke_new = (qke + 2.0 * dt * torch.maximum(p_s + p_b, -0.45 * qke / dt)) \
        / (1.0 + 2.0 * dt * q / (B1 * l_mix))
    qke_new = torch.clamp(qke_new, min=QKE_MIN)
    lqs = l_mix * q * sm
    kq_w = 3.0 * 0.5 * (lqs[1:] + lqs[:-1])
    qke_new, = _implicit_mix_many((qke_new,), (None,), kq_w, rho_w, rho, dz_c, dz_w, dt)
    qke_sfc = B1 ** (2.0 / 3.0) * ust ** 2
    qke_new = torch.cat([torch.maximum(qke_new[:1], qke_sfc[None]), qke_new[1:]], dim=0)

    theta_new, qv_new = _implicit_mix_many(
        (diag.theta, qv), (hfx / c.CP / pii[0], qfx), kh_w, rho_w, rho, dz_c, dz_w, dt)
    wind0 = torch.sqrt(state["u"][0] ** 2 + state["v"][0] ** 2) + 0.1
    u_new, v_new = _implicit_mix_many(
        (state["u"], state["v"]),
        (-rho[0] * cd * wind0 * state["u"][0], -rho[0] * cd * wind0 * state["v"][0]),
        km_w, rho_w, rho, dz_c, dz_w, dt)

    tend = {
        "th": (theta_new - diag.theta) / dt,
        "qv": (qv_new - qv) / dt,
        "u": (u_new - state["u"]) / dt,
        "v": (v_new - state["v"]) / dt,
    }
    out = dict(state)
    out["qke"] = qke_new
    out["hfx"] = hfx
    out["qfx"] = qfx
    out["ust"] = ust
    out["pblh"] = h_pbl
    out = apply_surface_update(state, out, hfx, qfx, ch_wind, beta, noah,
                               rho[0], t_air[0], dt)
    return out, tend
