"""WSM6 single-moment 6-class microphysics (port of the JAX package's
`physics/microphysics/wsm6.py`; canonical phys/module_mp_wsm6.F,
mp_physics=6).

Mass mixing ratios only (qv, qc, qr, qi, qs, qg) with inverse-exponential
size distributions (N0r and N0g fixed, N0s temperature-dependent), so each
rate closes in the slope lambda.  In the reference's operator order: ice
nucleation and deposition, Tripoli-Cotton autoconversion and accretion,
riming and ice-to-snow conversion, melting above 0 C, rain evaporation,
saturation adjustment, and CFL-substepped upwind sedimentation of rain,
snow and graupel.  Graupel wet growth, rain freezing and snow/graupel
sublimation are left out, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import Diag
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import (
    _qvs, saturation_adjust,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

T0C = 273.15
# intercepts [m-4] and bulk densities [kg m-3]
N0R = 8.0e6
N0G = 4.0e6
N0S_BASE = 2.0e6            # N0s = N0S_BASE * exp(0.12 (T0C - T)), capped
RHO_R, RHO_S, RHO_G, RHO_I = 1000.0, 100.0, 500.0, 500.0
# fall-speed power laws V = a D^b (WSM6 values)
AV_R, BV_R = 841.99667, 0.8
AV_S, BV_S = 11.72, 0.41
AV_G, BV_G = 330.0, 0.8
# autoconversion (Tripoli & Cotton 1980, the WSM6 warm-rain form):
# praut = qck1 * qc^(7/3) above qc0, with qc0 = 4/3 pi rho_w r0^3 Ncr / rho
XNCR = 3.0e8                # cloud droplet number [m-3]
R0_AUTO = 8.0e-6            # critical mean droplet radius [m]
PEAUT = 0.55                # collection efficiency
XMYU = 1.718e-5             # dynamic viscosity [kg m-1 s-1]
QI0 = 8.0e-5                # ice->snow threshold


def _g(x):
    from math import gamma
    return gamma(x)


def _lam(q, rho, rho_x, n0):
    """Marshall-Palmer slope; q [kg/kg] -> lambda [1/m], clipped as in WSM6."""
    lam = (np.pi * rho_x * n0 / (rho * torch.clamp(q, min=1e-15))) ** 0.25
    return torch.clamp(lam, 1e2, 1e6)


def _vt_mass(q, rho, rho_x, n0, a, b):
    """Mass-weighted terminal velocity of an inverse-exponential spectrum."""
    lam = _lam(q, rho, rho_x, n0)
    rho_fac = torch.sqrt(1.2 / torch.clamp(rho, min=0.1))
    return torch.clamp(a * _g(4.0 + b) / 6.0 / lam ** b * rho_fac, max=25.0)


def _sediment(q, vt_fn, rho, dz, dt, nfall):
    dtf = dt / nfall
    sfc = torch.zeros_like(q[0])
    for _ in range(nfall):
        flux = rho * vt_fn(q) * q
        inflow = torch.cat([flux[1:], torch.zeros_like(flux[:1])], dim=0)
        q = torch.clamp(q + dtf * (inflow - flux) / (rho * dz), min=0.0)
        sfc = sfc + dtf * flux[0]
    return q, sfc


def wsm6(state: State, diag: Diag, grid: Grid, cfg, dt: float) -> State:
    theta = diag.theta
    p = diag.p_full
    pii = (p / c.P0) ** c.RCP
    t_air = theta * pii
    rho = 1.0 / (diag.alpha_d * diag.eps_ratio)
    ph_full = grid.phb + state["ph"]
    dz = (ph_full[1:] - ph_full[:-1]) / c.G

    qv, qc, qr = state["qv"], state["qc"], state["qr"]
    qi, qs, qg = state["qi"], state["qs"], state["qg"]

    cold = t_air < T0C
    n0s = torch.clamp(N0S_BASE * torch.exp(0.12 * (T0C - t_air)), max=1e11)

    # --- 1. ice nucleation + vapor deposition on ice (cold only) --------
    esi = 611.2 * torch.exp(21.87 * (t_air - T0C) / (t_air - 7.66))
    qvsi = c.EP_2 * esi / torch.clamp(p - esi, min=1.0)
    n_i = torch.clamp(1.0e-2 * torch.exp(0.6 * (T0C - t_air)), max=1.0e6)  # Fletcher [1/L]->[1/m3]*1e3
    n_i = n_i * 1.0e3 / rho                                           # [#/kg]
    init_ice = torch.where(cold & (qv > qvsi),
                           torch.minimum(1e-12 * n_i, torch.clamp(qv - qvsi, min=0.0)), 0.0)
    qi = qi + init_ice
    qv = qv - init_ice
    # deposition/sublimation: relax toward ice saturation over the ice field
    dep_cap = qv - qvsi
    mi = torch.clamp(qi, min=1e-15) / torch.clamp(n_i, min=1.0)              # mean ice mass
    di = torch.clamp((mi / (np.pi / 6.0 * RHO_I)) ** (1.0 / 3.0), max=500e-6)
    dep = torch.where(cold, 4.0 * 2.2e-5 * di * n_i * rho * dep_cap
                      / torch.clamp(qvsi, min=1e-8), 0.0)
    d_dep = torch.minimum(torch.maximum(dep * dt, -qi), torch.clamp(dep_cap, min=0.0))
    qi = qi + d_dep
    qv = qv - d_dep
    theta = theta + (c.XLS / (c.CP * pii)) * (d_dep + init_ice)
    t_air = theta * pii

    # --- 2. warm rain: autoconversion + accretion ------------------------
    # Tripoli-Cotton: rate ~ qc^(7/3) once the mean droplet exceeds r0
    qc0 = (4.0 / 3.0) * np.pi * RHO_R * R0_AUTO ** 3 * XNCR / rho
    qck1 = (0.104 * c.G * PEAUT / (XNCR * RHO_R) ** (1.0 / 3.0) / XMYU
            * rho ** (4.0 / 3.0))
    auto = torch.where(qc > qc0, qck1 * torch.clamp(qc, min=0.0) ** (7.0 / 3.0), 0.0)
    lam_r = _lam(qr, rho, RHO_R, N0R)
    # rain sweeps cloud: Pracw = pi/4 a_r N0r Gamma(3+b) qc / lam^(3+b)
    pracw = (np.pi / 4.0) * AV_R * N0R * _g(3.0 + BV_R) * qc / lam_r ** (3.0 + BV_R)
    d_auto = torch.minimum(auto * dt, qc)
    d_accr = torch.minimum(pracw * dt, qc - d_auto)
    qc = qc - d_auto - d_accr
    qr = qr + d_auto + d_accr

    # --- 3. riming + ice->snow autoconversion ---------------------------
    lam_s = _lam(qs, rho, RHO_S, n0s)
    psacw = (np.pi / 4.0) * AV_S * n0s * _g(3.0 + BV_S) * qc / lam_s ** (3.0 + BV_S)
    lam_g = _lam(qg, rho, RHO_G, N0G)
    pgacw = (np.pi / 4.0) * AV_G * N0G * _g(3.0 + BV_G) * qc / lam_g ** (3.0 + BV_G)
    d_sacw = torch.minimum(psacw * dt, qc)
    d_gacw = torch.minimum(pgacw * dt, qc - d_sacw)
    # cold: rimed cloud water freezes onto snow/graupel (latent heat of
    # fusion); warm: collected cloud water sheds to rain
    qs = qs + torch.where(cold, d_sacw, 0.0)
    qg = qg + torch.where(cold, d_gacw, 0.0)
    qr = qr + torch.where(~cold, d_sacw + d_gacw, 0.0)
    qc = qc - d_sacw - d_gacw
    theta = theta + torch.where(cold, (c.XLF / (c.CP * pii)) * (d_sacw + d_gacw), 0.0)
    # ice -> snow above threshold; heavy riming converts snow -> graupel
    d_saut = torch.minimum(torch.clamp(qi - QI0, min=0.0) * (1.0 - np.exp(-1e-3 * dt)), qi)
    qs = qs + d_saut
    qi = qi - d_saut
    d_gaut = torch.where(d_sacw > 2.0 * (d_saut + 1e-12),
                         torch.minimum(0.5 * d_sacw, qs), 0.0)
    qg = qg + d_gaut
    qs = qs - d_gaut

    # --- 4. melting above 0C ---------------------------------------------
    t_air = theta * pii
    warm = t_air > T0C
    melt_fac = torch.where(warm, torch.clamp((t_air - T0C) * 0.05 * dt, max=1.0), 0.0)
    dm = (qs + qg + qi) * melt_fac
    qr = qr + dm
    qs = qs * (1.0 - melt_fac)
    qg = qg * (1.0 - melt_fac)
    qi = qi * (1.0 - melt_fac)
    theta = theta - (c.XLF / (c.CP * pii)) * dm

    # --- 5. rain evaporation ----------------------------------------------
    t_air = theta * pii
    qvs = _qvs(p, t_air)
    deficit = torch.clamp(qvs - qv, min=0.0)
    lam_r = _lam(qr, rho, RHO_R, N0R)
    vent = 0.78 + 0.31 * torch.sqrt(rho * AV_R / 1.8e-5) * _g(2.5 + BV_R / 2.0) \
        / lam_r ** (0.5 + BV_R / 2.0)
    prevp = 2.0 * np.pi * N0R * vent / lam_r ** 2 * 2.2e-5 \
        * deficit / torch.clamp(qvs, min=1e-8)
    d_ev = torch.minimum(torch.minimum(prevp * dt, qr), deficit)
    qr = qr - d_ev
    qv = qv + d_ev
    theta = theta - (c.XLV / (c.CP * pii)) * d_ev

    # --- 6. saturation adjustment (cloud water) ---------------------------
    theta, qv, qc = saturation_adjust(theta, qv, qc, p, pii)

    # --- 7. sedimentation --------------------------------------------------
    nfall = max(1, int(-(-dt * 25.0 // 150.0)))
    qr, acc_r = _sediment(qr, lambda q: _vt_mass(q, rho, RHO_R, N0R, AV_R, BV_R),
                          rho, dz, dt, nfall)
    qs, acc_s = _sediment(qs, lambda q: _vt_mass(q, rho, RHO_S, n0s, AV_S, BV_S),
                          rho, dz, dt, nfall)
    qg, acc_g = _sediment(qg, lambda q: _vt_mass(q, rho, RHO_G, N0G, AV_G, BV_G),
                          rho, dz, dt, nfall)

    out = dict(state)
    out["t"] = theta - c.T0
    floor = lambda a: torch.clamp(a, min=0.0)
    out.update({"qv": floor(qv), "qc": floor(qc), "qr": floor(qr),
                "qi": floor(qi), "qs": floor(qs), "qg": floor(qg)})
    out["rainnc"] = state["rainnc"] + acc_r + acc_s + acc_g
    return out
