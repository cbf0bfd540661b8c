"""Kessler warm-rain microphysics (port of the JAX package's
`physics/microphysics/kessler.py`; canonical phys/module_mp_kessler.F).

Column-local: rain sedimentation (sub-stepped upwind flux), autoconversion
and accretion, rain evaporation, saturation adjustment — in the reference's
operator order, applied after the dynamics step.
"""

from __future__ import annotations

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import Diag
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

K1_AUTO = 1.0e-3       # autoconversion rate [s-1]
QC0_AUTO = 1.0e-3      # autoconversion threshold [kg/kg]
K2_ACCR = 2.2          # accretion rate coefficient
RHO0_REF = 1.0         # reference density for fall speed [kg m-3]


def _qvs(p, t):
    """Saturation mixing ratio over liquid (Bolton/Teten)."""
    es = 611.2 * torch.exp(c.SVP2 * (t - c.SVPT0) / (t - c.SVP3))
    es = torch.minimum(es, 0.99 * p)
    return c.EP_2 * es / (p - es)


def saturation_adjust(theta, qv, qc, p, pii, max_iter: int = 3):
    """Condense/evaporate to saturation with latent heating."""
    for _ in range(max_iter):
        t = theta * pii
        qvs = _qvs(p, t)
        dqsdt = qvs * c.SVP2 * (c.SVPT0 - c.SVP3) / (t - c.SVP3) ** 2
        gamma = c.XLV / (c.CP * pii)
        excess = (qv - qvs) / (1.0 + gamma * pii * dqsdt)
        cond = torch.maximum(excess, -qc)        # cannot evaporate more than qc
        theta = theta + gamma * cond
        qv = qv - cond
        qc = qc + cond
    return theta, qv, qc


def rain_fall_speed(qr, rho):
    """Marshall-Palmer terminal velocity [m/s] (Kessler/Wisner form)."""
    qr_rho = torch.clamp(qr, min=0.0) * rho
    return 36.34 * qr_rho ** 0.1364 * torch.sqrt(RHO0_REF / rho)


def _sedimentation(qr, rho, dz8w, dt, nfall: int):
    """Sub-stepped upwind sedimentation; returns (qr_new, surface_rain_mm)."""
    dtf = dt / nfall
    rain = torch.zeros_like(qr[0])
    for _ in range(nfall):
        vt = rain_fall_speed(qr, rho)
        flux = rho * vt * qr
        inflow = torch.cat([flux[1:], torch.zeros_like(flux[:1])], dim=0)
        dq = dtf * (inflow - flux) / (rho * dz8w)
        rain = rain + dtf * flux[0]
        qr = torch.clamp(qr + dq, min=0.0)
    return qr, rain


def kessler(state: State, diag: Diag, grid: Grid, dt: float) -> State:
    theta = diag.theta
    qv = state["qv"]
    qc = state["qc"]
    qr = state["qr"]
    p = diag.p_full
    pii = (p / c.P0) ** c.RCP
    t_air = theta * pii
    rho = 1.0 / (diag.alpha_d * diag.eps_ratio)
    ph_full = grid.phb + state["ph"]
    dz8w = (ph_full[1:] - ph_full[:-1]) / c.G

    # sedimentation, CFL-substepped with the reference's static bound
    nfall = max(1, int(-(-dt * 15.0 // 150.0)))
    qr, rain = _sedimentation(qr, rho, dz8w, dt, nfall)

    # autoconversion + accretion
    auto = torch.clamp(K1_AUTO * (qc - QC0_AUTO), min=0.0)
    accr = torch.clamp(K2_ACCR * qc * torch.clamp(qr, min=0.0) ** 0.875, min=0.0)
    dqr = torch.minimum((auto + accr) * dt, qc)
    qc = qc - dqr
    qr = qr + dqr

    # rain evaporation (ventilated, capped by the subsaturation deficit)
    qvs = _qvs(p, t_air)
    deficit = torch.clamp(qvs - qv, min=0.0)
    qr_rho = torch.clamp(qr, min=0.0) * rho
    vent = 1.6 + 124.9 * qr_rho ** 0.2046
    evap_rate = (vent * qr_rho ** 0.525
                 / (2.55e8 / (p * qvs) + 5.4e5)) * (deficit / (rho * qvs + 1e-12))
    evap = torch.minimum(torch.minimum(evap_rate * dt, qr), deficit)
    qr = qr - evap
    qv = qv + evap
    theta = theta - (c.XLV / (c.CP * pii)) * evap

    theta, qv, qc = saturation_adjust(theta, qv, qc, p, pii)

    out = dict(state)
    out["t"] = theta - c.T0
    out["qv"] = torch.clamp(qv, min=0.0)
    out["qc"] = torch.clamp(qc, min=0.0)
    out["qr"] = torch.clamp(qr, min=0.0)
    out["rainnc"] = state["rainnc"] + rain
    return out
