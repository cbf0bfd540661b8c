"""Cumulus: Betts-Miller-Janjic-style deep convective adjustment (port of
the JAX package's `physics/cumulus.py`; canonical phys/module_cu_bmj.F,
cu_physics=2).

A mixed-layer parcel and its Bolton LCL; the moist-adiabat reference
temperature by a fixed-count Newton inversion of theta_e; the cloud as the
contiguous buoyant levels above the LFC (deep when over 2 km); a reference
humidity ramping 0.95 -> 0.75 from base to top, swept drier until the
column dries; an enthalpy-conserving shift of the reference temperature,
then relaxation toward the reference over 2400 s.  Column-local, with
cumulative sums along z and no data-dependent control flow.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import _qvs
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

TAU_ADJ = 2400.0        # BMJ relaxation timescale [s]
DEPTH_MIN = 2000.0      # minimum cloud depth for deep convection [m]
ML_DEPTH = 6000.0       # mixed-layer source depth [Pa]
DT_BUOY = 1.0           # buoyancy trigger margin [K]


def _theta_e(t, p, qv):
    """Equivalent potential temperature (Bolton-like, saturated form used
    along the reference moist adiabat where qv = qvs)."""
    return (t * (c.P0 / p) ** c.RCP
            * torch.exp(c.XLV * qv / (c.CP * torch.clamp(t, min=200.0))))


def _moist_adiabat_t(theta_e_parcel, p, t_guess, n_iter: int = 5):
    """Invert theta_e(T, p) with qv = qvs(T, p) for T (fixed Newton count)."""
    t = t_guess
    for _ in range(n_iter):
        qvs = _qvs(p, t)
        f = _theta_e(t, p, qvs) - theta_e_parcel
        dt = 0.5
        fp = (_theta_e(t + dt, p, _qvs(p, t + dt)) - _theta_e(t, p, qvs)) / dt
        t = t - f / torch.clamp(fp, min=1e-3)
        t = torch.clamp(t, 150.0, 350.0)
    return t


def bmj_adjust(theta: torch.Tensor, qv: torch.Tensor, p: torch.Tensor,
               rho: torch.Tensor, dz: torch.Tensor,
               dt: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Convective adjustment tendencies.

    All inputs (nz, ny, nx), k=0 at the surface. Returns
    ({"th": dtheta/dt, "qv": dqv/dt}, precip_rate [mm/s at the surface]).
    """
    pii = (p / c.P0) ** c.RCP
    t_air = theta * pii

    # ---- 1. mixed-layer source parcel --------------------------------
    p_sfc = p[0:1]
    in_ml = (p_sfc - p) < ML_DEPTH
    wgt = in_ml.to(theta.dtype)
    wsum = torch.clamp(torch.sum(wgt, dim=0), min=1.0)
    th_ml = torch.sum(theta * wgt, dim=0) / wsum
    qv_ml = torch.sum(qv * wgt, dim=0) / wsum
    t_ml = th_ml * pii[0]
    # Bolton LCL temperature from the parcel vapor pressure
    e_ml = torch.clamp(p[0] * qv_ml / (c.EP_2 + qv_ml), min=1.0)
    t_lcl = 2840.0 / (3.5 * torch.log(t_ml) - torch.log(e_ml / 100.0) - 4.805) + 55.0
    t_lcl = torch.minimum(t_lcl, t_ml)
    p_lcl = p[0] * (t_lcl / t_ml) ** (c.CP / c.R_D)

    # ---- 2. reference moist adiabat above the LCL ---------------------
    theta_e_p = _theta_e(t_lcl, p_lcl, _qvs(p_lcl, t_lcl))
    t_ref = _moist_adiabat_t(theta_e_p[None], p, t_air)

    # ---- 3. cloud layer (contiguous buoyant levels above the LFC) ------
    above_base = p <= p_lcl[None]
    buoyant = t_ref >= t_air - DT_BUOY
    # the LFC is the first buoyant level above the LCL: a CIN layer below
    # it must not terminate the search (the reference walks upward past
    # non-buoyant levels until the parcel becomes buoyant)
    above_lfc = torch.cumsum((above_base & buoyant).to(theta.dtype),
                             dim=0) > 0.0
    # first non-buoyant level above the LFC terminates the cloud
    stop = above_lfc & (~buoyant)
    blocked = torch.cumsum(stop.to(theta.dtype), dim=0) > 0.0
    in_cloud = above_lfc & buoyant & (~blocked)
    depth = torch.sum(torch.where(in_cloud, dz, 0.0), dim=0)
    active = depth > DEPTH_MIN                       # (ny, nx)

    # ---- 4. reference profiles ----------------------------------------
    # RH ramp 0.95 (base) -> 0.75 (top) weighted by height inside the cloud
    zc = torch.cumsum(torch.where(in_cloud, dz, 0.0), dim=0)
    frac = torch.where(depth[None] > 0.0, zc / torch.clamp(depth[None], min=1.0), 0.0)
    rh_ref = 0.95 - 0.20 * torch.clamp(frac, 0.0, 1.0)
    q_ref = rh_ref * _qvs(p, t_ref)

    dm = rho * dz                                    # layer mass [kg/m2]
    mask = in_cloud.to(theta.dtype)

    # ---- 4b. humidity sweep toward drier profiles -----------------------
    # The reference iterates the deficit-saturation-pressure profile drier
    # until the column adjustment produces net drying (positive DENTPY /
    # precipitation), only then accepting deep convection.  Branchless
    # fixed-count equivalent: scale the reference RH down by 0.75 per
    # sweep while the column would still moisten.
    scale = torch.ones_like(depth)
    for _ in range(8):
        dq_try = torch.sum(mask * dm * (qv - scale[None] * q_ref), dim=0)
        scale = torch.where(dq_try <= 0.0, scale * 0.75, scale)
    q_ref = scale[None] * q_ref

    # ---- 5. enthalpy-conserving shift + relaxation ---------------------
    num = torch.sum(mask * dm * (c.CP * (t_ref - t_air)
                               + c.XLV * (q_ref - qv)), dim=0)
    den = torch.clamp(torch.sum(mask * dm * c.CP, dim=0), min=1.0)
    t_ref = t_ref - num[None] / den[None]            # BMJ first-guess shift

    # precipitation = column net drying; deactivate moistening columns
    dq_col = torch.sum(mask * dm * (qv - q_ref), dim=0) / TAU_ADJ  # [kg/m2/s]
    active = active & (dq_col > 0.0)
    act = active.to(theta.dtype)[None] * mask

    dth = act * (t_ref - t_air) / pii / TAU_ADJ
    dqv = act * (q_ref - qv) / TAU_ADJ
    precip = torch.where(active, dq_col, 0.0)          # [kg m-2 s-1] == [mm/s]
    return {"th": dth, "qv": dqv}, precip
