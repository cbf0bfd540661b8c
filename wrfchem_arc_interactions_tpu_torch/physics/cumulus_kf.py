"""Mass-flux cumulus: a Kain-Fritsch-style entraining plume with a
CAPE-removal closure (port of the JAX package's `physics/cumulus_kf.py`;
canonical phys/module_cu_kfeta.F, cu_physics=1).

A mixed-layer source parcel and its LCL; an entraining ascent at a constant
fractional rate (a Python loop over z, one level a pass); the in-cloud
temperature by BMJ's theta_e inversion; the trigger CAPE > 50 J/kg and a
cloud deeper than 3 km; unit-mass-flux tendencies of compensating
subsidence and detrainment at the cloud top; the cloud-base mass flux that
removes the CAPE over tau_cape, capped by the layer mass a step can move;
precipitation from the plume's condensate, a fraction evaporated into the
subcloud layer.  The simplifications are the reference's: no explicit
downdraft, a constant entrainment rate, one updraft a column.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.physics.cumulus import (
    ML_DEPTH, _moist_adiabat_t, _theta_e,
)
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import _qvs
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

EPS_ENT = 5.0e-5       # fractional entrainment rate [1/m] (KF's value for
                       # a ~1-2 km updraft radius)
DEL_DET = 5.0e-5       # background detrainment below the top [1/m]
TAU_CAPE = 2700.0      # CAPE-removal timescale [s] (KF: 0.5-1 h)
CAPE_MIN = 50.0        # trigger threshold [J/kg]
DEPTH_MIN = 3000.0     # minimum cloud depth [m]
PE_RAIN = 0.9          # precipitation efficiency
EVAP_SUB = 0.3         # fraction of rain evaporated into the subcloud layer


def kf_mass_flux(theta: torch.Tensor, qv: torch.Tensor, p: torch.Tensor,
                 rho: torch.Tensor, dz: torch.Tensor, dt: float,
                 eps_ent=EPS_ENT, del_det=DEL_DET, tau_cape=TAU_CAPE,
                 pe_rain=PE_RAIN
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """KF-style tendencies. Inputs (nz, ny, nx), k=0 surface. Returns
    ({"th": dtheta/dt, "qv": dqv/dt}, precip rate [mm/s]).

    The plume parameters are arguments so that the Grell-style ensemble
    (cumulus_grell.py) can run its members through this function; the
    defaults are the single-member KF configuration."""
    pii = (p / c.P0) ** c.RCP
    t_air = theta * pii
    nz = theta.shape[0]

    # ---- 1. source parcel ------------------------------------------------
    in_ml = (p[0:1] - p) < ML_DEPTH
    wgt = in_ml.to(theta.dtype)
    wsum = torch.clamp(torch.sum(wgt, dim=0), min=1.0)
    th_ml = torch.sum(theta * wgt, dim=0) / wsum
    qv_ml = torch.sum(qv * wgt, dim=0) / wsum
    t_ml = th_ml * pii[0]
    e_ml = torch.clamp(p[0] * qv_ml / (c.EP_2 + qv_ml), min=1.0)
    t_lcl = 2840.0 / (3.5 * torch.log(t_ml) - torch.log(e_ml / 100.0) - 4.805) + 55.0
    t_lcl = torch.minimum(t_lcl, t_ml)
    p_lcl = p[0] * (t_lcl / t_ml) ** (c.CP / c.R_D)

    # ---- 2. entraining ascent (scan up) ----------------------------------
    the_env = _theta_e(t_air, p, qv)
    the0 = _theta_e(t_lcl, p_lcl, _qvs(p_lcl, t_lcl))

    # entraining ascent, level by level from the surface: the parcel's
    # theta_e dilutes into the environment, the normalised mass flux grows
    # by entrainment less detrainment
    the_u_k, eta_k = the0, torch.ones_like(the0)
    the_us, etas = [], []
    for k in range(nz):
        f = torch.clamp(eps_ent * dz[k], 0.0, 0.5)
        the_u_k = the_u_k * (1.0 - f) + the_env[k] * f
        eta_k = eta_k * (1.0 + f - torch.clamp(del_det * dz[k], 0.0, 0.5))
        the_us.append(the_u_k)
        etas.append(eta_k)
    the_u, eta = torch.stack(the_us), torch.stack(etas)

    # in-cloud temperature from theta_e inversion (above the LCL only)
    t_u = _moist_adiabat_t(the_u, p, t_air)
    above_base = p <= p_lcl[None]
    buoy = t_u * (1.0 + 0.61 * _qvs(p, t_u)) - t_air * (1.0 + 0.61 * qv)
    buoyant = buoy > 0.0
    above_lfc = torch.cumsum((above_base & buoyant).to(theta.dtype), dim=0) > 0.0
    stop = above_lfc & (~buoyant)
    blocked = torch.cumsum(stop.to(theta.dtype), dim=0) > 0.0
    in_cloud = above_lfc & buoyant & (~blocked)
    depth = torch.sum(torch.where(in_cloud, dz, 0.0), dim=0)

    # CAPE over the cloud layer
    cape = torch.sum(torch.where(in_cloud, c.G * buoy / t_air * dz, 0.0), dim=0)
    active = (cape > CAPE_MIN) & (depth > DEPTH_MIN)

    # ---- 5a. unit-Mb tendencies -------------------------------------------
    # normalized cloud mass flux: eta inside the cloud; mass continuity
    # extends the compensating subsidence through the subcloud/CIN layers
    # (the updraft draws its mass from below cloud base), which is what
    # dries the source layer and closes the column moisture budget
    mask = in_cloud.to(theta.dtype)
    below_base = ~above_lfc
    eta_c = eta * mask + below_base.to(theta.dtype)
    # compensating subsidence on theta and qv (upwind d/dz toward surface)
    dth_dz = torch.cat([theta[1:] - theta[:-1],
                              torch.zeros_like(theta[:1])], dim=0) / dz
    dqv_dz = torch.cat([qv[1:] - qv[:-1],
                              torch.zeros_like(qv[:1])], dim=0) / dz
    # compensating subsidence WARMS/dries: +Mc/rho dX/dz (environment air
    # descends between updrafts)
    sub_th = eta_c * dth_dz / rho                    # per unit Mb [K m2/kg]
    sub_qv = eta_c * dqv_dz / rho
    # detrainment at the top layer of the cloud: deposit cloud properties
    top_idx = torch.sum(mask, dim=0, keepdim=True)   # count of cloudy layers
    kidx = torch.cumsum(mask, dim=0)
    is_top = mask * (kidx == top_idx).to(theta.dtype)
    th_u = t_u / pii
    det_th = is_top * eta_c * (th_u - theta) / (rho * dz)
    qvs_u = _qvs(p, t_u)
    det_qv = is_top * eta_c * (qvs_u - qv) / (rho * dz)

    dth_unit = sub_th + det_th
    dqv_unit = sub_qv + det_qv

    # condensation in the updraft per unit Mb: moisture convergence of the
    # plume = entrained vapor flux minus detrained saturation vapor
    qt_excess = torch.clamp(qv_ml[None] - qvs_u, min=0.0)
    cond_unit = torch.sum(mask * eta_c * qt_excess * eps_ent * dz
                        + is_top * eta_c * qt_excess, dim=0)

    # ---- 4. CAPE-removal closure ------------------------------------------
    # dCAPE/dMb: warming the ENVIRONMENT reduces the parcel buoyancy
    # integral, so dCAPE = -int g/T dT_env dz over the cloud layer
    dcape_unit = -torch.sum(mask * c.G / t_air * (dth_unit * pii) * dz, dim=0)
    mb = torch.where(dcape_unit < -1e-10,
                   cape / (tau_cape * torch.clamp(-dcape_unit, min=1e-10)), 0.0)
    # stability bound: subsidence CFL — at most the layer mass per step
    mb_max = 0.5 * torch.amin(
        torch.where(mask > 0, rho * dz / torch.clamp(eta_c, min=1e-3), 1e9), dim=0) / dt
    mb = torch.minimum(mb, mb_max)
    act = active.to(theta.dtype)
    mb = mb * act

    dth = mb[None] * dth_unit
    dqv = mb[None] * dqv_unit
    rain = pe_rain * mb * cond_unit                   # [kg m-2 s-1]

    # ---- 5b. subcloud evaporation (bulk downdraft role) -------------------
    sub_mask = (~above_base).to(theta.dtype)
    m_sub = torch.sum(sub_mask * rho * dz, dim=0)
    evap = EVAP_SUB * rain
    dqv = dqv + sub_mask * (evap / torch.clamp(m_sub, min=1.0))[None]
    dth = dth - sub_mask * (c.XLV / c.CP / pii) \
        * (evap / torch.clamp(m_sub, min=1.0))[None]
    rain = rain - evap
    return {"th": dth, "qv": dqv}, torch.clamp(rain, min=0.0)
