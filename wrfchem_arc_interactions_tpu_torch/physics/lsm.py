"""Noah-class land-surface model (port of the JAX package's
`physics/lsm.py`; canonical phys/module_sf_noahdrv.F and
module_sf_noahlsm.F, sf_surface_physics=2): 4-layer soil temperature and
moisture, canopy-resistance evaporation, a snowpack and vegetation classes.

Per column, elementwise over (ny, nx) with the 4 soil layers unrolled:
the skin energy balance with a linearised emission term, the soil heat
diffusion by an unrolled 4-row Thomas solve anchored at the deep soil
temperature, beta-method evaporation through a canopy resistance in series
with the aerodynamic one, bucket hydrology with inter-layer diffusion and
drainage, and a snowpack (accumulation below freezing, sublimation first,
melt capping the skin at 0 C).  The simplifications are the reference's:
one soil texture (loam) and no canopy interception store.
"""

from __future__ import annotations

from typing import Dict

import torch

from wrfchem_arc_interactions_tpu_torch.utils import constants as c

DZ_SOIL = (0.1, 0.3, 0.6, 1.0)   # Noah layer thicknesses [m]
SM_SAT = 0.45                    # porosity [m3/m3] (loam)
SM_FC = 0.33                     # field capacity
SM_WLT = 0.10                    # wilting point
K_SOIL_DRY = 0.25                # dry thermal conductivity [W/m/K]
K_SOIL_WET = 1.6
C_SOIL = 2.2e6                   # volumetric heat capacity [J/m3/K]
D_SM = 2.0e-7                    # soil moisture diffusivity [m2/s]
K_DRAIN = 3.0e-8                 # gravitational drainage [m/s] at saturation
RC_MIN = 70.0                    # minimum canopy resistance [s/m]
LAI = 2.0
ALBEDO = 0.2
EMISS = 0.98
C_SKIN = 2.0e4                   # skin heat capacity [J/m2/K]

# snowpack constants
T_FRZ = 273.15
RHO_SNOW = 150.0                 # bulk pack density [kg/m3]
K_SNOW = 0.3                     # pack thermal conductivity [W/m/K]
ALB_SNOW = 0.7
SWE_FULL = 10.0                  # SWE [kg/m2] for ~full snow cover
XLF = 3.34e5                     # latent heat of fusion [J/kg]
XLS = 2.83e6                     # latent heat of sublimation [J/kg]

# vegetation classes (the VEGPARM.TBL role): index by ivgtyp
#   0 cropland/grass (default), 1 forest, 2 shrub/semi-arid, 3 bare soil,
#   4 urban, 5 water (not really land; kept wet)
VEG_RCMIN = (70.0, 150.0, 120.0, 400.0, 400.0, 20.0)
VEG_LAI = (2.0, 4.0, 1.2, 0.2, 0.5, 0.1)
VEG_ALB = (0.20, 0.12, 0.22, 0.30, 0.15, 0.08)


def veg_params(ivgtyp):
    """(rc_min, lai, albedo) fields from the class-index field (float or
    int (ny, nx); None -> class-0 defaults)."""
    if ivgtyp is None:
        return RC_MIN, LAI, ALBEDO
    idx = torch.clamp(ivgtyp.to(torch.int64), 0, len(VEG_RCMIN) - 1)

    def table(values):
        return torch.tensor(values, dtype=torch.float32, device=ivgtyp.device)[idx]

    return table(VEG_RCMIN), table(VEG_LAI), table(VEG_ALB)


def _k_soil(sm):
    w = torch.clamp((sm - SM_WLT) / (SM_SAT - SM_WLT), 0.0, 1.0)
    return K_SOIL_DRY + (K_SOIL_WET - K_SOIL_DRY) * w


def soil_beta(sm1):
    """Moisture-availability factor from layer-1 soil moisture."""
    return torch.clamp((sm1 - SM_WLT) / (SM_FC - SM_WLT), 0.02, 1.0)


def noah_step(state: Dict[str, torch.Tensor], hfx, qfx_pot, ra, rho0,
              precip_rate, swdown, glw, dt: float,
              t_air0=None) -> Dict[str, torch.Tensor]:
    """Advance (tsk, tslb, smois[, snow]). qfx_pot: potential evaporation
    [kg/m2/s] at beta=1 without canopy resistance; ra: aerodynamic
    resistance [s/m]; t_air0: lowest-level air temperature (rain/snow
    partition; defaults to tsk).  Returns updated state dict entries +
    'qfx_eff'."""
    tslb = state["tslb"]                          # (4, ny, nx)
    smois = state["smois"]
    tsk = state["tsk"]
    tmn = state.get("tmn", tslb[-1])
    snow = state.get("snow")                      # SWE [kg/m2] or None
    has_snow_state = snow is not None
    if not has_snow_state:
        snow = torch.zeros_like(tsk)
    t_sfc_air = tsk if t_air0 is None else t_air0
    rc_min, lai, alb_veg = veg_params(state.get("ivgtyp"))

    # ---- 5a. snowfall accumulation ----------------------------------------
    frozen = t_sfc_air < T_FRZ
    snowfall = torch.where(frozen, precip_rate, 0.0)        # kg/m2/s (= mm/s)
    rain_liquid = torch.where(frozen, 0.0, precip_rate)
    snow = snow + dt * snowfall
    snow_cover = torch.clamp(snow / SWE_FULL, 0.0, 1.0)

    # ---- 3. actual evaporation (sublimation from the pack first) ----------
    beta = soil_beta(smois[0])
    f_sm = soil_beta(0.5 * (smois[0] + smois[1]))
    rc = rc_min / (lai * f_sm)
    qfx_soil = qfx_pot * beta * ra / (ra + rc)
    # snow-covered fraction sublimates at the potential rate, bounded by
    # the pack over this step
    qfx_snow = torch.minimum(snow_cover * torch.clamp(qfx_pot, min=0.0),
                             snow / max(dt, 1e-6))
    snow = torch.clamp(snow - dt * qfx_snow, min=0.0)
    qfx = (1.0 - snow_cover) * qfx_soil + qfx_snow
    lh = c.XLV * (1.0 - snow_cover) * qfx_soil + XLS * qfx_snow

    # ---- 1. skin energy balance (linearised emission) ----------------------
    albedo = alb_veg * (1.0 - snow_cover) + ALB_SNOW * snow_cover
    rn = (1.0 - albedo) * swdown + EMISS * (glw - c.STBOLT * tsk ** 4)
    k_soil1 = _k_soil(smois[0])
    # ground-heat path: soil half-layer in series with the snow pack
    d_snow = snow / RHO_SNOW
    r_ground = 0.5 * DZ_SOIL[0] / k_soil1 + d_snow / K_SNOW
    k1 = (0.5 * DZ_SOIL[0]) / r_ground            # effective conductance base
    g_flux = (tsk - tslb[0]) / r_ground
    resid = rn - hfx - lh - g_flux
    # implicit-in-emission update: d(resid)/dTsk ~ -4 eps sig T^3 - 1/r
    denom = C_SKIN / dt + 4.0 * EMISS * c.STBOLT * tsk ** 3 + 1.0 / r_ground
    tsk_new = tsk + resid / denom

    # ---- 5b. snowmelt: cap the skin at 0 C while snow remains; the energy
    # that would overshoot melts the pack, melt water joins infiltration
    overshoot = torch.clamp(tsk_new - T_FRZ, min=0.0)
    melt_energy = overshoot * denom               # W/m2 equivalent
    had_snow = snow > 0.0
    melt = torch.where(had_snow, torch.minimum(melt_energy / XLF, snow / dt), 0.0)
    snow = torch.clamp(snow - dt * melt, min=0.0)
    # the energy consumed by melting is removed from the skin overshoot:
    # while the pack survives this zeroes the overshoot (skin held at 0 C);
    # if the pack is exhausted mid-step only the residual overshoot remains
    tsk_new = torch.where(had_snow & (tsk_new > T_FRZ),
                          T_FRZ + torch.clamp(overshoot - melt * XLF / denom, min=0.0),
                          tsk_new)
    rain_liquid = rain_liquid + melt

    # ---- 2. soil heat diffusion (4-layer implicit, unrolled Thomas) -------
    kf = [0.5 * (_k_soil(smois[i]) + _k_soil(smois[i + 1])) for i in range(3)]
    dz = DZ_SOIL
    dzw = [0.5 * (dz[i] + dz[i + 1]) for i in range(3)]
    g_top = k1 * (tsk_new - tslb[0]) / (0.5 * dz[0])
    k_bot = _k_soil(smois[3])
    # rows: C_SOIL dz_i dT_i/dt = F_{i-1/2} - F_{i+1/2}
    a = [0.0] * 4
    b = [0.0] * 4
    cc = [0.0] * 4
    d = [tslb[i] for i in range(4)]
    for i in range(4):
        lam = dt / (C_SOIL * dz[i])
        up = kf[i - 1] / dzw[i - 1] if i > 0 else 0.0
        dn = kf[i] / dzw[i] if i < 3 else k_bot / dz[3]
        a[i] = -lam * up
        cc[i] = -lam * dn if i < 3 else 0.0
        b[i] = 1.0 + lam * (up + dn)
        if i == 0:
            d[i] = d[i] + dt * g_top / (C_SOIL * dz[0])
        if i == 3:
            d[i] = d[i] + lam * (k_bot / dz[3]) * tmn
    # unrolled Thomas over 4 rows
    cp = [None] * 4
    dp = [None] * 4
    cp[0] = cc[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, 4):
        m = b[i] - a[i] * cp[i - 1]
        cp[i] = cc[i] / m if i < 3 else 0.0
        dp[i] = (d[i] - a[i] * dp[i - 1]) / m
    t_new = [None] * 4
    t_new[3] = dp[3]
    for i in range(2, -1, -1):
        t_new[i] = dp[i] - cp[i] * t_new[i + 1]
    tslb_new = torch.stack(t_new)

    # ---- 4. bucket hydrology ----------------------------------------------
    sm = [smois[i] for i in range(4)]
    # infiltration of LIQUID water (rain + snowmelt; frozen precip sits in
    # the pack) + evaporation on layer 1 [m3/m3 per layer depth]
    infil = rain_liquid * 1e-3 / dz[0]            # mm/s -> m/s / dz
    sm[0] = sm[0] + dt * (infil - (1.0 - snow_cover) * qfx_soil
                          / (1000.0 * dz[0]))
    # inter-layer diffusion + drainage
    for i in range(3):
        grad = (sm[i] - sm[i + 1]) / dzw[i]
        flux = D_SM * grad + K_DRAIN * torch.clamp(sm[i] / SM_SAT, 0.0, 1.0) ** 3
        sm[i] = sm[i] - dt * flux / dz[i]
        sm[i + 1] = sm[i + 1] + dt * flux / dz[i + 1]
    drain = K_DRAIN * torch.clamp(sm[3] / SM_SAT, 0.0, 1.0) ** 3
    sm[3] = sm[3] - dt * drain / dz[3]
    smois_new = torch.stack([torch.clamp(s, 0.02, SM_SAT) for s in sm])

    out = {"tsk": tsk_new, "tslb": tslb_new, "smois": smois_new,
           "qfx_eff": qfx}
    if has_snow_state:
        out["snow"] = snow
    return out
