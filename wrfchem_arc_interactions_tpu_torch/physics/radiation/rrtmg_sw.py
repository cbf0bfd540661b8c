"""Shortwave spectral radiative transfer (port of the JAX package's
`physics/radiation/rrtmg_sw.py`; canonical: phys/module_ra_rrtmg_sw.F —
rrtmg_sw / taumol_sw / reftra_sw / spcvmc_sw).

14 bands x 112 g-points.  Per (g-point, layer, column): gas absorption,
Rayleigh scattering, cloud liquid and aerosol (tau, ssa, g) per band (the
ARC direct effect), delta-Eddington scaling and the Meador-Weaver
two-stream layer reflectance/transmittance; then the vertical adding
method as two loops over z on (g-point, column) planes: an upward pass
building the reflectance of the stack below each face, and a downward pass
carrying the direct beam and the diffuse flux.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands, gas_optics, ktables
from wrfchem_arc_interactions_tpu_torch.physics.radiation import mcica
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

# cloud liquid optics (parameterised, re ~ 10 um): tau = 3 LWP/(2 rho_w re)
RE_LIQ = 10.0e-6
SSA_LIQ = 0.995
ASY_LIQ = 0.85
EPS = 1e-6


def cloud_tau_sw(lwp: torch.Tensor, re_liq=None) -> torch.Tensor:
    """Geometric-optics liquid cloud extinction tau = 3 LWP / (2 rho_w re).

    `re_liq` (same shape as lwp, metres) carries the microphysics-coupled
    droplet effective radius — the Twomey / first-indirect pathway: higher
    activated Nc at fixed LWC gives smaller re, larger tau, brighter cloud.
    None keeps the fixed 10 um used when droplet number is not prognostic."""
    re = RE_LIQ if re_liq is None else re_liq
    return 1.5 * lwp / (c.RHOWATER * re)


def two_stream(tau, ssa, asy, mu0):
    """Meador-Weaver hemispheric-mean two-stream with delta scaling.

    All arguments elementwise; mu0 broadcastable.  Returns (r_dif, t_dif,
    r_dir, t_dir, t0): diffuse reflectance/transmittance, direct-beam
    reflectance/transmittance (to diffuse), and direct transmittance.
    """
    # delta-Eddington scaling
    f = asy * asy
    tau_d = (1.0 - ssa * f) * tau
    ssa_d = torch.clamp((1.0 - f) * ssa / (1.0 - ssa * f + EPS), 0.0, 1.0 - EPS)
    g_d = asy / (1.0 + asy)

    gamma1 = (7.0 - ssa_d * (4.0 + 3.0 * g_d)) * 0.25
    gamma2 = -(1.0 - ssa_d * (4.0 - 3.0 * g_d)) * 0.25
    gamma2 = torch.clamp(gamma2, min=EPS)
    gamma3 = (2.0 - 3.0 * g_d * mu0) * 0.25
    gamma4 = 1.0 - gamma3

    k = torch.sqrt(torch.clamp(gamma1 * gamma1 - gamma2 * gamma2, min=EPS))
    ktau = torch.clamp(k * tau_d, max=50.0)
    ek = torch.exp(ktau)
    ek_inv = 1.0 / ek

    denom_dif = k * (ek + ek_inv) + gamma1 * (ek - ek_inv)
    r_dif = torch.clamp(gamma2 * (ek - ek_inv) / (denom_dif + EPS), 0.0, 1.0)
    t_dif = torch.clamp(2.0 * k / (denom_dif + EPS), 0.0, 1.0)
    # joint energy bound for the diffuse pair
    t_dif = torch.minimum(t_dif, 1.0 - r_dif)

    t0 = torch.exp(-torch.clamp(tau_d / torch.clamp(mu0, min=1e-3), max=50.0))

    # direct-beam source terms (Meador-Weaver); guard the k*mu0 -> 1 resonance
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4
    kmu = k * mu0
    # push kmu out of the catastrophically cancelling window around 1
    kmu = 1.0 + torch.sign(kmu - 1.0) * torch.clamp(torch.abs(kmu - 1.0), min=0.12)
    denom_dir = 1.0 - kmu * kmu

    # Meador & Weaver (1980) eqs. 14-15 (flux normalisation, diffuse parts)
    r_dir = ssa_d / denom_dir / (denom_dif + EPS) * (
        (1.0 - kmu) * (alpha2 + k * gamma3) * ek
        - (1.0 + kmu) * (alpha2 - k * gamma3) * ek_inv
        - 2.0 * k * (gamma3 - alpha2 * mu0) * t0
    )
    t_dir = -ssa_d / denom_dir / (denom_dif + EPS) * (
        (1.0 + kmu) * (alpha1 + k * gamma4) * ek * t0
        - (1.0 - kmu) * (alpha1 - k * gamma4) * ek_inv * t0
        - 2.0 * k * (gamma4 + alpha1 * mu0)
    )
    # joint direct-beam energy budget: cap scattered-up first, then
    # scattered-down by the remainder
    r_dir = torch.minimum(torch.clamp(r_dir, min=0.0),
                          torch.clamp(1.0 - t0, min=0.0))
    t_dir = torch.minimum(torch.clamp(t_dir, min=0.0),
                          torch.clamp(1.0 - t0 - r_dir, min=0.0))
    return r_dif, t_dif, r_dir, t_dir, t0


def sw_fluxes(p_lay, t_lay, dp_lay, qv, lwp, mu0, albedo,
              tau_aer_sw: Optional[torch.Tensor] = None,
              ssa_aer_sw: Optional[torch.Tensor] = None,
              asy_aer_sw: Optional[torch.Tensor] = None,
              cldfra: Optional[torch.Tensor] = None,
              mcica_seed=0,
              re_liq: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """SW flux profiles.  Inputs (nz, ncol); mu0, albedo (ncol,); aerosol
    arrays (nband_sw, nz, ncol).  Returns face fluxes (nz+1, ncol), heating
    (nz, ncol), and the surface / TOA diagnostics.

    With `cldfra` (nz, ncol), partial cloudiness is handled by McICA: each
    g-point samples a binary max-random-overlap subcolumn and carries the
    in-cloud condensate lwp/cldfra; without it, clouds are overcast
    wherever lwp > 0."""
    tabs = ktables.load_tables()
    dev = p_lay.device
    band_of_g = torch.as_tensor(bands.BAND_OF_GPT_SW, device=dev)
    e0_g = gas_optics.table(tabs.solar_src_sw, p_lay).reshape(-1, 1)   # (ngpt,1)

    tau_gas = gas_optics.gas_tau("sw", p_lay, t_lay, dp_lay, qv)
    tau_ray = gas_optics.rayleigh_tau(dp_lay)
    if cldfra is not None:
        cf = torch.clamp(cldfra, 0.0, 1.0)
        mask = mcica.mcica_mask(cf, tau_gas.shape[0], mcica_seed)
        lwp_ic = lwp / torch.clamp(cf, min=mcica.CF_MIN)
        tau_cld = cloud_tau_sw(lwp_ic, re_liq)[None] * mask
    else:
        tau_cld = cloud_tau_sw(lwp, re_liq)[None]

    tau_tot = tau_gas + tau_ray + tau_cld
    w_ray = tau_ray
    w_cld = SSA_LIQ * tau_cld
    wg_cld = ASY_LIQ * w_cld
    w_sum = w_ray + w_cld
    wg_sum = wg_cld
    if tau_aer_sw is not None:
        t_a = tau_aer_sw[band_of_g]
        w_a = (ssa_aer_sw * tau_aer_sw)[band_of_g]
        wg_a = (asy_aer_sw * ssa_aer_sw * tau_aer_sw)[band_of_g]
        tau_tot = tau_tot + t_a
        w_sum = w_sum + w_a
        wg_sum = wg_sum + wg_a
    ssa_tot = torch.clamp(w_sum / (tau_tot + EPS), EPS, 1.0 - EPS)
    asy_tot = wg_sum / (w_sum + EPS)

    mu0b = torch.clamp(mu0, min=1e-3)[None, None]        # (1, 1, ncol)
    r_dif, t_dif, r_dir, t_dir, t0 = two_stream(tau_tot, ssa_tot, asy_tot, mu0b)
    nz = p_lay.shape[0]

    # upward pass: reflectance of everything below face k (face k = bottom
    # of layer k), from the surface albedo up; face nz is the TOA value
    alb = albedo[None].expand(r_dif.shape[0], -1)
    rb_dif = [alb]
    rb_dir = [alb]
    for k in range(nz):
        rd, td, rdr, tdr, tt0 = r_dif[:, k], t_dif[:, k], r_dir[:, k], t_dir[:, k], t0[:, k]
        d = 1.0 / (1.0 - rd * rb_dif[k])
        rb_dir.append(rdr + (tt0 * rb_dir[k] + tdr * rb_dif[k]) * td * d)
        rb_dif.append(rd + td * td * rb_dif[k] * d)
    rb_dif_faces = torch.stack(rb_dif)                    # (nz+1, ngpt, ncol)
    rb_dir_faces = torch.stack(rb_dir)

    # downward pass from the TOA: the direct beam S and diffuse flux Fd at
    # the face above each layer give the values at the face below
    s_toa = e0_g * torch.clamp(mu0, min=0.0)[None]         # (ngpt, ncol)
    zeros = torch.zeros_like(s_toa)
    s_f = [None] * nz + [s_toa]
    fd_f = [None] * nz + [zeros]
    for k in range(nz - 1, -1, -1):
        rd, td, rdr, tdr, tt0 = r_dif[:, k], t_dif[:, k], r_dir[:, k], t_dir[:, k], t0[:, k]
        s_above, fd_above = s_f[k + 1], fd_f[k + 1]
        d = 1.0 / (1.0 - rd * rb_dif_faces[k])
        s_f[k] = s_above * tt0
        fd_f[k] = d * (td * fd_above + s_above * (tdr + tt0 * rb_dir_faces[k] * rd))
    s_f = torch.stack(s_f)                                 # faces 0..nz
    fd_f = torch.stack(fd_f)
    fu_f = rb_dif_faces * fd_f + rb_dir_faces * s_f

    fdn_tot = torch.sum(s_f + fd_f, dim=1)                 # (nz+1, ncol)
    fup_tot = torch.sum(fu_f, dim=1)
    fnet = fdn_tot - fup_tot                               # net DOWNWARD
    hr = (fnet[1:] - fnet[:-1]) * c.G / (c.CP * dp_lay)
    night = (mu0 <= 0.0)[None]
    fdn_tot = torch.where(night, 0.0, fdn_tot)
    fup_tot = torch.where(night, 0.0, fup_tot)
    hr = torch.where(night, 0.0, hr)
    return {"flux_dn": fdn_tot, "flux_up": fup_tot, "heating": hr,
            "swdown": fdn_tot[0], "swup_toa": fup_tot[-1]}
