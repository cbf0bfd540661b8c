"""Fast-J-style spectral photolysis (port of the JAX package's
`chem/photolysis.py`; canonical: chem/module_phot_fastj.F /
module_ftuv_driver.F).

The canonical code computes wavelength-resolved actinic fluxes through the
cloudy, aerosol-laden atmosphere and contracts them with species
cross-sections x quantum yields to get J-rates. This module does the same:

- **7 wavelength bins** spanning the photochemically active window
  (289-700 nm, the classic tropospheric Fast-J binning).
- Per-layer, per-bin optical properties assembled from: Rayleigh scattering
  (sigma ~ lambda^-4), **prognostic O3 absorption** (Hartley/Huggins/
  Chappuis bands off the transported chem_o3 field), cloud droplets
  (tau from LWP, conservative scattering), and the **chem-computed aerosol
  optical state** (tau/ssa/asy per RRTMG SW band, nearest-band mapped) —
  both ARC pathways (cloud->J and aerosol->J) flow through here.
- The same delta-Eddington/Meador-Weaver **two-stream + adding** solver as
  the SW radiation (physics/radiation/rrtmg_sw.two_stream), batched over
  (wavelength-bin, column) — dense and branchless.  The two adding sweeps
  over the layers are Python loops: about 2 nz steps of a few small
  launches each per call.
- Mean actinic flux at layer centres: A = S/mu0 + 2*(F_dn_dif + F_up_dif)
  (direct scalar flux + hemispheric diffuse with diffusivity factor 2).
- **Anchoring**: absolute cross-sections are not transcribed, so each photolysis
  reaction carries a *relative* spectral response W_r(w) and its clear-sky
  magnitude is anchored to gas.J_CLEAR at the overhead-sun standard
  atmosphere: J_r = J_CLEAR[r] * <W_r, A> / <W_r, A_ref>. Spectral physics
  (O3-column dependence, cloud/aerosol modulation differing per species)
  is therefore real; absolute magnitudes equal the documented literature
  values by construction.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands as rbands
from wrfchem_arc_interactions_tpu_torch.physics.radiation.rrtmg_sw import two_stream

# ---------------------------------------------------------------- spectral
# bin centres [nm] and widths [nm] (289-700 nm window)
WL_NM = np.array([294.0, 303.0, 310.0, 316.0, 333.0, 380.0, 480.0])
DWL_NM = np.array([9.0, 9.0, 6.0, 7.0, 27.0, 68.0, 170.0])
NW = len(WL_NM)

# relative TOA actinic photon flux per bin: solar photon spectrum x width
# (shape matters, not scale — J is anchored to the clear-sky reference)
F_TOA = np.array([0.5, 1.3, 1.3, 1.9, 9.5, 40.0, 160.0])

# Rayleigh scattering cross-section [cm2/molec]: sigma(300nm)=5.6e-26,
# lambda^-4.05 slope (Bodhaine et al. 1999 shape)
SIGMA_RAY = 5.6e-26 * (300.0 / WL_NM) ** 4.05

# O3 absorption cross-section [cm2/molec]: Hartley band short of 310 nm,
# Huggins tail to ~360, Chappuis minimum in the visible
SIGMA_O3 = np.array([6.0e-19, 1.5e-19, 3.5e-20, 1.3e-20, 9.0e-22,
                     1.0e-23, 2.5e-21])

# per-reaction relative spectral response (cross-section x quantum-yield
# shape collapsed onto the 7 bins); rows normalized by the clear-sky anchor
SPECTRAL_W: Dict[str, np.ndarray] = {
    "o3_o1d": np.array([1.0, 0.6, 0.2, 0.04, 0.0, 0.0, 0.0]),
    "no2":    np.array([0.0, 0.05, 0.1, 0.2, 0.6, 1.0, 0.05]),
    "no3":    np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.05, 1.0]),
    "hono":   np.array([0.0, 0.05, 0.1, 0.2, 0.7, 1.0, 0.0]),
    "h2o2":   np.array([0.8, 0.8, 0.7, 0.6, 0.35, 0.0, 0.0]),
    "hcho_r": np.array([0.3, 0.6, 0.9, 1.0, 0.6, 0.0, 0.0]),
    "hcho_m": np.array([0.3, 0.6, 0.9, 1.0, 0.8, 0.0, 0.0]),
    "ald":    np.array([0.5, 0.7, 0.9, 0.8, 0.3, 0.0, 0.0]),
    "hno3":   np.array([1.0, 0.8, 0.5, 0.3, 0.1, 0.0, 0.0]),
    "hno4":   np.array([1.0, 0.8, 0.5, 0.3, 0.1, 0.0, 0.0]),
    "ch3ooh": np.array([0.8, 0.8, 0.7, 0.6, 0.35, 0.0, 0.0]),
    "rooh":   np.array([0.8, 0.8, 0.7, 0.6, 0.35, 0.0, 0.0]),
    "aone":   np.array([0.7, 0.9, 0.8, 0.6, 0.25, 0.0, 0.0]),
    "mgly":   np.array([0.0, 0.1, 0.2, 0.3, 0.6, 1.0, 0.3]),
    "open":   np.array([0.0, 0.1, 0.2, 0.3, 0.6, 1.0, 0.3]),
    "isoprd": np.array([0.3, 0.5, 0.7, 0.8, 0.5, 0.1, 0.0]),
    "onit":   np.array([0.8, 0.8, 0.7, 0.5, 0.25, 0.0, 0.0]),
    "pan":    np.array([0.9, 0.8, 0.6, 0.4, 0.12, 0.0, 0.0]),
}

# cloud droplet optics in the UV/vis: conservative scattering
SSA_CLD, ASY_CLD, RE_LIQ, RHOW = 0.9995, 0.85, 1.0e-5, 1000.0
ALB_SFC = 0.06          # broadband UV surface albedo
EPS = 1e-12
# molecules of air per cm2 per Pa of pressure thickness: 1/(g * m_air) / 1e4
MOLEC_PER_PA = 1.0 / (9.81 * 4.81e-26) * 1e-4

# nearest RRTMG SW band for each photolysis wavelength bin (aerosol optics
# are computed per SW band by chem/optics.py)
_SW_UM = rbands.band_centers_sw_um()
BAND_OF_WL = np.array([int(np.argmin(np.abs(_SW_UM - wl * 1e-3)))
                       for wl in WL_NM])


def actinic_flux(mu0, dp_lay, o3_vmr, lwp_lay,
                 tau_aer_sw: Optional[torch.Tensor] = None,
                 ssa_aer_sw: Optional[torch.Tensor] = None,
                 asy_aer_sw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean actinic flux per wavelength bin at layer centres.

    mu0 (...,) cos zenith; dp_lay/o3_vmr/lwp_lay (nz, ...) with k upward
    (layer 0 at the surface, the model convention); aerosol arrays
    (nband_sw, nz, ...). Returns (NW, nz, ...) in F_TOA-relative units.
    """
    dtype = dp_lay.dtype
    nz = dp_lay.shape[0]
    n_col = dp_lay * MOLEC_PER_PA                    # molec/cm2 per layer

    dev = dp_lay.device

    def table(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    s_ray = table(SIGMA_RAY).reshape((NW,) + (1,) * dp_lay.ndim)
    s_o3 = table(SIGMA_O3).reshape((NW,) + (1,) * dp_lay.ndim)

    tau_ray = s_ray * n_col[None]                    # (NW, nz, ...)
    tau_o3 = s_o3 * (o3_vmr * n_col)[None]
    tau_cld = (1.5 * lwp_lay / (RHOW * RE_LIQ))[None]

    tau = tau_ray + tau_o3 + tau_cld
    w_sum = tau_ray + SSA_CLD * tau_cld
    wg_sum = ASY_CLD * SSA_CLD * tau_cld
    if tau_aer_sw is not None:
        band = torch.as_tensor(BAND_OF_WL, dtype=torch.int64, device=dev)
        t_a = tau_aer_sw[band]
        w_a = (ssa_aer_sw * tau_aer_sw)[band] if ssa_aer_sw is not None \
            else 0.95 * t_a
        wg_a = (asy_aer_sw * ssa_aer_sw * tau_aer_sw)[band] \
            if asy_aer_sw is not None else 0.65 * w_a
        tau = tau + t_a
        w_sum = w_sum + w_a
        wg_sum = wg_sum + wg_a
    ssa = torch.clamp(w_sum / (tau + EPS), EPS, 1.0 - EPS)
    asy = wg_sum / (w_sum + EPS)

    mu0c = torch.clamp(mu0, min=1e-3)
    mu0b = mu0c[(None, None)]                        # (1, 1, ...)
    r_dif, t_dif, r_dir, t_dir, t0 = two_stream(tau, ssa, asy, mu0b)

    # z-leading for the adding sweeps: (nz, NW, ...)
    r_dif, t_dif, r_dir, t_dir, t0 = (
        torch.moveaxis(a, 1, 0) for a in (r_dif, t_dif, r_dir, t_dir, t0))

    # upward sweep: reflectances of everything below each face, surface up
    alb = torch.full(r_dif.shape[1:], ALB_SFC, dtype=dtype, device=dev)
    rb_dif, rb_dir = alb, alb
    rb_dif_f, rb_dir_f = [rb_dif], [rb_dir]
    for kz in range(nz):
        rd, td, rdr, tdr, tt0 = r_dif[kz], t_dif[kz], r_dir[kz], t_dir[kz], t0[kz]
        d = 1.0 / (1.0 - rd * rb_dif)
        rb_dir = rdr + (tt0 * rb_dir + tdr * rb_dif) * td * d
        rb_dif = rd + td * td * rb_dif * d
        rb_dif_f.append(rb_dif)
        rb_dir_f.append(rb_dir)
    rb_dif_faces = torch.stack(rb_dif_f)                 # faces 0..nz
    rb_dir_faces = torch.stack(rb_dir_f)

    # direct irradiance on the horizontal at TOA per bin
    f_toa = table(F_TOA).reshape((NW,) + (1,) * mu0.ndim)
    s_toa = torch.broadcast_to(f_toa * torch.clamp(mu0, min=0.0)[None],
                               r_dif.shape[1:]).to(dtype)

    # downward sweep: direct and diffuse fluxes at each face, TOA down
    zeros = torch.zeros_like(s_toa)
    s_above, fd_above = s_toa, zeros
    s_f, fd_f = [s_toa], [zeros]
    for kz in range(nz - 1, -1, -1):
        rd, td, tdr, tt0 = r_dif[kz], t_dif[kz], t_dir[kz], t0[kz]
        d = 1.0 / (1.0 - rd * rb_dif_faces[kz])
        fd_above = d * (td * fd_above
                        + s_above * (tdr + tt0 * rb_dir_faces[kz] * rd))
        s_above = s_above * tt0
        s_f.append(s_above)
        fd_f.append(fd_above)
    s_f = torch.stack(s_f[::-1])                         # faces 0..nz
    fd_f = torch.stack(fd_f[::-1])
    fu_f = rb_dif_faces * fd_f + rb_dir_faces * s_f

    # scalar (actinic) flux per face, then layer-centre average
    a_face = s_f / mu0b[0] + 2.0 * (fd_f + fu_f)
    a_lay = 0.5 * (a_face[:-1] + a_face[1:])         # (nz, NW, ...)
    a_lay = torch.where(mu0[(None, None)] <= 0.0, 0.0, a_lay)
    return torch.moveaxis(a_lay, 1, 0)                 # (NW, nz, ...)


@functools.lru_cache(maxsize=1)
def _reference_actinic() -> np.ndarray:
    """Clear-sky overhead-sun surface actinic flux per bin through the
    standard atmosphere (300 DU O3, Rayleigh only) — the anchor that maps
    relative spectral responses onto gas.J_CLEAR magnitudes."""
    nz = 40
    p_w = np.linspace(101325.0, 1000.0, nz + 1)
    dp = (p_w[:-1] - p_w[1:]).reshape(nz, 1)
    # O3 profile shaped like the standard atmosphere: bulk in a stratospheric
    # layer, scaled to a 300 DU total column (1 DU = 2.687e16 molec/cm2)
    z_mid = -7.5 * np.log(0.5 * (p_w[:-1] + p_w[1:]) / 101325.0)  # [km]
    shape = np.exp(-0.5 * ((z_mid - 23.0) / 5.0) ** 2) + 0.02
    n_col = dp[:, 0] * MOLEC_PER_PA
    o3_col_target = 300.0 * 2.687e16                 # molec/cm2
    o3_vmr = (shape / np.sum(shape * n_col) * o3_col_target).reshape(nz, 1)
    a = actinic_flux(torch.ones((1,), dtype=torch.float32),
                     torch.as_tensor(dp, dtype=torch.float32),
                     torch.as_tensor(o3_vmr, dtype=torch.float32),
                     torch.zeros((nz, 1), dtype=torch.float32))
    return a[:, 0, 0].numpy()                        # (NW,) surface layer


def j_scales(mu0, dp_lay, o3_vmr, lwp_lay,
             tau_aer_sw=None, ssa_aer_sw=None, asy_aer_sw=None
             ) -> Dict[str, torch.Tensor]:
    """Per-reaction J scale fields (dimensionless, =1 at the overhead-sun
    clear-sky standard atmosphere): {phot_name: (nz, ...)}.

    gas.rate_constants multiplies these with the J_CLEAR magnitudes."""
    a = actinic_flux(mu0, dp_lay, o3_vmr, lwp_lay,
                     tau_aer_sw, ssa_aer_sw, asy_aer_sw)   # (NW, nz, ...)
    a_ref = _reference_actinic()
    out = {}
    for name, w in SPECTRAL_W.items():
        denom = float(np.sum(w * a_ref))
        wj = torch.as_tensor(w / max(denom, 1e-30), dtype=a.dtype, device=a.device)
        out[name] = torch.tensordot(wj, a, dims=([0], [0]))    # (nz, ...)
    return out
