"""Longwave spectral radiative transfer (port of the JAX package's
`physics/radiation/rrtmg_lw.py`; canonical: phys/module_ra_rrtmg_lw.F —
rrtmg_lw / taumol / rtrnmc).

16 bands x 140 g-points over (g-point, layer, column).  Absorption-only RT
with the 1.66 diffusivity angle; clouds as liquid absorption, McICA-sampled
per g-point when a cloud fraction is given.  The spectral solve is two
loops over z on (g-point, column) planes: downward then upward emission /
transmission recursions.

Aerosol coupling (ARC direct effect): `tau_aer_lw` (nband_lw, nz, ncol)
absorption optical depths from chem optics are added to the gas optical
depth, broadcast over the g-points of each band.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands, gas_optics, ktables
from wrfchem_arc_interactions_tpu_torch.physics.radiation import mcica
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

DIFFUSIVITY = 1.66
ABS_LIQ = 0.07e3     # cloud liquid mass absorption [m2/kg] (~0.07 m2/g)


def band_planck_fractions(t: torch.Tensor) -> torch.Tensor:
    """Fraction of sigma T^4 emitted in each LW band: Planck radiance at the
    band centre x band width, renormalised.  t: (...,) -> (nband, ...)."""
    wn = 0.5 * (bands.WAVENUM_LW[:-1] + bands.WAVENUM_LW[1:])   # cm-1
    dwn = np.diff(bands.WAVENUM_LW)
    # Planck in wavenumber: B ~ wn^3 / (exp(c2 wn / T) - 1), c2 = 1.4388 K cm
    shape = (-1,) + (1,) * t.dim()
    wn_ = gas_optics.table(wn, t).reshape(shape)
    dwn_ = gas_optics.table(dwn, t).reshape(shape)
    x = 1.4388 * wn_ / torch.clamp(t, min=100.0)[None]
    b = wn_ ** 3 / torch.expm1(x) * dwn_
    return b / torch.sum(b, dim=0, keepdim=True)


def lw_fluxes(p_lay, t_lay, dp_lay, qv, lwp, t_sfc,
              tau_aer_lw: Optional[torch.Tensor] = None,
              emissivity: float = 0.98,
              cldfra: Optional[torch.Tensor] = None,
              mcica_seed=0) -> Dict[str, torch.Tensor]:
    """All inputs (nz, ncol) except t_sfc (ncol,) and tau_aer_lw
    (nband, nz, ncol).  Returns fluxes at faces (nz+1, ncol) and heating.

    lwp: layer cloud liquid water path [kg/m2].  With `cldfra` (nz, ncol),
    partial cloudiness is McICA-sampled per g-point (max-random overlap).
    """
    tabs = ktables.load_tables()
    ngpt = bands.NGPT_LW
    band_of_g = torch.as_tensor(bands.BAND_OF_GPT_LW, device=p_lay.device)
    pfrac_g = gas_optics.table(tabs.planck_frac_lw, p_lay)        # (ngpt,)

    tau = gas_optics.gas_tau("lw", p_lay, t_lay, dp_lay, qv)      # (ngpt,nz,ncol)
    if cldfra is not None:
        cf = torch.clamp(cldfra, 0.0, 1.0)
        mask = mcica.mcica_mask(cf, ngpt, mcica_seed)
        lwp_ic = lwp / torch.clamp(cf, min=mcica.CF_MIN)
        tau = tau + (ABS_LIQ * lwp_ic)[None] * mask
    else:
        tau = tau + (ABS_LIQ * lwp)[None]
    if tau_aer_lw is not None:
        tau = tau + tau_aer_lw[band_of_g]

    trans = torch.exp(-DIFFUSIVITY * tau)

    # layer emission flux per g-point: sigma T^4 * band fraction * g weight
    bfrac_lay = band_planck_fractions(t_lay)                     # (nband,nz,ncol)
    b_lay = c.STBOLT * t_lay ** 4                                 # (nz,ncol)
    src = b_lay[None] * bfrac_lay[band_of_g] * pfrac_g.reshape(-1, 1, 1)
    nz = p_lay.shape[0]

    # downward recursion from the TOA (layer nz-1 is the top layer):
    # fd[k] is the downward flux at the bottom face of layer k
    fd = [None] * nz
    carry = torch.zeros_like(src[:, 0])
    for k in range(nz - 1, -1, -1):
        tr, s = trans[:, k], src[:, k]
        carry = carry * tr + s * (1.0 - tr)
        fd[k] = carry
    fd_sfc = fd[0]

    # upward recursion from the surface: fu[k] at the top face of layer k
    bfrac_s = band_planck_fractions(t_sfc)                       # (nband, ncol)
    src_sfc = (c.STBOLT * t_sfc ** 4)[None] * bfrac_s[band_of_g] \
        * pfrac_g.reshape(-1, 1)
    fu_sfc = emissivity * src_sfc + (1.0 - emissivity) * fd_sfc
    fu = [fu_sfc]
    carry = fu_sfc
    for k in range(nz):
        tr, s = trans[:, k], src[:, k]
        carry = carry * tr + s * (1.0 - tr)
        fu.append(carry)

    # face fluxes (faces k = 0..nz), summed over g-points
    fd_tot = torch.sum(torch.stack(fd + [torch.zeros_like(fd_sfc)]), dim=1)  # (nz+1, ncol)
    fu_tot = torch.sum(torch.stack(fu), dim=1)

    fnet = fu_tot - fd_tot
    # heating: layer k gains (Fnet[k] - Fnet[k+1]) over dp
    hr = (fnet[:-1] - fnet[1:]) * c.G / (c.CP * dp_lay)           # K/s
    return {"flux_up": fu_tot, "flux_dn": fd_tot, "heating": hr,
            "olr": fu_tot[-1], "glw": fd_tot[0]}
