"""Cheap broadband radiation (port of the JAX package's
`physics/radiation/simple.py`; canonical the Dudhia SW of
phys/module_ra_sw.F and an emissivity-method gray LW).

ra_*_physics = simple: one band each way.  SW: the downward beam depleted
by water-vapour absorption (the sqrt-path Dudhia curve) and by cloud albedo
and absorption, no multiple scattering.  LW: broadband water-vapour
emissivity with cloud as a near-black emitter, integrated down from the top
and up from the surface (Python loops over z).  Columns are (nz, ncol).
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.reference.wrf.utils import constants as c


def sw_simple(p_lay, t_lay, dp_lay, qv, lwp, mu0, albedo) -> Dict[str, torch.Tensor]:
    mu = torch.clamp(mu0, min=1e-3)[None]
    s0 = c.SOLAR_CONSTANT * torch.clamp(mu0, min=0.0)
    # water-vapour and condensate paths from each layer to the top [kg/m2]
    wv = qv * dp_lay / c.G
    wv_above = torch.flip(torch.cumsum(torch.flip(wv, [0]), dim=0), [0]) / mu
    absorb = 0.077 * torch.clamp(wv_above, min=1e-6) ** 0.3
    lwp_above = torch.flip(torch.cumsum(torch.flip(lwp, [0]), dim=0), [0]) / mu
    tau_c = 0.15e3 * lwp_above
    cld_alb = tau_c / (6.7 + tau_c)
    cld_abs = 0.04 * tau_c / (1.0 + 0.04 * tau_c) * 0.2
    trans = torch.clamp(1.0 - absorb - cld_alb - cld_abs, 0.0, 1.0)
    # fluxes at the faces k = 0..nz
    fdn = torch.cat([s0[None] * trans, s0[None]], dim=0)
    fup = albedo[None] * fdn[0][None] * torch.ones_like(fdn)
    fnet = fdn - fup
    hr = (fnet[1:] - fnet[:-1]) * c.G / (c.CP * dp_lay)
    night = (mu0 <= 0.0)[None]
    fdn = torch.where(night, 0.0, fdn)
    hr = torch.where(night, 0.0, hr)
    return {"flux_dn": fdn, "flux_up": torch.where(night, 0.0, fup),
            "heating": hr, "swdown": fdn[0],
            "swup_toa": torch.where(night[0], 0.0, fup[-1])}


def lw_simple(p_lay, t_lay, dp_lay, qv, lwp, t_sfc,
              emissivity_sfc: float = 0.98) -> Dict[str, torch.Tensor]:
    nz = p_lay.shape[0]
    wv = qv * dp_lay / c.G
    sig_t4 = c.STBOLT * t_lay ** 4
    # layer emissivity: vapour + cloud (near-black above ~0.05 kg/m2 of LWP)
    eps_lay = torch.clamp(1.0 - torch.exp(-1.66 * (0.1 * wv ** 0.5 + 60.0 * lwp)), 1e-4, 1.0)
    fd_k = torch.zeros_like(sig_t4[0])
    fd_below = [None] * nz
    for k in range(nz - 1, -1, -1):
        fd_k = fd_k * (1.0 - eps_lay[k]) + eps_lay[k] * sig_t4[k]
        fd_below[k] = fd_k
    fd = torch.stack(fd_below + [torch.zeros_like(sig_t4[0])])
    fu_sfc = emissivity_sfc * c.STBOLT * t_sfc ** 4 + (1 - emissivity_sfc) * fd[0]
    fu = [fu_sfc]
    for k in range(nz):
        fu.append(fu[-1] * (1.0 - eps_lay[k]) + eps_lay[k] * sig_t4[k])
    fu = torch.stack(fu)
    fnet = fu - fd
    hr = (fnet[:-1] - fnet[1:]) * c.G / (c.CP * dp_lay)
    return {"flux_up": fu, "flux_dn": fd, "heating": hr,
            "olr": fu[-1], "glw": fd[0]}
