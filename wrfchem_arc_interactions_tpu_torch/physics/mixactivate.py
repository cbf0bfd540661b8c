"""Aerosol activation: Abdul-Razzak & Ghan (2000) sectional scheme —
the aerosol-cloud (ARC indirect effect) coupling point (port of the JAX
package's `physics/mixactivate.py`; canonical: phys/module_mixactivate.F).

Converts the MOSAIC size-distributed aerosol + updraft speed into an
activated cloud-droplet number concentration, which sources Morrison's
prognostic Nc.  kappa-Kohler critical supersaturations per bin; AR&G
maximum-supersaturation closure; within-bin activated fraction assuming a
uniform d(ln r) sub-distribution across each section.

Fully cell-local dense math, batched over the grid.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as mbins
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

SIGMA_W = 0.0728        # surface tension of water [N/m]
MW_W = 18.015e-3        # [kg/mol]
R_GAS = 8.314
D_V = 2.5e-5            # vapor diffusivity [m2/s]
K_AIR = 2.5e-2          # thermal conductivity [W/m/K]
# effective ln(sigma_g) of the within-bin distribution for the AR&G mode
# factors (a section behaves like a narrow mode)
LNSIG_BIN = 0.4


def _kelvin_a(t_air):
    """Kelvin coefficient A [m]: 2 sigma Mw / (R T rho_w)."""
    return 2.0 * SIGMA_W * MW_W / (R_GAS * t_air * c.RHOWATER)


def bin_properties(chem: Dict[str, torch.Tensor], nbin: int):
    """Per-bin (number #/kg, dry volume m3/kg, kappa_mix, dry radius m)."""
    out = []
    for b in range(1, nbin + 1):
        v_dry = None
        v_kappa = None
        for s in mbins.AER_SPECIES:
            v = chem[f"chem_{s}_a{b:02d}"] * 1e-9 / mbins.DENSITY[s]
            v_dry = v if v_dry is None else v_dry + v
            kv = mbins.KAPPA[s] * v
            v_kappa = kv if v_kappa is None else v_kappa + kv
        num = torch.clamp(chem[f"chem_num_a{b:02d}"], min=1e-3)
        v_dry = torch.clamp(v_dry, min=1e-30)
        kappa = torch.clamp(v_kappa / v_dry, 1e-6, 1.5)
        r_dry = 0.5 * torch.clamp((6.0 * v_dry / (np.pi * num)) ** (1.0 / 3.0),
                               2e-9, 20e-6)
        out.append((num, v_dry, kappa, r_dry))
    return out


def activate(chem: Dict[str, torch.Tensor], t_air, p_air, rho_air, w_up,
             nbin: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (n_act [#/kg air], smax) — activated number at cloud base for
    updraft w_up (same shape as t_air)."""
    n_act, smax, _ = activate_fractions(chem, t_air, p_air, rho_air, w_up,
                                        nbin)
    return n_act, smax


def activate_fractions(chem: Dict[str, torch.Tensor], t_air, p_air, rho_air,
                       w_up, nbin: int):
    """AR&G activation with the per-bin activated fractions exposed.

    Returns (n_act [#/kg air], smax, fracs) where fracs is the list of
    per-bin activated number fractions (0..1) used by the cloud-borne
    aerosol bookkeeping (canonical: module_mixactivate.F fn/fm per-bin
    activated fractions feeding the _cw phase)."""
    a_kelvin = _kelvin_a(t_air)
    es = 611.2 * torch.exp(c.SVP2 * (t_air - c.SVPT0) / (t_air - c.SVP3))
    qs = c.EP_2 * es / torch.clamp(p_air - es, min=1.0)
    # AR&G alpha and gamma coefficients
    lv = c.XLV
    alpha = c.G * MW_W * lv / (c.CP * R_GAS * t_air ** 2) \
        - c.G * c.MW_AIR / (R_GAS * t_air)
    gamma = R_GAS * t_air / (es * MW_W) \
        + MW_W * lv ** 2 / (c.CP * c.MW_AIR * t_air * p_air)
    # droplet growth coefficient G
    g_coef = 1.0 / (c.RHOWATER * R_GAS * t_air / (es * D_V * MW_W)
                    + lv * c.RHOWATER / (K_AIR * t_air)
                    * (lv * MW_W / (R_GAS * t_air) - 1.0))

    w = torch.clamp(w_up, min=0.1)
    zeta = (2.0 * a_kelvin / 3.0) * torch.sqrt(alpha * w / g_coef)
    f1 = 0.5 * float(np.exp(2.5 * LNSIG_BIN ** 2))
    f2 = 1.0 + 0.25 * LNSIG_BIN

    props = bin_properties(chem, nbin)
    inv_smax2 = 0.0
    sm_list = []
    for num, v_dry, kappa, r_dry in props:
        sm = torch.sqrt(4.0 * a_kelvin ** 3 / (27.0 * kappa * r_dry ** 3))
        sm = torch.clamp(sm, 1e-6, 1.0)
        sm_list.append(sm)
        n_m3 = num * rho_air
        eta = (alpha * w / g_coef) ** 1.5 / (
            2.0 * np.pi * c.RHOWATER * gamma * torch.clamp(n_m3, min=1.0))
        term = (f1 * (zeta / eta) ** 1.5
                + f2 * (sm ** 2 / (eta + 3.0 * zeta)) ** 0.75)
        inv_smax2 = inv_smax2 + term / (sm * sm)
    smax = 1.0 / torch.sqrt(torch.clamp(inv_smax2, min=1e-12))
    smax = torch.clamp(smax, 1e-5, 0.1)

    grid_b = mbins.make_bins(nbin)
    ln_width = np.log(grid_b.d_hi[0] / grid_b.d_lo[0])
    n_act = 0.0
    fracs = []
    for (num, v_dry, kappa, r_dry), sm in zip(props, sm_list):
        # critical dry radius at smax
        r_c = (4.0 * a_kelvin ** 3 / (27.0 * kappa * smax ** 2)) ** (1.0 / 3.0)
        # fraction of the bin (uniform in ln r, half-width ln_width/2 around
        # the bin mean radius) with r_dry > r_c
        frac = 0.5 + (torch.log(torch.clamp(r_dry, min=1e-10))
                      - torch.log(torch.clamp(r_c, min=1e-10))) / ln_width
        frac = torch.clamp(frac, 0.0, 1.0)
        fracs.append(frac)
        n_act = n_act + frac * num
    return n_act, smax, fracs
