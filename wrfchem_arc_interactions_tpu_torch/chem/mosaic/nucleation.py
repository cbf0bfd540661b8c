"""Binary H2SO4-H2O new-particle formation (port of the JAX package's
`chem/mosaic/nucleation.py`; canonical: chem/module_mosaic_newnuc.F,
Wexler/Vehkamaki-style).

Power-law parameterisation of the nucleation rate (a documented stand-in
for the Vehkamaki 2002 fit, which needs its published coefficient tables):
J = J0 (C/C0)^2 at RH-dependent efficiency, capped by available H2SO4.
New particles enter bin 1 at the bin's lower-edge diameter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as mbins
from wrfchem_arc_interactions_tpu_torch.chem.mosaic.thermo import ppmv_to_ugkg, ugkg_to_ppmv

J0 = 1.0e6           # [#/m3/s] at C0
C0_PPMV = 5.0e-6     # ~1.2e8 molec/cm3


def nucleate(chem: Dict[str, torch.Tensor], rho_air, rh, nbin: int,
             dt: float) -> Dict[str, torch.Tensor]:
    out = dict(chem)
    h2so4 = chem["chem_h2so4"]
    rh_fac = torch.clamp((rh - 0.1) / 0.6, 0.0, 1.0)
    j_rate = J0 * (h2so4 / C0_PPMV) ** 2 * rh_fac          # #/m3/s
    d_nuc = mbins.make_bins(nbin).d_lo[0]
    m_p = mbins.DENSITY["so4"] * np.pi / 6.0 * d_nuc ** 3  # kg/particle
    dnum_kg = j_rate * dt / rho_air                         # #/kg
    dso4_ug = dnum_kg * m_p * 1e9                           # ug/kg
    # cap by available gas
    avail_ug = ppmv_to_ugkg(h2so4, mbins.MW["so4"])
    scale = torch.where(dso4_ug > 0,
                      torch.clamp(0.5 * avail_ug / torch.clamp(dso4_ug, min=1e-30), max=1.0),
                      0.0)
    dnum_kg = dnum_kg * scale
    dso4_ug = dso4_ug * scale
    out["chem_num_a01"] = chem["chem_num_a01"] + dnum_kg
    out["chem_so4_a01"] = chem["chem_so4_a01"] + dso4_ug
    out["chem_h2so4"] = torch.clamp(h2so4 - ugkg_to_ppmv(dso4_ug, mbins.MW["so4"]), min=0.0)
    return out
