"""Grell-style ensemble mass-flux cumulus (port of the JAX package's
`physics/cumulus_grell.py`; canonical phys/module_cu_g3.F / module_cu_gd.F,
Grell & Devenyi 2002).

Six members of the KF-style entraining plume (`cumulus_kf.kf_mass_flux`)
over entrainment rates {3e-5, 5e-5, 8e-5} 1/m and CAPE-removal times
{1800, 3600} s, and their unweighted mean.  The reference evaluates the
members in one vmap; here they run one after another, in its member order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.physics.cumulus_kf import kf_mass_flux

EPS_MEMBERS = (3.0e-5, 5.0e-5, 8.0e-5)
TAU_MEMBERS = (1800.0, 3600.0)


def grell_ensemble(theta: torch.Tensor, qv: torch.Tensor, p: torch.Tensor,
                   rho: torch.Tensor, dz: torch.Tensor, dt: float
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Ensemble-mean ({"th", "qv"} tendencies, precip rate)."""
    dth, dqv, rain = [], [], []
    for eps in EPS_MEMBERS:
        for tau in TAU_MEMBERS:
            tend, r = kf_mass_flux(theta, qv, p, rho, dz, dt, eps_ent=eps, tau_cape=tau)
            dth.append(tend["th"])
            dqv.append(tend["qv"])
            rain.append(r)
    return ({"th": torch.stack(dth).mean(dim=0), "qv": torch.stack(dqv).mean(dim=0)},
            torch.stack(rain).mean(dim=0))
