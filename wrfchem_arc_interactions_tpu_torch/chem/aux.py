"""Dry deposition and the gray photolysis profile (port of
`dry_deposition`, `deposition_velocities` and `photolysis_profile` from the
JAX package's `chem/aux.py`; canonical: chem/dry_dep_driver.F,
module_aer_drydep.F, module_phot_fastj.F).

Dry deposition is a first-order sink in the lowest model layer, with
species-class deposition velocities when no friction velocity is available,
or the resistance-in-series velocities when the surface scheme provides
one.  A chem field named after a species of `chem.gas.GAS_SPECIES` is
treated as a gas.  Emissions and plume rise, the cloud-borne phase, cloud
chemistry and wet scavenging are not ported yet (`chem.driver` refuses
them).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from wrfchem_arc_interactions_tpu_torch.chem.gas import GAS_SPECIES  # noqa: F401
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as mbins

# fallback deposition velocities [m/s] by species class (used when no
# friction velocity is available)
VDEP = {"o3": 0.004, "hno3": 0.02, "so2": 0.008, "nh3": 0.01, "h2o2": 0.01,
        "no2": 0.002, "pan": 0.002, "hcho": 0.005, "default_gas": 0.002,
        "aerosol": 0.002}

# Wesely (1989) bulk surface (canopy) resistances [s/m]
RC_WESELY = {"o3": 100.0, "so2": 130.0, "hno3": 1.0, "nh3": 80.0,
             "h2o2": 50.0, "no2": 300.0, "no": 3000.0, "pan": 500.0,
             "hcho": 150.0, "co": 1.0e5, "ald2": 300.0, "hono": 50.0,
             "n2o5": 1.0, "hno4": 10.0, "ch3ooh": 200.0, "rooh": 200.0,
             "default_gas": 400.0}
KARMAN = 0.4
Z0_DEP = 0.1           # roughness length [m] (land)


def deposition_velocities(ust, z1, bin_diam_m):
    """Resistance-in-series deposition velocities.

    Gases: vd = 1/(ra + rb + rc) with aerodynamic ra = ln(z1/z0)/(k u*),
    quasi-laminar rb ~ 5/u*, Wesely rc per species.  Aerosol (Slinn):
    vd = vg + 1/(ra + rs + ra rs vg) with gravitational settling vg(D) and
    surface resistance rs = 1/(u*(Sc^-2/3 + 10^(-3/St))).

    Returns ({species: vd_gas (ny,nx)}, [vd_aer per bin]).
    """
    ust = torch.clamp(ust, min=0.05)
    ra = torch.log(torch.clamp(z1, min=2.0 * Z0_DEP) / Z0_DEP) / (KARMAN * ust)
    rb = 5.0 / ust
    vd_gas = {s: 1.0 / (ra + rb + rc) for s, rc in RC_WESELY.items()}

    vd_aer = []
    mu_air = 1.8e-5
    for d in bin_diam_m:
        # Cunningham slip correction (host float64, as in the reference)
        d = float(d)
        kn = 2.0 * 6.5e-8 / d
        cc = 1.0 + kn * (1.257 + 0.4 * math.exp(-1.1 / kn))
        vg = 1500.0 * d ** 2 * 9.81 * cc / (18.0 * mu_air)
        # Brownian Schmidt number + impaction Stokes number
        diff = 1.38e-23 * 293.0 * cc / (3.0 * math.pi * mu_air * d)
        sc = mu_air / (1.2 * diff)
        st = vg * ust ** 2 / (9.81 * mu_air / 1.2)
        rs = 1.0 / (ust * (sc ** (-2.0 / 3.0)
                           + 10.0 ** (-3.0 / torch.clamp(st, min=1e-3))))
        vd_aer.append(vg + 1.0 / (ra + rs + ra * rs * vg))
    return vd_gas, vd_aer


def photolysis_profile(mu0, qc, rho, dz, tau_aer_vis=None):
    """3D J-rate scale coupled to the computed optical state (phot_opt=1).

    Per-layer optical depth = cloud (tau = 150 * LWP_layer, i.e. 3/2 LWP /
    (rho_w r_eff) with r_eff = 10 um) + the chem-computed near-UV aerosol
    extinction profile `tau_aer_vis` (a band of tau_aer_sw).  The actinic
    scale at layer k attenuates with the slant overhead optical depth:
    J ~ mu0 * exp(-0.4 tau_above / max(mu0, 0.2)).  Returns (nz, ny, nx)."""
    tau_lay = 150.0 * qc * rho * dz
    if tau_aer_vis is not None:
        tau_lay = tau_lay + tau_aer_vis
    # overhead OD at layer k = sum of the layers above (k indexes upward)
    od_above = torch.flip(torch.cumsum(torch.flip(tau_lay, (0,)), dim=0), (0,)) - tau_lay
    slant = torch.clamp(od_above, 0.0, 20.0) / torch.clamp(mu0, min=0.2)[None]
    return torch.clamp(mu0, min=0.0)[None] * torch.exp(-0.4 * slant)


def dry_deposition(chem: Dict[str, torch.Tensor], dz0, dt: float,
                   gas_names, ust=None, nbin: int = 4) -> Dict[str, torch.Tensor]:
    """Dry-deposition sink in the lowest model layer; dz0 (ny, nx).

    With a friction velocity, uses the resistance-in-series velocities
    (deposition_velocities); otherwise the fallback class table."""
    out = dict(chem)
    vd_gas = vd_aer = None
    if ust is not None:
        diams = mbins.make_bins(nbin).d_center
        vd_gas, vd_aer = deposition_velocities(ust, 0.5 * dz0, diams)
    for name, arr in chem.items():
        short = name.replace("chem_", "")
        if short in gas_names:
            if vd_gas is not None:
                v = vd_gas.get(short, vd_gas["default_gas"])
            else:
                v = VDEP.get(short, VDEP["default_gas"])
        elif "_a" in short:
            if vd_aer is not None:
                b = int(short[-2:]) - 1
                v = vd_aer[min(b, len(vd_aer) - 1)]
            else:
                v = VDEP["aerosol"]
        else:
            continue
        fac = torch.exp(-v * dt / torch.clamp(dz0, min=1.0))
        new = arr.clone()
        new[0] = arr[0] * fac
        out[name] = new
    return out
