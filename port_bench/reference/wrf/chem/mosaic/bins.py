"""MOSAIC sectional bin structure and species properties (a numpy copy of
the part of the JAX package's `chem/mosaic/bins.py` that aerosol optics and
dry deposition read; canonical: chem/module_data_mosaic_asect.F).

Logarithmically spaced dry-diameter bins over 39 nm - 10 um, per-species
density, molecular weight and hygroscopicity, and per-band complex
refractive indices (OPAC-like literature values).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# species order used throughout chem arrays
AER_SPECIES: Tuple[str, ...] = ("so4", "no3", "nh4", "cl", "na", "oin", "bc", "oc")

DENSITY = {  # kg/m3
    "so4": 1770.0, "no3": 1725.0, "nh4": 1769.0, "cl": 2165.0, "na": 2165.0,
    "oin": 2600.0, "bc": 1800.0, "oc": 1400.0, "water": 1000.0,
}
MW = {  # g/mol
    "so4": 96.06, "no3": 62.0, "nh4": 18.04, "cl": 35.45, "na": 23.0,
    "oin": 100.0, "bc": 12.0, "oc": 180.0, "water": 18.0,
}
KAPPA = {  # hygroscopicity parameter (Petters & Kreidenweis)
    "so4": 0.65, "no3": 0.67, "nh4": 0.65, "cl": 1.1, "na": 1.1,
    "oin": 0.03, "bc": 1e-6, "oc": 0.1,
}
# (n_r, n_i) at visible (550 nm) and a thermal-IR (10 um) anchor; per-band
# values are interpolated between the anchors by wavelength regime.
REFRACTIVE_VIS = {
    "so4": (1.52, 1e-7), "no3": (1.50, 2e-7), "nh4": (1.52, 1e-7),
    "cl": (1.55, 1e-8), "na": (1.55, 1e-8), "oin": (1.55, 3e-3),
    "bc": (1.82, 0.74), "oc": (1.45, 0.006), "water": (1.33, 1e-8),
}
REFRACTIVE_IR = {
    "so4": (1.75, 0.15), "no3": (1.60, 0.12), "nh4": (1.70, 0.15),
    "cl": (1.50, 0.02), "na": (1.50, 0.02), "oin": (1.70, 0.30),
    "bc": (2.00, 0.80), "oc": (1.60, 0.10), "water": (1.32, 0.05),
}


@dataclasses.dataclass(frozen=True)
class BinGrid:
    nbin: int
    d_lo: np.ndarray     # (nbin,) lower dry diameters [m]
    d_hi: np.ndarray
    d_center: np.ndarray  # geometric mean diameter [m]

    @property
    def v_center(self):
        return np.pi / 6.0 * self.d_center ** 3


def make_bins(nbin: int = 4, d_min: float = 39e-9, d_max: float = 10e-6) -> BinGrid:
    edges = np.logspace(np.log10(d_min), np.log10(d_max), nbin + 1)
    return BinGrid(nbin=nbin, d_lo=edges[:-1], d_hi=edges[1:],
                   d_center=np.sqrt(edges[:-1] * edges[1:]))


def species_arrays(bands_um: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-species arrays over a wavelength-band axis: density, kappa,
    (nr, ni) per band.  bands_um: (nband,) centre wavelengths."""
    names = list(AER_SPECIES) + ["water"]
    n = len(names)
    nb = len(bands_um)
    dens = np.array([DENSITY[s] for s in names])
    kappa = np.array([KAPPA.get(s, 0.0) for s in names])
    # wavelength blend: visible anchor below 2 um, IR anchor above 4 um,
    # linear in between
    w_ir = np.clip((bands_um - 2.0) / 2.0, 0.0, 1.0)
    nr = np.zeros((n, nb))
    ni = np.zeros((n, nb))
    for i, s in enumerate(names):
        nr_v, ni_v = REFRACTIVE_VIS[s]
        nr_i, ni_i = REFRACTIVE_IR[s]
        nr[i] = nr_v * (1 - w_ir) + nr_i * w_ir
        ni[i] = np.exp(np.log(max(ni_v, 1e-9)) * (1 - w_ir)
                       + np.log(max(ni_i, 1e-9)) * w_ir)
    return {"names": names, "density": dens, "kappa": kappa, "nr": nr, "ni": ni}
