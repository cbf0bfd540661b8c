"""Correlated-k distribution tables for the RRTMG-structured radiation (a
numpy copy of the JAX package's `physics/radiation/ktables.py`; canonical:
the k-distribution DATA modules of phys/module_ra_rrtmg_lw.F /
module_ra_rrtmg_sw.F).

The tables are synthetic but structurally faithful: RRTMG's (pressure-level
x temperature x g-point) layout, lookup and interpolation, with
coefficients generated from documented band-mean absorption strengths and
a log-spaced g-point distribution k(g) = k_min (k_max/k_min)^(g^gamma).
They are built here in float64 exactly as the reference builds them, so the
two packages hold bit-identical tables (tests/test_torch_radiation.py).

Table layout: kmajor[species] is (ngpt, n_tref, n_pref), absorption per
unit species path at the reference (ln p, T) grid, interpolated bilinearly
at run time (`gas_optics`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands
from wrfchem_arc_interactions_tpu_torch.utils.constants import SOLAR_CONSTANT

N_PREF = 59       # reference pressure levels (RRTMG layout)
N_TREF = 5        # reference temperatures
P_REF_MAX = 1.1e5
P_REF_MIN = 1.0
T_REF = np.array([180.0, 220.0, 260.0, 300.0, 340.0])
LNP_REF = np.linspace(np.log(P_REF_MAX), np.log(P_REF_MIN), N_PREF)

# Band-mean mass absorption strengths [m2/kg of absorber] by (species, band)
# — synthetic values calibrated against clear-sky anchors, not AER data.
_LW_STRENGTH = {
    "h2o": [100., 60., 16., 8., 6., 12., 3., 4., 16., 4., 12., 20., 40., 80., 120., 60.],
    "co2": [0.02, 0.05, 4., 8., 1.0, 0.05, 0.1, 0.05, 0.2, 0.4, 0.05, 0.1, 0.8, 1.2, 0.4, 0.1],
    "o3":  [0., 0., 0., 0.05, 0.1, 0.3, 8., 0.5, 0.2, 0.1, 0.05, 0., 0., 0., 0., 0.2],
    "ch4": [0., 0., 0., 0., 0., 0.3, 0.4, 1.2, 0.1, 0., 0., 0.3, 0.2, 0., 0., 0.],
    "n2o": [0., 0.1, 0.3, 0.2, 0., 0.1, 0.5, 0.8, 0.2, 0., 0., 0.1, 0., 0., 0., 0.],
}
# SW bands (14, ordered like the reference: 2600-3250 ... 38000-50000, 820-2600)
_SW_STRENGTH = {
    "h2o": [0.4, 0.24, 0.16, 0.3, 0.1, 0.03, 0.01, 0.004, 0.0008, 0., 0., 0., 0., 0.6],
    "co2": [0.4, 0.1, 0.3, 0.05, 0.15, 0.01, 0., 0., 0., 0., 0., 0., 0., 0.2],
    "o3":  [0., 0., 0., 0., 0., 0., 0., 0., 0.01, 0.06, 0.5, 6.0, 30.0, 0.],
    "o2":  [0., 0., 0., 0., 0., 0.004, 0.01, 0., 0.003, 0., 0., 0., 0.05, 0.],
    "ch4": [0.3, 0.2, 0., 0.1, 0., 0., 0., 0., 0., 0., 0., 0., 0., 0.1],
}
_GSPREAD = 2.5    # orders of magnitude spread of k over g-points
_GGAMMA = 2.2     # shape of k(g); larger -> fewer strong g-points


@dataclasses.dataclass(frozen=True)
class KTables:
    """Table arrays (numpy float64; cast to tensors at the use site)."""
    kmajor_lw: dict              # species -> (ngpt_lw, n_tref, n_pref)
    kmajor_sw: dict              # species -> (ngpt_sw, n_tref, n_pref)
    planck_frac_lw: np.ndarray   # (ngpt_lw,) within-band Planck weight
    solar_src_sw: np.ndarray     # (ngpt_sw,) TOA solar irradiance per g-point
    rayleigh_sw: np.ndarray      # (ngpt_sw,) rayleigh scattering [m2/kg air]


def _g_distribution(ng: int) -> np.ndarray:
    """Relative k multiplier over the g-points of one band (log spread)."""
    g = (np.arange(ng) + 0.5) / ng
    return 10.0 ** (_GSPREAD * (g ** _GGAMMA - 0.5))


def _pt_scaling() -> np.ndarray:
    """(n_tref, n_pref) pressure-broadening x temperature scaling."""
    p = np.exp(LNP_REF)[None, :]
    t = T_REF[:, None]
    return (p / 1.0e5) ** 0.75 * (296.0 / t) ** 0.5


def _species_tables(strength_by_band, ng_per_band) -> dict:
    scale = _pt_scaling()
    out = {}
    for sp, strengths in strength_by_band.items():
        cols = []
        for b, s in enumerate(strengths):
            gdist = _g_distribution(ng_per_band[b])
            cols.append(s * gdist)
        kg = np.concatenate(cols)                      # (ngpt,)
        out[sp] = kg[:, None, None] * scale[None, :, :]
    return out


def _planck_fraction(ng_per_band) -> np.ndarray:
    """Within-band Planck weights per g-point (sum to 1 per band)."""
    return np.concatenate([np.full(ng, 1.0 / ng) for ng in ng_per_band])


def _solar_source() -> np.ndarray:
    """TOA solar irradiance per SW g-point [W/m2], summing to the solar
    constant, partitioned by a Planck-5777K weighting over bands."""
    centers = bands.band_centers_sw_um()
    lam = centers * 1e-6
    # Planck radiance at 5777 K (unnormalised)
    h, c, kb, T = 6.626e-34, 3.0e8, 1.381e-23, 5777.0
    b = 1.0 / (lam ** 5 * (np.exp(h * c / (lam * kb * T)) - 1.0))
    # band widths in wavelength
    edges = np.asarray(bands.WAVENUM_SW)
    lo = edges[:-1].copy()
    hi = np.roll(edges, -1)[:-1]
    lo[-1], hi[-1] = 820.0, 2600.0
    dlam = np.abs(1e4 / lo - 1e4 / hi) * 1e-6
    band_w = b * dlam
    band_w = band_w / band_w.sum() * SOLAR_CONSTANT
    return np.concatenate([np.full(ng, band_w[bnd] / ng)
                           for bnd, ng in enumerate(bands.NG_SW)])


def _rayleigh() -> np.ndarray:
    """Rayleigh mass scattering coefficient per SW g-point [m2/kg]."""
    centers = bands.band_centers_sw_um()
    # sigma ~ 4.6e-31 m2/molec at 550nm, lambda^-4; per kg air
    sig = 4.6e-31 * (0.55 / centers) ** 4
    per_kg = sig * 6.022e23 / 28.96e-3
    return np.concatenate([np.full(ng, per_kg[bnd])
                           for bnd, ng in enumerate(bands.NG_SW)])


@functools.lru_cache(maxsize=1)
def load_tables() -> KTables:
    return KTables(
        kmajor_lw=_species_tables(_LW_STRENGTH, bands.NG_LW),
        kmajor_sw=_species_tables(_SW_STRENGTH, bands.NG_SW),
        planck_frac_lw=_planck_fraction(bands.NG_LW),
        solar_src_sw=_solar_source(),
        rayleigh_sw=_rayleigh(),
    )
