"""RRTMG spectral band structure (a numpy copy of the JAX package's
`physics/radiation/bands.py`; canonical: the band/g-point dimensions of
phys/module_ra_rrtmg_lw.F (16 bands / 140 g-points) and
module_ra_rrtmg_sw.F (14 bands / 112 g-points)).

Band edges are the published RRTMG wavenumber boundaries [cm-1].
"""

from __future__ import annotations

import numpy as np

# --- Longwave: 16 bands, 140 g-points ---
NBND_LW = 16
# wavenumber band limits [cm-1] (17 edges)
WAVENUM_LW = np.array([
    10., 350., 500., 630., 700., 820., 980., 1080., 1180., 1390.,
    1480., 1800., 2080., 2250., 2390., 2600., 3250.])
# g-points per LW band (sums to 140)
NG_LW = np.array([10, 12, 16, 14, 14, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 4])
NGPT_LW = int(NG_LW.sum())

# --- Shortwave: 14 bands, 112 g-points ---
NBND_SW = 14
WAVENUM_SW = np.array([
    2600., 3250., 4000., 4650., 5150., 6150., 7700., 8050., 12850.,
    16000., 22650., 29000., 38000., 50000., 820.])
# band 14 (820-2600) wraps the near-IR tail; keep reference ordering
NG_SW = np.array([6, 12, 8, 8, 10, 10, 2, 10, 8, 6, 6, 8, 6, 12])
NGPT_SW = int(NG_SW.sum())

# offset of each band's first g-point
GPT_OFFSET_LW = np.concatenate([[0], np.cumsum(NG_LW)[:-1]])
GPT_OFFSET_SW = np.concatenate([[0], np.cumsum(NG_SW)[:-1]])

# map g-point -> band index
BAND_OF_GPT_LW = np.repeat(np.arange(NBND_LW), NG_LW)
BAND_OF_GPT_SW = np.repeat(np.arange(NBND_SW), NG_SW)


def band_centers_lw_um() -> np.ndarray:
    """LW band-center wavelengths [um] for aerosol optics."""
    wn = 0.5 * (WAVENUM_LW[:-1] + WAVENUM_LW[1:])
    return 1.0e4 / wn


def band_centers_sw_um() -> np.ndarray:
    edges = np.array(WAVENUM_SW)
    lo = edges[:-1].copy()
    hi = np.roll(edges, -1)[:-1]
    # band 14 spans 820-2600
    lo[-1], hi[-1] = 820.0, 2600.0
    wn = 0.5 * (lo + hi)
    return 1.0e4 / wn
