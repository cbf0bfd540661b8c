"""Gas optical depths from the k-distribution tables (port of the JAX
package's `physics/radiation/gas_optics.py`; canonical: rrtmg setcoef +
taumol/taumol_sw).

Every (g-point, layer, column) gets its tau by a bilinear (ln p, T)
interpolation of the tables: four gathers from the small (ngpt, n_tref,
n_pref) table of each species, indexed by (layer, column) tensors.

Shapes: layer fields (nz, ncol); spectral outputs (ngpt, nz, ncol).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.physics.radiation import ktables
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

# well-mixed greenhouse gas volume mixing ratios
CO2_VMR = 400e-6
CH4_VMR = 1.8e-6
N2O_VMR = 0.32e-6
O2_VMR = 0.209

_M_AIR = 28.966
_MW = {"h2o": 18.015, "co2": 44.01, "o3": 48.0, "ch4": 16.04,
       "n2o": 44.013, "o2": 32.0}


def o3_mass_mixing_ratio(p: torch.Tensor) -> torch.Tensor:
    """Standard-atmosphere ozone profile: mass mixing ratio peaking
    ~1.6e-5 kg/kg near 10 hPa (synthetic climatology)."""
    lp = torch.log(torch.clamp(p, min=1.0) / 1000.0)   # log(p/10hPa)
    return 1.6e-5 * torch.exp(-0.5 * (lp / 1.2) ** 2) + 3e-8


def species_mass_mix(qv: torch.Tensor, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mass mixing ratios [kg/kg] of the table species."""
    def to_mass(vmr, mw):
        return vmr * mw / _M_AIR
    ones = torch.ones_like(p)
    return {
        "h2o": qv,
        "co2": to_mass(CO2_VMR, _MW["co2"]) * ones,
        "o3": o3_mass_mixing_ratio(p),
        "ch4": to_mass(CH4_VMR, _MW["ch4"]) * ones,
        "n2o": to_mass(N2O_VMR, _MW["n2o"]) * ones,
        "o2": to_mass(O2_VMR, _MW["o2"]) * ones,
    }


def _interp_weights(p: torch.Tensor, t: torch.Tensor):
    """Bilinear (ln p, T) indices and weights into the reference grid
    (uniform in both axes, so arithmetic rather than a search)."""
    lnp = torch.log(torch.clamp(p, ktables.P_REF_MIN, ktables.P_REF_MAX))
    dp = float(ktables.LNP_REF[1] - ktables.LNP_REF[0])
    fp = (lnp - float(ktables.LNP_REF[0])) / dp
    jp = torch.clamp(torch.floor(fp).to(torch.int32), 0, ktables.N_PREF - 2)
    wp = torch.clamp(fp - jp, 0.0, 1.0)

    t_ref = ktables.T_REF
    dt_ = float(t_ref[1] - t_ref[0])
    ft = (torch.clamp(t, float(t_ref[0]), float(t_ref[-1])) - float(t_ref[0])) / dt_
    jt = torch.clamp(torch.floor(ft).to(torch.int32), 0, ktables.N_TREF - 2)
    wt = torch.clamp(ft - jt, 0.0, 1.0)
    return jp.long(), wp, jt.long(), wt


def _interp_table(ktab: torch.Tensor, jp, wp, jt, wt) -> torch.Tensor:
    """ktab (ngpt, n_tref, n_pref); jp/wp/jt/wt (nz, ncol) ->
    (ngpt, nz, ncol)."""
    k00 = ktab[:, jt, jp]
    k01 = ktab[:, jt, jp + 1]
    k10 = ktab[:, jt + 1, jp]
    k11 = ktab[:, jt + 1, jp + 1]
    return ((1 - wt) * ((1 - wp) * k00 + wp * k01)
            + wt * ((1 - wp) * k10 + wp * k11))


def spectral_sum(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Sum of `x` over its band or g-point axis `dim`, reduced as the
    innermost axis.  A library sum over an outer axis orders its additions
    by the width of the axes behind it, so a chunk of columns would round
    apart from the whole; over the innermost axis each column's sum is the
    same at any number of columns (`driver.COL_CHUNK`)."""
    out = torch.movedim(x, dim, -1).contiguous().sum(dim=-1)
    return out.unsqueeze(dim) if keepdim else out


def table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host float64 table as a tensor of `like`'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=like.dtype).to(like.device)


def gas_tau(kind: str, p_lay: torch.Tensor, t_lay: torch.Tensor,
            dp_lay: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Gas absorption optical depth per g-point.

    kind: 'lw' or 'sw'.  p_lay/t_lay/dp_lay/qv: (nz, ncol); dp_lay is the
    layer pressure thickness [Pa] (positive).  Returns (ngpt, nz, ncol).
    """
    tabs = ktables.load_tables()
    kmajor = tabs.kmajor_lw if kind == "lw" else tabs.kmajor_sw
    jp, wp, jt, wt = _interp_weights(p_lay, t_lay)
    air_path = dp_lay / c.G                      # kg air / m2
    mmr = species_mass_mix(qv, p_lay)
    tau = None
    for sp, ktab in kmajor.items():
        k = _interp_table(table(ktab, p_lay), jp, wp, jt, wt)
        contrib = k * (mmr[sp] * air_path)[None]
        tau = contrib if tau is None else tau + contrib
    return tau


def rayleigh_tau(dp_lay: torch.Tensor) -> torch.Tensor:
    """(ngpt_sw, nz, ncol) Rayleigh scattering optical depth."""
    tabs = ktables.load_tables()
    ray = table(tabs.rayleigh_sw, dp_lay).reshape(-1, 1, 1)
    return ray * (dp_lay / c.G)[None]
