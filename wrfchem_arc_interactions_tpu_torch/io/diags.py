"""Pressure-level diagnostics — the auxiliary-history stream (port of the
JAX package's `io/diags.py`).

Host-side post-processing at write time, outside the hot step: geopotential
height, temperature, winds and RH interpolated to standard pressure levels,
and sea-level pressure by the standard T-extrapolation reduction.  The
fields the diagnostics read leave the device in one pass (`history.gather`);
the arithmetic is the reference's, in float64 numpy, line for line.
Written through the history writer (native netCDF or npz) on the
``auxhist_interval_s`` alarm of TimeControl.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.io import netcdf as ncio
from wrfchem_arc_interactions_tpu_torch.io.history import gather
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c

P_LEVELS_DEFAULT = (850e2, 700e2, 500e2, 250e2)

_STATE_FIELDS = ("mu", "t", "ph", "u", "v", "qv")


def _host(state: State, grid: Grid) -> Dict[str, np.ndarray]:
    """The state and grid fields the diagnostics read, on the host."""
    return gather({"mub": grid.mub, "znu": grid.znu, "phb": grid.phb,
                   **{n: state[n] for n in _STATE_FIELDS if n in state}})


def _column_fields(h: Dict[str, np.ndarray], p_top: float):
    mub = np.asarray(h["mub"], np.float64)
    mu = mub + np.asarray(h["mu"], np.float64)
    znu = np.asarray(h["znu"], np.float64)
    p = znu[:, None, None] * mu[None] + p_top
    theta = np.asarray(h["t"], np.float64) + 300.0
    t_air = theta * (p / c.P0) ** c.RCP
    ph = np.asarray(h["phb"], np.float64) + np.asarray(h["ph"], np.float64)
    z_w = ph / c.G
    z = 0.5 * (z_w[:-1] + z_w[1:])
    qv = np.asarray(h.get("qv", np.zeros_like(theta)), np.float64)
    return p, t_air, z, qv, mu


def _interp_p(p: np.ndarray, field: np.ndarray,
              p_levels: Sequence[float]) -> np.ndarray:
    """(nlev, ny, nx) log-p interpolation of a (nz, ny, nx) field; NaN
    below ground and above the top (the missing-value convention)."""
    nz, ny, nx = field.shape
    lnp = np.log(p)
    out = np.full((len(p_levels), ny, nx), np.nan)
    for li, pl in enumerate(p_levels):
        lt = np.log(pl)
        # p decreases with k: find bracketing levels
        below = lnp >= lt                       # levels with higher pressure
        klo = np.clip(below.sum(axis=0) - 1, 0, nz - 2)
        jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        l0 = lnp[klo, jj, ii]
        l1 = lnp[klo + 1, jj, ii]
        f0 = field[klo, jj, ii]
        f1 = field[klo + 1, jj, ii]
        w = (lt - l0) / np.where(np.abs(l1 - l0) > 1e-12, l1 - l0, 1.0)
        val = f0 + w * (f1 - f0)
        inside = (lt <= lnp[0]) & (lt >= lnp[-1])
        out[li] = np.where(inside, val, np.nan)
    return out


def _slp(h: Dict[str, np.ndarray], p_top: float) -> np.ndarray:
    p, t_air, z, qv, mu = _column_fields(h, p_top)
    p_sfc = mu + p_top
    z_sfc = np.asarray(h["phb"], np.float64)[0] / c.G
    t0 = t_air[0] * (1.0 + 0.608 * qv[0]) + 0.0065 * (z[0] - z_sfc)
    t_msl = t0 + 0.0065 * z_sfc
    return p_sfc * np.exp(c.G * z_sfc / (c.R_D * 0.5 * (t0 + t_msl)))


def sea_level_pressure(state: State, grid: Grid, cfg: Config) -> np.ndarray:
    """SLP [Pa] by the standard reduction: surface pressure extrapolated
    down the 6.5 K/km lapse from the lowest-level temperature."""
    return _slp(_host(state, grid), grid.p_top)


def compute_diags(state: State, grid: Grid, cfg: Config,
                  p_levels: Sequence[float] = P_LEVELS_DEFAULT
                  ) -> Dict[str, np.ndarray]:
    h = _host(state, grid)
    p, t_air, z, qv, mu = _column_fields(h, grid.p_top)
    u = np.asarray(h["u"], np.float64)
    v = np.asarray(h["v"], np.float64)
    es = 611.2 * np.exp(c.SVP2 * (t_air - c.SVPT0) / (t_air - c.SVP3))
    qvs = c.EP_2 * es / np.maximum(p - es, 1.0)
    rh = np.clip(qv / np.maximum(qvs, 1e-10), 0.0, 1.1) * 100.0
    out = {
        "slp": _slp(h, grid.p_top).astype(np.float32),
        "p_levels": np.asarray(p_levels, np.float32),
    }
    for name, fld in (("z_pl", z), ("t_pl", t_air), ("u_pl", u),
                      ("v_pl", v), ("rh_pl", rh)):
        out[name] = _interp_p(p, fld, p_levels).astype(np.float32)
    return out


def write_diags(path: str, cfg: Config, grid: Grid, state: State,
                time_s: float,
                p_levels: Sequence[float] = P_LEVELS_DEFAULT) -> None:
    """Write the pressure-level diagnostic stream (auxhist)."""
    data = compute_diags(state, grid, cfg, p_levels)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".nc"):
        w = ncio.NetCDFWriter()
        for k, v in data.items():
            w.put_var(k, v)
        w.put_att("_time_s", float(time_s))
        w.write(path, async_write=True)
    else:
        data["_time_s"] = np.float64(time_s)
        np.savez(path, **data)
