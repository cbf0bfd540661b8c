"""Map projections: map-scale factors, Coriolis fields, and lat/lon for
real-domain grids (port of the JAX package's `grid/projection.py`, which
is numpy already; canonical: the WPS geogrid role + share/module_llxy.F).

All supported projections are conformal and isotropic (m_x = m_y = m):

- ``lambert``    — Lambert conformal conic (one or two true latitudes);
- ``mercator``   — rotated-pole-free Mercator;
- ``polar``      — polar stereographic;
- ``lat-lon``    — regular latitude-longitude (m = 1/cos(lat), handled on
                   the isotropic machinery as the reference does);
- ``cartesian``  — idealized f-plane (m = 1), the default.

Outputs are the staggered map-factor fields (msft/msfu/msfv), d(m)/dy,
Coriolis parameters f = 2 Omega sin(lat) and e = 2 Omega cos(lat), and
xlat/xlong at mass points, as float32 numpy arrays, computed on the host
in the reference's float64 arithmetic so that both packages start from the
same grid bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EARTH_R = 6_370_000.0           # WRF's spherical earth radius [m]
OMEGA_E = 7.292e-5              # earth rotation rate [1/s]


@dataclasses.dataclass(frozen=True)
class Projection:
    """Projection spec (the &geogrid map_proj block analog)."""

    kind: str = "cartesian"        # lambert | mercator | polar | lat-lon | cartesian
    ref_lat: float = 40.0          # domain-center latitude [deg]
    ref_lon: float = 0.0
    truelat1: float = 30.0
    truelat2: float = 60.0
    stand_lon: float = 0.0


def _lambert_n(tl1: float, tl2: float) -> float:
    t1, t2 = np.radians(tl1), np.radians(tl2)
    if abs(tl1 - tl2) < 1e-6:
        return np.sin(t1)
    return (np.log(np.cos(t1) / np.cos(t2))
            / np.log(np.tan(np.pi / 4 + t2 / 2) / np.tan(np.pi / 4 + t1 / 2)))


def _map_factor(kind: str, lat_deg: np.ndarray, proj: Projection) -> np.ndarray:
    lat = np.radians(lat_deg)
    if kind == "cartesian":
        return np.ones_like(lat)
    if kind == "mercator":
        return np.cos(np.radians(proj.truelat1)) / np.cos(lat)
    if kind == "polar":
        t1 = np.radians(proj.truelat1)
        return (1.0 + np.sin(t1)) / (1.0 + np.sin(lat))
    if kind == "lambert":
        n = _lambert_n(proj.truelat1, proj.truelat2)
        t1 = np.radians(proj.truelat1)
        return (np.cos(t1) / np.cos(lat)
                * (np.tan(np.pi / 4 - lat / 2)
                   / np.tan(np.pi / 4 - t1 / 2)) ** n)
    if kind == "lat-lon":
        return 1.0 / np.maximum(np.cos(lat), 1e-3)
    raise ValueError(kind)


def _inverse_lat(kind: str, y_m: np.ndarray, proj: Projection) -> np.ndarray:
    """Latitude [deg] at projected northward distance y_m from ref_lat
    (exact inverses of the conformal projections along the y axis)."""
    lat0 = np.radians(proj.ref_lat)
    if kind == "cartesian":
        # f-plane: keep the reference latitude everywhere
        return np.full_like(y_m, proj.ref_lat)
    if kind == "mercator":
        t1 = np.radians(proj.truelat1)
        y0 = EARTH_R * np.cos(t1) * np.log(np.tan(np.pi / 4 + lat0 / 2))
        return np.degrees(2 * np.arctan(np.exp((y0 + y_m)
                                               / (EARTH_R * np.cos(t1))))
                          - np.pi / 2)
    if kind == "polar":
        t1 = np.radians(proj.truelat1)
        r0 = EARTH_R * np.cos(lat0) * (1 + np.sin(t1)) / (1 + np.sin(lat0))
        r = r0 - y_m                      # toward the pole as y grows
        return np.degrees(np.pi / 2 - 2 * np.arctan(
            np.maximum(r, 0.0) / (EARTH_R * (1 + np.sin(t1)))))
    if kind == "lambert":
        n = _lambert_n(proj.truelat1, proj.truelat2)
        t1 = np.radians(proj.truelat1)
        f_c = EARTH_R * np.cos(t1) / n * np.tan(np.pi / 4 - t1 / 2) ** (-n)
        r0 = f_c * np.tan(np.pi / 4 - lat0 / 2) ** n
        r = np.maximum(r0 - y_m, 1.0)
        return np.degrees(np.pi / 2 - 2 * np.arctan((r / f_c) ** (1.0 / n)))
    if kind == "lat-lon":
        return proj.ref_lat + np.degrees(y_m / EARTH_R)
    raise ValueError(kind)


def projection_fields(proj: Projection, ny: int, nx: int,
                      dx: float, dy: float) -> dict:
    """Compute the grid's horizontal metric fields.

    Returns dict with msft/msfu/msfv (ny, nx), f and e (ny, nx),
    xlat/xlong (ny, nx) — mass-point lat/lon; u/v-face factors from the
    staggered positions (this framework's same-size convention: u at west
    faces x=i*dx, v at south faces y=j*dy, mass at (i+0.5, j+0.5))."""
    yc = (np.arange(ny) + 0.5 - ny / 2.0) * dy     # mass rows about center
    yv = (np.arange(ny + 1) - ny / 2.0) * dy       # v-face rows (+ north lid)

    lat_t = _inverse_lat(proj.kind, yc, proj)
    lat_v = _inverse_lat(proj.kind, yv, proj)
    m_t = _map_factor(proj.kind, lat_t, proj)
    m_vf = _map_factor(proj.kind, lat_v, proj)      # (ny+1,) incl. north face
    m_v = m_vf[:-1]

    msft = np.repeat(m_t[:, None], nx, 1)
    msfv = np.repeat(m_v[:, None], nx, 1)
    msfu = msft.copy()             # conformal: m varies only with latitude
    # d(m)/dy at mass points, in projected (map-plane) metres — the general
    # conformal curvature coefficient f_eff = f + u dm/dy - v dm/dx
    # (canonical: the msfvy gradients of module_big_step_utilities_em.F
    # coriolis/curvature; reduces to the spherical u*tan(lat)/a term on a
    # Mercator grid where dm/dy = tan(lat)/a exactly).  dm/dx = 0: all
    # supported projections vary only with the row.
    dmdy = np.repeat(((m_vf[1:] - m_vf[:-1]) / dy)[:, None], nx, 1)

    f = 2 * OMEGA_E * np.sin(np.radians(lat_t))
    e = 2 * OMEGA_E * np.cos(np.radians(lat_t))
    xlat = np.repeat(lat_t[:, None], nx, 1)
    xc = (np.arange(nx) + 0.5 - nx / 2.0) * dx
    # longitude from conformal x distance: dlon = m dx / (R cos(lat))
    with np.errstate(divide="ignore"):
        dlon = np.degrees(xc[None, :] * m_t[:, None]
                          / (EARTH_R * np.maximum(
                              np.cos(np.radians(lat_t))[:, None], 1e-3)))
    xlong = proj.ref_lon + dlon

    return {"msft": msft.astype(np.float32),
            "msfu": msfu.astype(np.float32),
            "msfv": msfv.astype(np.float32),
            "dmdy": dmdy.astype(np.float32),
            "f": np.repeat(f[:, None], nx, 1).astype(np.float32),
            "e": np.repeat(e[:, None], nx, 1).astype(np.float32),
            "xlat": xlat.astype(np.float32),
            "xlong": xlong.astype(np.float32)}
