"""WPS intermediate-format reading and writing, the ungrib -> metgrid
hand-off format (port of the JAX package's `io/wps_intermediate.py`, which
is numpy and the standard library already; canonical
WPS/ungrib/src/output_module.F90 writer and
WPS/metgrid/src/read_met_module.F90 reader).  Reading these files lets
`models.real` run from real analyses (GFS/ERA pressure-level extracts)
instead of the synthetic generator.

Format (IFV=5, the only version WPS has used since 2007): per 2D slab, five
big-endian Fortran sequential records (each framed by 4-byte length words):

  1. IFV                      int32
  2. HDATE(24) XFCST MAP_SOURCE(32) FIELD(9) UNITS(25) DESC(46) XLVL NX NY IPROJ
  3. projection parameters    (layout depends on IPROJ, below)
  4. IS_WIND_EARTH_REL        4-byte Fortran LOGICAL
  5. SLAB                     NX*NY float32, Fortran (column-major) order

XLVL encodes the level: pressure in Pa for upper-air slabs, 200100.0 for
surface fields, 201300.0 for sea level.

`snapshots_from_wps` turns a time-ordered set of files into the
`AnalysisSnapshot`s of the real-data path, with RH -> mixing-ratio
conversion and bilinear regridding from a regular lat-lon (IPROJ=0)
source grid onto the model grid.  A file written by either package is
byte-identical to the other's.
"""

from __future__ import annotations

import dataclasses
import struct
from datetime import datetime
from typing import Dict, List, Sequence

import numpy as np

from wrfchem_arc_interactions_tpu_torch.models.real import AnalysisSnapshot

IFV = 5
# XLVL sentinel levels (WPS convention)
LVL_SURFACE = 200100.0
LVL_SEALEVEL = 201300.0

# projection-record float counts AFTER the 8-char STARTLOC, by IPROJ
_PROJ_NFLOAT = {0: 5, 1: 6, 3: 8, 4: 5, 5: 7}
_PROJ_FIELDS = {
    0: ("startlat", "startlon", "deltalat", "deltalon", "earth_radius"),
    1: ("startlat", "startlon", "dx", "dy", "truelat1", "earth_radius"),
    3: ("startlat", "startlon", "dx", "dy", "xlonc", "truelat1",
        "truelat2", "earth_radius"),
    4: ("startlat", "startlon", "nlats", "deltalon", "earth_radius"),
    5: ("startlat", "startlon", "dx", "dy", "xlonc", "truelat1",
        "earth_radius"),
}


@dataclasses.dataclass
class WPSRecord:
    """One 2D slab of one field at one level/time (the unit of the format)."""

    hdate: str                 # "YYYY-MM-DD_HH:MM:SS" (24 chars padded)
    xfcst: float               # forecast hour
    map_source: str
    field: str                 # e.g. "TT", "UU", "VV", "RH", "PSFC"
    units: str
    desc: str
    xlvl: float                # Pa, or LVL_SURFACE / LVL_SEALEVEL
    iproj: int
    startloc: str              # "SWCORNER" (or "CENTER  ")
    proj: Dict[str, float]     # keys per _PROJ_FIELDS[iproj]
    wind_earth_rel: bool
    slab: np.ndarray           # (ny, nx) float32, C order

    def lats_lons(self):
        """Row latitudes / column longitudes for an IPROJ=0 slab."""
        if self.iproj != 0:
            raise ValueError("lats_lons: only IPROJ=0 (regular lat-lon)")
        ny, nx = self.slab.shape
        p = self.proj
        lat = p["startlat"] + p["deltalat"] * np.arange(ny)
        lon = p["startlon"] + p["deltalon"] * np.arange(nx)
        return lat, lon


def _rec(payload: bytes) -> bytes:
    n = struct.pack(">i", len(payload))
    return n + payload + n


def _fstr(s: str, n: int) -> bytes:
    return s.ljust(n)[:n].encode("ascii")


def write_wps_intermediate(path: str, records: Sequence[WPSRecord]) -> None:
    """Write records in the exact ungrib output layout (big-endian Fortran
    sequential).  Files written here are byte-compatible with metgrid."""
    with open(path, "wb") as f:
        for r in records:
            f.write(_rec(struct.pack(">i", IFV)))
            ny, nx = r.slab.shape
            hdr = (_fstr(r.hdate, 24)
                   + struct.pack(">f", r.xfcst)
                   + _fstr(r.map_source, 32)
                   + _fstr(r.field, 9)
                   + _fstr(r.units, 25)
                   + _fstr(r.desc, 46)
                   + struct.pack(">f", r.xlvl)
                   + struct.pack(">iii", nx, ny, r.iproj))
            f.write(_rec(hdr))
            names = _PROJ_FIELDS[r.iproj]
            proj = _fstr(r.startloc, 8) + struct.pack(
                ">" + "f" * len(names), *[float(r.proj[k]) for k in names])
            f.write(_rec(proj))
            f.write(_rec(struct.pack(">i", 1 if r.wind_earth_rel else 0)))
            # SLAB is (nx, ny) in Fortran order == (ny, nx) C-order transposed
            f.write(_rec(np.asarray(r.slab, ">f4").T.tobytes(order="F")))


def read_wps_intermediate(path: str) -> List[WPSRecord]:
    with open(path, "rb") as f:
        data = f.read()
    out: List[WPSRecord] = []
    off = 0

    def rec():
        nonlocal off
        (n,) = struct.unpack_from(">i", data, off)
        payload = data[off + 4:off + 4 + n]
        (n2,) = struct.unpack_from(">i", data, off + 4 + n)
        if n2 != n:
            raise ValueError(f"corrupt Fortran record at byte {off}")
        off += 8 + n
        return payload

    while off < len(data):
        (ifv,) = struct.unpack(">i", rec())
        if ifv != IFV:
            raise ValueError(f"unsupported IFV {ifv} (only version 5)")
        h = rec()
        hdate = h[:24].decode("ascii")
        (xfcst,) = struct.unpack_from(">f", h, 24)
        map_source = h[28:60].decode("ascii").rstrip()
        field = h[60:69].decode("ascii").rstrip()
        units = h[69:94].decode("ascii").rstrip()
        desc = h[94:140].decode("ascii").rstrip()
        xlvl, nx, ny, iproj = struct.unpack_from(">fiii", h, 140)
        p = rec()
        startloc = p[:8].decode("ascii")
        names = _PROJ_FIELDS[iproj]
        vals = struct.unpack_from(">" + "f" * len(names), p, 8)
        (rel,) = struct.unpack(">i", rec())
        slab = np.frombuffer(rec(), ">f4").reshape(nx, ny, order="F").T
        out.append(WPSRecord(
            hdate=hdate, xfcst=xfcst, map_source=map_source, field=field,
            units=units, desc=desc, xlvl=float(xlvl), iproj=iproj,
            startloc=startloc, proj=dict(zip(names, vals)),
            wind_earth_rel=bool(rel),
            slab=np.ascontiguousarray(slab, np.float32)))
    return out


def _parse_hdate(hdate: str) -> datetime:
    s = hdate.strip().replace("_", " ")
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d %H"):
        try:
            return datetime.strptime(s[:19].rstrip(), fmt)
        except ValueError:
            continue
    raise ValueError(f"unparseable HDATE {hdate!r}")


def _rh_to_qv(rh: np.ndarray, t: np.ndarray, p: float) -> np.ndarray:
    """RH [%] -> vapor mixing ratio [kg/kg] (Bolton saturation vapor
    pressure, the same form the physics uses)."""
    es = 611.2 * np.exp(17.67 * (t - 273.15) / np.maximum(t - 29.65, 1.0))
    qvs = 0.622 * es / np.maximum(p - es, 1.0)
    return np.clip(rh, 0.0, 100.0) / 100.0 * qvs


def _regrid(slab: np.ndarray, rec: WPSRecord, xlat: np.ndarray,
            xlong: np.ndarray) -> np.ndarray:
    """Bilinear interpolation from the record's regular lat-lon grid onto
    the model's (ny, nx) lat/lon arrays (the metgrid horizontal-interp
    role, four-point form of interp_option=bilinear)."""
    lat_s, lon_s = rec.lats_lons()
    # fractional indices of the model points in the source grid (clamped:
    # metgrid's outside-domain points are an error; here the synthetic /
    # extract grids are built to cover the model domain)
    fi = np.clip((xlat - lat_s[0]) / (lat_s[1] - lat_s[0]) if len(lat_s) > 1
                 else np.zeros_like(xlat), 0, len(lat_s) - 1.000001)
    fj = np.clip((xlong - lon_s[0]) / (lon_s[1] - lon_s[0]) if len(lon_s) > 1
                 else np.zeros_like(xlong), 0, len(lon_s) - 1.000001)
    i0 = np.floor(fi).astype(int)
    j0 = np.floor(fj).astype(int)
    wi, wj = fi - i0, fj - j0
    return ((1 - wi) * (1 - wj) * slab[i0, j0]
            + wi * (1 - wj) * slab[i0 + 1, j0]
            + (1 - wi) * wj * slab[i0, j0 + 1]
            + wi * wj * slab[i0 + 1, j0 + 1])


def snapshots_from_wps(paths: Sequence[str], grid=None):
    """Convert time-ordered WPS intermediate files into AnalysisSnapshots
    for `models.real.real_init`.

    Expects the standard ungrib field set: TT/UU/VV + RH or SPECHUMD on
    pressure levels, PSFC and SOILHGT at the surface.  With `grid` given,
    IPROJ=0 slabs are bilinearly regridded onto grid.xlat/xlong; without
    it the slab dims must match across fields and are used as-is."""
    by_time: Dict[str, List[WPSRecord]] = {}
    for path in paths:
        for r in read_wps_intermediate(path):
            by_time.setdefault(r.hdate.strip(), []).append(r)

    times = sorted(by_time, key=_parse_hdate)
    t0 = _parse_hdate(times[0])
    snaps = []
    xlat = grid.xlat.cpu().numpy() if grid is not None else None
    xlong = grid.xlong.cpu().numpy() if grid is not None else None
    for hdate in times:
        recs = by_time[hdate]

        def grab(field):
            levs = sorted({r.xlvl for r in recs
                           if r.field == field and r.xlvl < LVL_SURFACE},
                          reverse=True)           # decreasing pressure
            slabs = {}
            for r in recs:
                if r.field == field and r.xlvl in levs and r.xlvl not in slabs:
                    s = r.slab
                    if xlat is not None and r.iproj == 0:
                        s = _regrid(s, r, xlat, xlong)
                    slabs[r.xlvl] = s
            if not levs:
                return None, None
            return np.array(levs), np.stack([slabs[p] for p in levs])

        def grab2d(field, default=None):
            for r in recs:
                if r.field == field and r.xlvl >= LVL_SURFACE:
                    s = r.slab
                    if xlat is not None and r.iproj == 0:
                        s = _regrid(s, r, xlat, xlong)
                    return s
            return default

        p_levels, t3 = grab("TT")
        if t3 is None:
            raise ValueError(f"no TT upper-air slabs at {hdate}")
        _, u3 = grab("UU")
        _, v3 = grab("VV")
        _, qv3 = grab("SPECHUMD")
        if qv3 is not None:
            qv3 = qv3 / np.maximum(1.0 - qv3, 1e-6)   # specific hum -> mix r.
        else:
            _, rh3 = grab("RH")
            if rh3 is None:
                raise ValueError(f"neither SPECHUMD nor RH at {hdate}")
            qv3 = np.stack([_rh_to_qv(rh3[k], t3[k], p_levels[k])
                            for k in range(len(p_levels))])
        shape2d = t3.shape[1:]
        p_sfc = grab2d("PSFC", np.full(shape2d, float(p_levels[0]),
                                       np.float32))
        ht = grab2d("SOILHGT", np.zeros(shape2d, np.float32))
        snaps.append(AnalysisSnapshot(
            time_s=(_parse_hdate(hdate) - t0).total_seconds(),
            p_levels=p_levels.astype(np.float64),
            t=t3.astype(np.float64), qv=np.maximum(qv3, 0.0).astype(np.float64),
            u=u3.astype(np.float64), v=v3.astype(np.float64),
            p_sfc=np.asarray(p_sfc, np.float64),
            ht=np.asarray(ht, np.float64)))
    return snaps
