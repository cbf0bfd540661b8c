"""Grid container: eta coordinate, metric terms, dry hydrostatic base state
(port of the JAX package's `grid/grid.py`).

Coordinate: ARW terrain-following dry-mass coordinate; eta decreases from 1
(surface, k=0) to 0 (model top, k=nz), arrays stored surface-first.  3D
arrays are (nz[, +1], ny, nx); 2D are (ny, nx).

The base state (over terrain, where there is terrain) and the projection's
metric fields are computed on the host in numpy float64, exactly as the
reference does, and only then cast to the state dtype and moved to the
device, so that both packages start from the same float32 grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid.projection import projection_fields
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike

TENSOR_FIELDS = ("znw", "znu", "dnw", "rdnw", "dn", "rdn", "fnp", "fnm",
                 "mub", "pb", "alb", "phb", "t_init",
                 "msft", "msfu", "msfv", "dmdy", "f", "ht", "xlat", "xlong")


@dataclasses.dataclass(frozen=True)
class Grid:
    # --- vertical coordinate arrays (1D) ---
    znw: torch.Tensor   # (nz+1,) eta at w (full) levels, znw[0]=1 ... znw[nz]=0
    znu: torch.Tensor   # (nz,)   eta at mass (half) levels
    dnw: torch.Tensor   # (nz,)   znw[k+1]-znw[k]  (negative)
    rdnw: torch.Tensor  # (nz,)   1/dnw
    dn: torch.Tensor    # (nz,)   znu[k]-znu[k-1] (dn[0] unused)
    rdn: torch.Tensor   # (nz,)
    fnp: torch.Tensor   # (nz,)   interp weight of level k   to w-level k
    fnm: torch.Tensor   # (nz,)   interp weight of level k-1 to w-level k
    # --- base state (dry, hydrostatic) ---
    mub: torch.Tensor     # (ny,nx)      base dry column mass [Pa]
    pb: torch.Tensor      # (nz,ny,nx)   base pressure at mass levels
    alb: torch.Tensor     # (nz,ny,nx)   base inverse density alpha_d
    phb: torch.Tensor     # (nz+1,ny,nx) base geopotential at w-levels
    t_init: torch.Tensor  # (nz,ny,nx)   base potential temperature
    # --- horizontal metrics ---
    msft: torch.Tensor
    msfu: torch.Tensor
    msfv: torch.Tensor
    dmdy: torch.Tensor
    f: torch.Tensor
    ht: torch.Tensor
    xlat: torch.Tensor
    xlong: torch.Tensor
    # --- static metadata ---
    dx: float
    dy: float
    p_top: float
    has_terrain: bool = False
    curvature: bool = False

    @property
    def has_msf(self) -> bool:
        return self.curvature

    @property
    def nz(self) -> int:
        return self.znu.shape[0]

    @property
    def ny(self) -> int:
        return self.mub.shape[0]

    @property
    def nx(self) -> int:
        return self.mub.shape[1]

    @property
    def rdx(self) -> float:
        return 1.0 / self.dx

    @property
    def rdy(self) -> float:
        return 1.0 / self.dy

    @property
    def device(self) -> torch.device:
        return self.mub.device

    def to(self, device: DeviceLike) -> "Grid":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in TENSOR_FIELDS})


def make_eta_levels(nz: int,
                    ztop: float,
                    p_top: float,
                    theta_of_z: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                    stretch: str = "uniform_dz") -> np.ndarray:
    """Full (w) eta levels znw[0..nz], 1 at surface decreasing to 0 at top."""
    if stretch == "uniform_eta" or theta_of_z is None:
        return np.linspace(1.0, 0.0, nz + 1)
    zf = np.linspace(0.0, ztop, 4001)
    theta = theta_of_z(zf)
    # d(pi)/dz = -g/(cp*theta), pi = (p/p0)^(R/cp)
    pi = np.empty_like(zf)
    pi[0] = 1.0
    dz = zf[1] - zf[0]
    th_mid = 0.5 * (theta[:-1] + theta[1:])
    for i in range(len(zf) - 1):
        pi[i + 1] = pi[i] - dz * c.G / (c.CP * th_mid[i])
    p_of_z = c.P0 * pi ** (c.CP / c.R_D)
    p_surf = p_of_z[0]
    z_levels = np.linspace(0.0, ztop, nz + 1)
    p_levels = np.interp(z_levels, zf, p_of_z)
    eta = (p_levels - p_top) / (p_surf - p_top)
    eta[0] = 1.0
    eta = np.maximum.accumulate(eta[::-1])[::-1]
    eta[-1] = 0.0
    return eta


def make_grid(cfg: Config,
              theta_of_z: Callable[[np.ndarray], np.ndarray],
              device: DeviceLike,
              terrain: Optional[np.ndarray] = None,
              f0: float = 0.0,
              lat0: float = 40.0,
              lon0: float = 0.0,
              p_surf: float = c.P0,
              stretch: str = "uniform_dz",
              projection=None,
              dtype: torch.dtype = torch.float32) -> Grid:
    """Grid + dry hydrostatic base state on `device`.

    ``theta_of_z`` is the base-state sounding (numpy, called on the host).
    With `terrain` (ny, nx) [m] the surface dry pressure of each column is
    read from the fine hydrostatic p(z) of the sounding at z = ht and the
    base state is iterated per column, so that phb/alb/pb satisfy the
    discrete hydrostatic relation exactly over the orography.  With a
    `projection` (`grid.projection.Projection`, not cartesian) the grid
    carries its map factors, latitude-varying Coriolis and lat/lon, and the
    dycore switches on its map-factor terms (`Grid.curvature`).
    """
    d = cfg.domain
    nz, ny, nx = d.nz, d.ny, d.nx
    znw = make_eta_levels(nz, d.ztop, d.p_top, theta_of_z, stretch)
    znu = 0.5 * (znw[:-1] + znw[1:])
    dnw = np.diff(znw)
    rdnw = 1.0 / dnw
    dn = np.zeros(nz)
    dn[1:] = znu[1:] - znu[:-1]
    rdn = np.zeros(nz)
    rdn[1:] = 1.0 / dn[1:]
    fnp = np.zeros(nz)
    fnm = np.zeros(nz)
    fnp[1:] = 0.5 * dnw[1:] / dn[1:]
    fnm[1:] = 0.5 * dnw[:-1] / dn[1:]

    if terrain is None:
        terrain = np.zeros((ny, nx))
    terrain = np.asarray(terrain, np.float64)
    has_terrain = bool(np.any(terrain != terrain.flat[0])) or bool(terrain.flat[0] != 0.0)

    if has_terrain:
        # per-column surface dry pressure from the fine hydrostatic p(z)
        zf = np.linspace(0.0, max(d.ztop, float(terrain.max()) + 1.0), 4001)
        theta_f = theta_of_z(zf)
        pi = np.empty_like(zf)
        pi[0] = (p_surf / c.P0) ** (c.R_D / c.CP)
        dzf = zf[1] - zf[0]
        th_mid = 0.5 * (theta_f[:-1] + theta_f[1:])
        for i in range(len(zf) - 1):
            pi[i + 1] = pi[i] - dzf * c.G / (c.CP * th_mid[i])
        p_of_z = c.P0 * pi ** (c.CP / c.R_D)
        p_surf_col = np.interp(terrain, zf, p_of_z)
    else:
        p_surf_col = np.full((ny, nx), p_surf)

    # vectorised per-column base-state iteration (float64 host-side)
    mub = p_surf_col - d.p_top
    pb = znu[:, None, None] * mub[None] + d.p_top
    z_half = terrain[None] + np.linspace(100.0, 10.0e3, nz)[:, None, None]
    phb = np.empty((nz + 1, ny, nx))
    for _ in range(12):
        t_init = theta_of_z(z_half)
        alb = (c.R_D * t_init / c.P0) * (pb / c.P0) ** (-c.CV / c.CP)
        phb[0] = c.G * terrain
        for k in range(nz):
            phb[k + 1] = phb[k] - dnw[k] * mub * alb[k]
        z_half = 0.5 * (phb[:-1] + phb[1:]) / c.G
    t_init = theta_of_z(z_half)
    alb = (c.R_D * t_init / c.P0) * (pb / c.P0) ** (-c.CV / c.CP)
    phb[0] = c.G * terrain
    for k in range(nz):
        phb[k + 1] = phb[k] - dnw[k] * mub * alb[k]

    ones = np.ones((ny, nx))
    if projection is not None and projection.kind != "cartesian":
        pf = projection_fields(projection, ny, nx, d.dx, d.dy)
        msft, msfu, msfv = pf["msft"], pf["msfu"], pf["msfv"]
        dmdy = pf["dmdy"]
        f_field, xlat, xlong = pf["f"], pf["xlat"], pf["xlong"]
        curvature = True
    else:
        msft = msfu = msfv = ones
        dmdy = np.zeros((ny, nx))
        f_field = f0 * ones
        xlat, xlong = lat0 * ones, lon0 * ones
        curvature = False

    def arr(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(dtype).to(device)

    return Grid(
        znw=arr(znw), znu=arr(znu), dnw=arr(dnw), rdnw=arr(rdnw),
        dn=arr(dn), rdn=arr(rdn), fnp=arr(fnp), fnm=arr(fnm),
        mub=arr(mub), pb=arr(pb), alb=arr(alb), phb=arr(phb), t_init=arr(t_init),
        msft=arr(msft), msfu=arr(msfu), msfv=arr(msfv), dmdy=arr(dmdy),
        f=arr(f_field), ht=arr(terrain),
        xlat=arr(xlat), xlong=arr(xlong),
        dx=float(d.dx), dy=float(d.dy), p_top=float(d.p_top),
        has_terrain=has_terrain, curvature=curvature,
    )


def grid_from_numpy(fields: Mapping[str, Any], device: DeviceLike) -> Grid:
    """Build a Grid from numpy arrays and the static entries (``dx``,
    ``dy``, ``p_top``, ``has_terrain``, ``curvature``) — for example the JAX
    package's Grid read field by field through ``np.asarray``."""
    tensors = {k: torch.from_numpy(np.array(fields[k], copy=True)).to(device)
               for k in TENSOR_FIELDS}
    return Grid(**tensors, dx=float(fields["dx"]), dy=float(fields["dy"]),
                p_top=float(fields["p_top"]),
                has_terrain=bool(fields.get("has_terrain", False)),
                curvature=bool(fields.get("curvature", False)))
