"""Polar Fourier filtering for global lat-lon domains (port of the JAX
package's `dycore/polar_filter.py`; canonical dyn_em/module_polar_fft.F,
driven from solve_em.F's pxft calls).

On a latitude-longitude grid the zonal spacing dx*cos(lat) collapses toward
the poles, so the poleward rows would otherwise set the CFL limit of the
whole domain.  Each poleward row is filtered in zonal wavenumber space:
modes k > k_max(lat) = (nx/2) cos(lat)/cos(lat_f) are truncated, so the
timestep is governed by the latitude `fft_filter_lat` instead of the pole;
scalars take a squared-cosine rolloff instead of the sharp cut, against
Gibbs ringing.  On a process mesh the x axis must stay whole (the
reference's own rule: each row's transform spans the globe); y may split.

The whole (nz, ny, nx) field is filtered in one batched ``torch.fft.rfft
-> mask -> irfft`` with a precomputed (ny, nx/2+1) mask, in float32 as the
reference computes it (whatever the field's type).  The reference's filter
is plain XLA code, not a Pallas kernel, and this is its plain counterpart:
the library FFT (cuFFT on the card).
"""

from __future__ import annotations

import math

import torch

from wrfchem_arc_interactions_tpu_torch.grid import Grid


def filter_mask(xlat_rows: torch.Tensor, nx: int, filter_lat_deg: float,
                taper: bool = False) -> torch.Tensor:
    """(ny, nx//2+1) float32 zonal-wavenumber amplitude mask for the row
    latitudes `xlat_rows` [deg].  Rows equatorward of `filter_lat_deg` are
    all ones; poleward rows keep k <= k_max(lat) and drop the rest, or with
    `taper` roll the modes in (k_max/2, k_max] off with cos^2."""
    dev = xlat_rows.device
    nk = nx // 2 + 1
    k = torch.arange(nk, dtype=torch.float32, device=dev)[None, :]
    lat = torch.abs(xlat_rows.to(torch.float32))[:, None]
    lat = torch.clamp(lat, max=89.9999)
    clat_f = torch.cos(torch.deg2rad(torch.tensor(filter_lat_deg, dtype=torch.float32,
                                                  device=dev)))
    k_max = (nx / 2.0) * torch.cos(torch.deg2rad(lat)) / clat_f
    if taper:
        x = torch.clamp((k - 0.5 * k_max) / torch.clamp(0.5 * k_max, min=1e-6), 0.0, 1.0)
        amp = torch.cos(0.5 * math.pi * x) ** 2
    else:
        amp = (k <= k_max).to(torch.float32)
    amp[:, 0] = 1.0          # the zonal mean always passes
    return torch.where(lat < filter_lat_deg, torch.ones_like(amp), amp)


def apply_filter(field: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Filter along the last (zonal) axis with the (ny, nk) row mask, in
    float32.  Accepts (ny, nx), (nz, ny, nx) or (nz+1, ny, nx); the result
    has the field's type."""
    spec = torch.fft.rfft(field.to(torch.float32), dim=-1)
    out = torch.fft.irfft(spec * mask, n=field.shape[-1], dim=-1)
    return out.to(field.dtype)


class PolarFilter:
    """Masks for the mass and v rows of a grid (v sits on y faces: its rows
    take the mean latitude of the two mass rows beside the face, the
    southern face the first row's)."""

    def __init__(self, grid: Grid, filter_lat_deg: float, nx: int, hx=None):
        if hx is not None and hx.mesh_x > 1:
            raise ValueError("the polar filter transforms whole rows: the x axis must not "
                             f"be decomposed (mesh_x = {hx.mesh_x}); use a (mesh_y, 1) mesh")
        lat_m = grid.xlat[:, 0]
        lat_v = 0.5 * (lat_m + torch.roll(lat_m, 1))
        lat_v[0] = lat_m[0]
        if hx is not None and hx.mesh_y > 1:
            # the southern face of a block above the domain's first row
            # lies between its first row and the row below, on the block
            # beneath (every rank exchanges)
            below = hx.pad(grid.xlat[None], 1)[0, 0, 1]
            if hx.mesh.iy > 0:
                lat_v[0] = 0.5 * (lat_m[0] + below)
        self.mask_m = filter_mask(lat_m, nx, filter_lat_deg)
        self.mask_m_taper = filter_mask(lat_m, nx, filter_lat_deg, taper=True)
        self.mask_v = filter_mask(lat_v, nx, filter_lat_deg)

    def momentum(self, state):
        """Filter the dynamical fields (u, v, w, theta, geopotential, mu)."""
        out = dict(state)
        for q, mask in (("u", self.mask_m), ("v", self.mask_v), ("w", self.mask_m),
                        ("t", self.mask_m), ("ph", self.mask_m), ("mu", self.mask_m)):
            if q in out:
                out[q] = apply_filter(out[q], mask)
        return out

    def scalar(self, q: torch.Tensor) -> torch.Tensor:
        """Tapered filter and clip at zero for a positive-definite tracer."""
        return torch.clamp(apply_filter(q, self.mask_m_taper), min=0.0)
