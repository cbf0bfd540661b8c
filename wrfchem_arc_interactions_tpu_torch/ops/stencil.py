"""Stencil window helpers over halo-padded tensors (port of the JAX
package's `ops/stencil.py`).

Horizontal stencil operators consume tensors padded by ``PAD`` cells in y
and x (filled by `parallel.halo.HaloOps.pad`) and produce interior-sized
results.  `win` returns a view; the consuming arithmetic materialises it.
"""

from __future__ import annotations

import torch

PAD = 3


def win(a: torch.Tensor, dy: int, dx: int, ey: int = 0, ex: int = 0,
        pad: int = PAD) -> torch.Tensor:
    """Interior window of padded `a`, shifted by (dy, dx) and extended by
    (ey, ex) points.  `a` is (..., ny + 2*pad, nx + 2*pad); the result is
    (..., ny + ey, nx + ex).  win(a, 0, -1) is a[j, i-1] aligned with (j, i).
    """
    ny = a.shape[-2] - 2 * pad
    nx = a.shape[-1] - 2 * pad
    j0 = pad + dy
    i0 = pad + dx
    return a[..., j0:j0 + ny + ey, i0:i0 + nx + ex]


def interior(a: torch.Tensor) -> torch.Tensor:
    return win(a, 0, 0)


def avg_z_centers_to_faces(q: torch.Tensor, fnm: torch.Tensor,
                           fnp: torch.Tensor) -> torch.Tensor:
    """(nz, ...) mass-level values -> (nz+1, ...) w-level values; the
    boundary w-levels copy the nearest mass level."""
    shp = (-1,) + (1,) * (q.dim() - 1)
    interior_faces = fnp[1:].reshape(shp) * q[:-1] + fnm[1:].reshape(shp) * q[1:]
    return torch.cat([q[:1], interior_faces, q[-1:]], dim=0)
