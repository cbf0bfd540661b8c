"""Banded-matmul form of the scalar advection fluxes (port of the JAX
package's `ops/mxu_adv.py`).

An order-p face reconstruction is a banded convolution along one axis,

    face_sum[f] = sum_m w_m q[f + m]   ->   q_pad @ W   (W banded, static),

so the 6-point even part and the 5-point dissipation part of flux5/flux3
(or the narrower bands of the lower orders) become two matrix products
per direction over all tracers at once; what is left elementwise is
vel * even - |vel| * diss.  The reference wrote it for the TPU's matrix
unit as an XLA product outside any Pallas kernel, so the port applies the
same matrices, built in numpy from the same coefficients, with the
library's product (`torch.matmul`).

Precision: the reference contracts at ``Precision.HIGHEST`` (full float32).
The port's products are full float32 too: on the card each product runs
with ``torch.set_float32_matmul_precision("highest")``, so no TF32 enters
whatever the caller's setting, and the fluxes agree with the stencil
formulas (`dycore.advection.scalar_fluxes`) to float32 dot-product
rounding (relative ~1e-6).

Fluxes are still computed once per face and then differenced, so the
telescoping sum keeps conservation exact.  The vertical direction folds
the edge-replicated ghost levels of `advection._zpad` into the band rows,
and the zero omega at the rigid eta boundaries into zero first and last
columns.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

# face f sits between cells f-1 and f: the stencil's cells are f-3 .. f+2
_EVEN6 = np.array([1.0, -8.0, 37.0, 37.0, -8.0, 1.0]) / 60.0      # qm3..qp2
_DISS5 = np.array([-1.0, 5.0, -10.0, 10.0, -5.0, 1.0]) / 60.0     # sign(+vel)
_EVEN4 = np.array([0.0, -1.0, 7.0, 7.0, -1.0, 0.0]) / 12.0
_DISS3 = np.array([0.0, 1.0, -3.0, 3.0, -1.0, 0.0]) / 12.0
_EVEN2 = np.array([0.0, 0.0, 0.5, 0.5, 0.0, 0.0])
_DISS1 = np.array([0.0, 0.0, -0.5, 0.5, 0.0, 0.0])   # upwind = even2 - |v|*diss1


def _coeffs(order: int):
    if order in (5, 6):
        ev = _EVEN6
    elif order in (3, 4):
        ev = _EVEN4
    elif order in (1, 2):
        ev = _EVEN2
    else:
        raise ValueError(order)
    ds = {5: _DISS5, 3: _DISS3, 1: _DISS1}.get(order)
    return ev, ds


@functools.lru_cache(maxsize=None)
def _band_h(npad: int, nfaces: int, pad: int, order: int):
    """(npad, nfaces) float32 banded matrices (even, diss) for the
    horizontal faces of a pad-halo axis; diss is None for even orders."""
    ev, ds = _coeffs(order)
    we = np.zeros((npad, nfaces), np.float32)
    wd = np.zeros((npad, nfaces), np.float32) if ds is not None else None
    for f in range(nfaces):
        for m in range(6):
            row = f + pad - 3 + m
            we[row, f] += ev[m]
            if wd is not None:
                wd[row, f] += ds[m]
    return we, wd


@functools.lru_cache(maxsize=None)
def _band_z(nz: int, order: int):
    """(nz, nz+1) float32 banded matrices for the eta faces, with the edge
    replication folded into the edge rows and faces 0 and nz zero (omega
    vanishes at the rigid eta boundaries)."""
    ev, ds = _coeffs(order)
    we = np.zeros((nz, nz + 1), np.float32)
    wd = np.zeros((nz, nz + 1), np.float32) if ds is not None else None
    for f in range(1, nz):                    # interior faces only
        for m in range(6):
            lev = int(np.clip(f - 3 + m, 0, nz - 1))   # edge replication
            we[lev, f] += ev[m]
            if wd is not None:
                wd[lev, f] += ds[m]
    return we, wd


@contextlib.contextmanager
def _full_float32():
    """Full float32 products (no TF32) for the duration, as the
    reference's ``Precision.HIGHEST``."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _mm_axis(q: torch.Tensor, w: np.ndarray, axis: int) -> torch.Tensor:
    """Contract `axis` of q with the rows of `w`; the face axis in its
    place."""
    wt = torch.from_numpy(w).to(device=q.device, dtype=q.dtype)
    return torch.matmul(q.movedim(axis, -1), wt).movedim(-1, axis)


def scalar_fluxes_mxu(q_pad, ru_pad, rv_pad, ww, h_order: int, v_order: int,
                      pad: int = 3):
    """`dycore.advection.scalar_fluxes` on (optionally batched) pad-halo
    inputs as banded products: q_pad (..., nz, ny+2p, nx+2p), ru_pad and
    rv_pad (nz, ny+2p, nx+2p), ww (nz+1, ny, nx).  Returns (fx, fy, fz) of
    the stencil path's shapes, fz zero at the eta boundaries."""
    nz, ny, nx = ww.shape[-3] - 1, ww.shape[-2], ww.shape[-1]
    with _full_float32():
        # x faces: 0..nx
        wxe, wxd = _band_h(q_pad.shape[-1], nx + 1, pad, h_order)
        qy = q_pad[..., pad:pad + ny, :]
        vel_x = ru_pad[..., pad:pad + ny, pad:pad + nx + 1]
        fx = vel_x * _mm_axis(qy, wxe, -1)
        if wxd is not None:
            fx = fx - torch.abs(vel_x) * _mm_axis(qy, wxd, -1)

        # y faces: 0..ny
        wye, wyd = _band_h(q_pad.shape[-2], ny + 1, pad, h_order)
        qx = q_pad[..., pad:pad + nx]
        vel_y = rv_pad[..., pad:pad + ny + 1, pad:pad + nx]
        fy = vel_y * _mm_axis(qx, wye, -2)
        if wyd is not None:
            fy = fy - torch.abs(vel_y) * _mm_axis(qx, wyd, -2)

        # eta faces: 0..nz; transport runs against the eta index
        # (advection.vflux), so the dissipation's sign flips
        wze, wzd = _band_z(nz, v_order)
        qi = q_pad[..., pad:pad + ny, pad:pad + nx]
        fz = ww * _mm_axis(qi, wze, -3)
        if wzd is not None:
            fz = fz + torch.abs(ww) * _mm_axis(qi, wzd, -3)
    return fx, fy, fz
