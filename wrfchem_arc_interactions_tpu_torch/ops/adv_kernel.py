"""Fused 5th/3rd-order scalar advection tendency: CUDA kernel wrapper and
its plain PyTorch version.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_adv.py::
advect_scalar_5_3``.  Both compute
``dycore/advection.py::advect_scalar(q_pad, ru_pad, rv_pad, ww, grid, 5, 3)``
on a flat grid: the tendency -div F of one mass-point scalar, with 5th-order
horizontal and 3rd-order vertical fluxes.  The kernel
(``csrc/advect_scalar_5_3.cu``) is memory-bound (10.8 MB per call at
100x100x50, 3.2 us at 3.35 TB/s); its header states the design.

`advect_scalar_5_3` launches the kernel for CUDA tensors and runs
`advect_scalar_5_3_reference` for CPU tensors; it never falls back from
one to the other.  ``advect_scalar_5_3.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.advection import (
    _stencil_x, _stencil_y, _stencil_z, flux3, flux5,
)
from wrfchem_arc_interactions_tpu_torch.ops import build
from wrfchem_arc_interactions_tpu_torch.ops.stencil import PAD, win

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def advect_scalar_5_3_reference(q_pad, ru_pad, rv_pad, ww, rdnw, rdx: float,
                                rdy: float) -> torch.Tensor:
    """Plain PyTorch version: `advection.advect_scalar(..., 5, 3)` with the
    grid reduced to (rdnw, rdx, rdy), in the same operation order."""
    fx = flux5(win(ru_pad, 0, 0, ex=1), *_stencil_x(q_pad))
    fy = flux5(win(rv_pad, 0, 0, ey=1), *_stencil_y(q_pad))
    qm3, qm2, qm1, q0, qp1, qp2 = _stencil_z(win(q_pad, 0, 0), ww.shape[0])
    fz = -flux3(-ww, qm2, qm1, q0, qp1)
    fz[0] = 0.0
    fz[-1] = 0.0
    hdiv = ((fx[..., 1:] - fx[..., :-1]) * rdx
            + (fy[..., 1:, :] - fy[..., :-1, :]) * rdy)
    dfz = fz[1:] - fz[:-1]
    return -(hdiv + dfz * rdnw.reshape(-1, 1, 1))


def _check(q_pad, ru_pad, rv_pad, ww, rdnw):
    tensors = {"q_pad": q_pad, "ru_pad": ru_pad, "rv_pad": rv_pad, "ww": ww,
               "rdnw": rdnw}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q_pad.device:
            raise ValueError(f"{name} is on {t.device}, q_pad on {q_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_pad.dim() != 3:
        raise ValueError(f"q_pad must be (nz, ny+6, nx+6), got {tuple(q_pad.shape)}")
    nz, nyp, nxp = q_pad.shape
    ny, nx = nyp - 2 * PAD, nxp - 2 * PAD
    if nz < 1 or ny < 1 or nx < 1:
        raise ValueError(f"empty interior in q_pad {tuple(q_pad.shape)}")
    for name, t in (("ru_pad", ru_pad), ("rv_pad", rv_pad)):
        if t.shape != q_pad.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q_pad {tuple(q_pad.shape)}")
    if tuple(ww.shape) != (nz + 1, ny, nx):
        raise ValueError(f"ww must be {(nz + 1, ny, nx)}, got {tuple(ww.shape)}")
    if tuple(rdnw.shape) != (nz,):
        raise ValueError(f"rdnw must be ({nz},), got {tuple(rdnw.shape)}")
    if nz > 65535:
        raise ValueError("nz exceeds the kernel's grid z limit (65535)")
    return nz, ny, nx


def advect_scalar_5_3(q_pad, ru_pad, rv_pad, ww, rdnw, rdx: float,
                      rdy: float) -> torch.Tensor:
    """Tendency (nz, ny, nx) of a mass-point scalar; q_pad/ru_pad/rv_pad are
    PAD-padded (nz, ny+6, nx+6), ww is (nz+1, ny, nx), rdnw is (nz,)."""
    nz, ny, nx = _check(q_pad, ru_pad, rv_pad, ww, rdnw)
    if q_pad.device.type == "cpu":
        return advect_scalar_5_3_reference(q_pad, ru_pad, rv_pad, ww, rdnw, rdx, rdy)
    if q_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {q_pad.device}")
    fn = build.load("advect_scalar_5_3").advect_scalar_5_3
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((nz, ny, nx), dtype=torch.float32, device=q_pad.device)
    with torch.cuda.device(q_pad.device):
        stream = torch.cuda.current_stream(q_pad.device).cuda_stream
        err = fn(q_pad.data_ptr(), ru_pad.data_ptr(), rv_pad.data_ptr(),
                 ww.data_ptr(), rdnw.data_ptr(), out.data_ptr(), nz, ny, nx,
                 float(rdx), float(rdy), stream)
    if err != 0:
        raise RuntimeError(f"advect_scalar_5_3 launch failed: cudaError {err}")
    advect_scalar_5_3.launches += 1
    return out


advect_scalar_5_3.launches = 0
