"""Fused multi-tracer RK-stage scalar update: CUDA kernel wrapper and its
plain PyTorch version.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_adv_multi.py::
advect_tracers_fused``.  For a stack of nt tracers it computes one RK
stage's update, as the reference's scan body over stacked tracers does
(`dycore/solve.py`): 5th/3rd-order fluxes, optionally the positive-definite
limiter (`advection.pd_limit`), the flux divergence, ``+ mu_full * pt``
when a tendency stack is given, ``q_new = (phi_old + dts * tend) /
mu_new`` and optionally ``max(q_new, 0)``.  The tendency term is the
config-3 physics tendency (diffusion) that every scalar carries; the
limiter must see phi_old without it.

The kernel (``csrc/advect_tracers.cu``) is bound by memory on paper (~0.39 GB
per call at nt = 47 and 100x100x50, 0.12 ms at 3.35 TB/s); what costs time
on the card is the instructions around the arithmetic.  So a block owns a
tile of rows over the whole x row of one tracer and marches in z: planes of
q, ru, rv (and r_hi) come by asynchronous copy into rings in shared memory,
each thread owns a few fixed slots of the tile, and each face flux is
computed once.  The limiter takes two grids (`GRIDS_LIMITED`): both form the
low-order factor r_lo on the chip, the first writes the antidiffusive factor
r_hi, the second reads it and writes the update.  Without the limiter one
grid (`GRIDS_PLAIN`) does it all.  The source's header states the design in
full.

A tile spans the x row, so the row's width is limited by a block's shared
memory (about 450 cells at 2 rows per tile); a wider row raises.

`advect_tracers` launches the kernel for CUDA tensors and runs
`advect_tracers_reference` for CPU tensors; it never falls back from one to
the other.  ``advect_tracers.launches`` counts the grids launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
from wrfchem_arc_interactions_tpu_torch.dycore import advection as adv
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops import build
from wrfchem_arc_interactions_tpu_torch.ops.stencil import PAD
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps

GRIDS_PLAIN = 1          # grids of one call without the limiter
GRIDS_LIMITED = 2        # ... with it: the r_hi grid and the update grid
_ROW_TOO_WIDE = -1       # the C function's code for an x row no tile can hold
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BC_CODE = {BCKind.PERIODIC: 0, BCKind.OPEN: 1, BCKind.SYMMETRIC: 2}


def advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                             grid: Grid, hx: HaloOps, dts: float,
                             pt: Optional[torch.Tensor] = None, pd: bool = False,
                             clip: bool = False) -> torch.Tensor:
    """Plain version: the stacked (nt, ...) chain of `dycore.advection` in
    the operation order of the reference's scan body."""
    fx, fy, fz = adv.scalar_fluxes(q_pad, ru_pad, rv_pad, ww, 5, 3)
    if pd:
        fx, fy, fz = adv.pd_limit(q_pad, phi_old, fx, fy, fz, ru_pad, rv_pad, ww,
                                  dts, grid, hx)
    tend = adv.flux_div(fx, fy, fz, grid)
    if pt is not None:
        tend = tend + mu_full[None, None] * pt
    qn = (phi_old + dts * tend) / mu_new[None, None]
    if clip:
        qn = torch.clamp(qn, min=0.0)
    return qn


def _check(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new, rdnw, pt, hx):
    tensors = {"q_pad": q_pad, "phi_old": phi_old, "ru_pad": ru_pad,
               "rv_pad": rv_pad, "ww": ww, "mu_full": mu_full, "mu_new": mu_new,
               "rdnw": rdnw}
    if pt is not None:
        tensors["pt"] = pt
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q_pad.device:
            raise ValueError(f"{name} is on {t.device}, q_pad on {q_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_pad.dim() != 4:
        raise ValueError(f"q_pad must be (nt, nz, ny+6, nx+6), got {tuple(q_pad.shape)}")
    nt, nz, nyp, nxp = q_pad.shape
    ny, nx = nyp - 2 * PAD, nxp - 2 * PAD
    if min(nt, nz, ny, nx) < 1:
        raise ValueError(f"empty q_pad {tuple(q_pad.shape)}")
    want = {"phi_old": (nt, nz, ny, nx), "ru_pad": (nz, nyp, nxp),
            "rv_pad": (nz, nyp, nxp), "ww": (nz + 1, ny, nx), "mu_full": (ny, nx),
            "mu_new": (ny, nx), "rdnw": (nz,), "pt": (nt, nz, ny, nx)}
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    for bc, n in ((hx.bc_x, nx), (hx.bc_y, ny)):
        if bc not in _BC_CODE:
            raise ValueError(f"unsupported lateral boundary {bc}")
        if bc == BCKind.SYMMETRIC and n < 2:
            raise ValueError("a symmetric boundary needs at least 2 cells")
    return nt, nz, ny, nx


def advect_tracers(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                   grid: Grid, hx: HaloOps, dts: float,
                   pt: Optional[torch.Tensor] = None, pd: bool = False,
                   clip: bool = False) -> torch.Tensor:
    """New stage values (nt, nz, ny, nx) of a tracer stack.

    q_pad (nt, nz, ny+6, nx+6): the stage tracers padded by `hx`;
    phi_old (nt, nz, ny, nx): the coupled step-start tracers mu_0 q_0;
    ru_pad/rv_pad (nz, ny+6, nx+6), ww (nz+1, ny, nx): the mass fluxes;
    mu_full/mu_new (ny, nx): the stage and the new column mass; pt
    (nt, nz, ny, nx) or None: physics tendencies (uncoupled).  The model
    passes clip = pd; `clip` without `pd` is the monotonic limiter's
    pairing, which `utils.support.check_config` still refuses."""
    if grid.has_msf:
        raise ValueError("advect_tracers takes a flat grid (no map factors)")
    nt, nz, ny, nx = _check(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full, mu_new,
                            grid.rdnw, pt, hx)
    if q_pad.device.type == "cpu":
        return advect_tracers_reference(q_pad, phi_old, ru_pad, rv_pad, ww, mu_full,
                                        mu_new, grid, hx, dts, pt, pd, clip)
    if q_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {q_pad.device}")
    fn = build.load("advect_tracers").advect_tracers
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((nt, nz, ny, nx), dtype=torch.float32, device=q_pad.device)
    r_hi = torch.empty_like(out) if pd else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q_pad.device):
        stream = torch.cuda.current_stream(q_pad.device).cuda_stream
        err = fn(q_pad.data_ptr(), phi_old.data_ptr(), ptr(pt), ru_pad.data_ptr(),
                 rv_pad.data_ptr(), ww.data_ptr(), mu_full.data_ptr(),
                 mu_new.data_ptr(), grid.rdnw.data_ptr(), ptr(r_hi), out.data_ptr(),
                 nt, nz, ny, nx, float(grid.rdx), float(grid.rdy),
                 float(dts), int(pd), int(clip), _BC_CODE[hx.bc_x], _BC_CODE[hx.bc_y],
                 stream)
    if err == _ROW_TOO_WIDE:
        raise ValueError(f"nx = {nx} is too wide for a tile in shared memory")
    if err != 0:
        raise RuntimeError(f"advect_tracers launch failed: cudaError {err}")
    advect_tracers.launches += GRIDS_LIMITED if pd else GRIDS_PLAIN
    return out


advect_tracers.launches = 0
