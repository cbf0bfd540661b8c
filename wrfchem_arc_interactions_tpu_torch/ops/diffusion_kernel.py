"""Subgrid diffusion of a stack of scalars: CUDA kernel wrapper and its
plain PyTorch version, and the diffusion operators they share with the
momentum and theta terms of `dycore/diffusion.py`.

Replaces no TPU kernel: the JAX package's `dycore/diffusion.py::
diffusion_tendencies` is plain `jnp`.  One pass of the scalars' mixing
(`diffusion_tendencies` cuts the stack into passes) computes, for each
scalar of the slice, the K-weighted horizontal Laplacian (`_hdiff`), plus
the constant-K vertical diffusion when kvdif > 0 (`_vdiff`), plus the
6th-order filter when diff_6th_opt is on (`_filter6`).  In plain PyTorch
that is some 36 operators, each reading and writing the whole slice; the
kernel (``csrc/diffuse_scalars.cu``) reads the padded slice, K and dz^2
once and writes the tendency once, which is its bound (2.31 GB a pass of
18 scalars at config 5's 500x500x60 block, 0.69 ms at 3.35 TB/s).  Each
block marches a tile of one scalar up its levels in registers; the
source's header states the design.  The kernel rounds where the plain
version does (``--fmad=false``): the two are bitwise equal.

`diffuse_scalars` launches the kernel for CUDA tensors and runs
`diffuse_scalars_reference` for CPU tensors; it never falls back from one
to the other.  The plain version takes the dtype it is given (the CPU
tests hold some paths in float64); the kernel takes float32 only.
``diffuse_scalars.launches`` counts kernel launches: one per pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops import build
from wrfchem_arc_interactions_tpu_torch.ops.stencil import PAD, win

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
             + [ctypes.c_int, ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _hdiff(q_pad, k_pad, grid: Grid, pad=3):
    """del . (K del q) horizontal, 2nd order, K at mass points."""
    rdx2 = grid.rdx * grid.rdx
    rdy2 = grid.rdy * grid.rdy
    k_e = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, 1, pad=pad))
    k_w = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, -1, pad=pad))
    k_n = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 1, 0, pad=pad))
    k_s = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, -1, 0, pad=pad))
    q0 = win(q_pad, 0, 0, pad=pad)
    return (rdx2 * (k_e * (win(q_pad, 0, 1, pad=pad) - q0)
                    - k_w * (q0 - win(q_pad, 0, -1, pad=pad)))
            + rdy2 * (k_n * (win(q_pad, 1, 0, pad=pad) - q0)
                      - k_s * (q0 - win(q_pad, -1, 0, pad=pad))))


def _vdiff(q, kv, dz2):
    """Constant-K vertical diffusion d/dz(K dq/dz) on mass levels (z is
    axis -3; leading axes batch)."""
    dq = q[..., 1:, :, :] - q[..., :-1, :, :]
    zero = torch.zeros_like(q[..., :1, :, :])
    dq_up = torch.cat([dq, zero], dim=-3)
    dq_dn = torch.cat([zero, dq], dim=-3)
    return kv * (dq_up - dq_dn) / dz2


def _filter6(q_pad, factor: float, dt: float):
    """6th-order numerical filter in x and y (diff_6th_opt)."""
    wx = [win(q_pad, 0, m) for m in (-3, -2, -1, 0, 1, 2, 3)]
    wy = [win(q_pad, m, 0) for m in (-3, -2, -1, 0, 1, 2, 3)]
    coef = factor / (64.0 * dt)
    sx = (-wx[0] + 6 * wx[1] - 15 * wx[2] + 20 * wx[3] - 15 * wx[4] + 6 * wx[5] - wx[6])
    sy = (-wy[0] + 6 * wy[1] - 15 * wy[2] + 20 * wy[3] - 15 * wy[4] + 6 * wy[5] - wy[6])
    return -coef * (sx + sy)


def diffuse_scalars_reference(sc_pad, k_pad, grid: Grid, dz2=None, kvdif: float = 0.0,
                              filter6: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Plain version: one pass's tendency, `_hdiff`, then `+ _vdiff` with
    `dz2`, then `+ _filter6` with `filter6` = (factor, dt), in that order."""
    out = _hdiff(sc_pad, k_pad, grid)
    if dz2 is not None:
        out = out + _vdiff(win(sc_pad, 0, 0), kvdif, dz2)
    if filter6 is not None:
        out = out + _filter6(sc_pad, *filter6)
    return out


def _check(sc_pad, k_pad, dz2):
    tensors = {"sc_pad": sc_pad, "k_pad": k_pad}
    if dz2 is not None:
        tensors["dz2"] = dz2
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != sc_pad.dtype:
            raise TypeError(f"{name} is {t.dtype}, sc_pad {sc_pad.dtype}")
        if t.device != sc_pad.device:
            raise ValueError(f"{name} is on {t.device}, sc_pad on {sc_pad.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sc_pad.dim() != 4:
        raise ValueError(f"sc_pad must be (nt, nz, ny+6, nx+6), got {tuple(sc_pad.shape)}")
    nt, nz, nyp, nxp = sc_pad.shape
    ny, nx = nyp - 2 * PAD, nxp - 2 * PAD
    if nt < 1 or nz < 1 or ny < 1 or nx < 1:
        raise ValueError(f"empty slice in sc_pad {tuple(sc_pad.shape)}")
    if tuple(k_pad.shape) != (nz, nyp, nxp):
        raise ValueError(f"k_pad must be {(nz, nyp, nxp)}, got {tuple(k_pad.shape)}")
    if dz2 is not None and tuple(dz2.shape) != (nz, ny, nx):
        raise ValueError(f"dz2 must be {(nz, ny, nx)}, got {tuple(dz2.shape)}")
    return nt, nz, ny, nx


def launch(lib: ctypes.CDLL, sc_pad, k_pad, dz2, out, grid: Grid, kvdif: float,
           filter6: Optional[Tuple[float, float]], stream) -> int:
    """Launch kernel library `lib` on checked inputs into `out` on
    `stream`; the scalars as the plain version's Python floats round them
    to float32.  Returns the CUDA error code (0 on success)."""
    fn = lib.diffuse_scalars
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    neg_coef = -(filter6[0] / (64.0 * filter6[1])) if filter6 is not None else 0.0
    return fn(sc_pad.data_ptr(), k_pad.data_ptr(), None if dz2 is None else dz2.data_ptr(),
              out.data_ptr(), *sc_pad.shape[:2], *out.shape[2:],
              float(grid.rdx * grid.rdx), float(grid.rdy * grid.rdy), float(kvdif),
              float(neg_coef), int(filter6 is not None), stream)


def plan(lib: ctypes.CDLL, nt: int, nz: int, ny: int, nx: int, sms: int) -> dict:
    """The grid the kernel library `lib` launches for a slice on `sms` SMs:
    x and y tiles, levels of a chunk, chunks, threads of a block, the
    tile's columns and rows, and blocks in all."""
    fn = lib.diffuse_scalars_plan
    fn.argtypes = _PLAN_ARGTYPES
    fn.restype = None
    out = (ctypes.c_int * 7)()
    fn(nt, nz, ny, nx, sms, out)
    p = dict(zip(("tiles_x", "tiles_y", "kc", "chunks", "threads", "tile_x", "tile_y"), out))
    p["blocks"] = nt * p["tiles_x"] * p["tiles_y"] * p["chunks"]
    return p


def diffuse_scalars(sc_pad, k_pad, grid: Grid, dz2=None, kvdif: float = 0.0,
                    filter6: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Tendency (nt, nz, ny, nx) of one pass's slice: sc_pad (nt, nz,
    ny+6, nx+6) and k_pad (nz, ny+6, nx+6) padded by the halo exchange;
    dz2 (nz, ny, nx) with kvdif for the vertical term, or None without it;
    filter6 = (diff_6th_factor, dt) for the 6th-order filter, or None."""
    nt, nz, ny, nx = _check(sc_pad, k_pad, dz2)
    if sc_pad.device.type == "cpu":
        return diffuse_scalars_reference(sc_pad, k_pad, grid, dz2, kvdif, filter6)
    if sc_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {sc_pad.device}")
    if sc_pad.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {sc_pad.dtype}")
    out = torch.empty((nt, nz, ny, nx), dtype=torch.float32, device=sc_pad.device)
    with torch.cuda.device(sc_pad.device):
        stream = torch.cuda.current_stream(sc_pad.device).cuda_stream
        err = launch(build.load("diffuse_scalars"), sc_pad, k_pad, dz2, out, grid, kvdif,
                     filter6, stream)
    if err != 0:
        raise RuntimeError(f"diffuse_scalars launch failed: cudaError {err}")
    diffuse_scalars.launches += 1
    return out


diffuse_scalars.launches = 0
