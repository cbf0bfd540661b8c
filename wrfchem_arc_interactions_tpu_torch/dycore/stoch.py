"""Stochastic physics: SPPT and SKEBS-style perturbations (port of the JAX
package's `dycore/stoch.py`; canonical dyn_em/module_stoch.F).

- SPPT: the physics tendencies of theta, qv, u and v are multiplied by
  (1 + r), r a smooth AR(1)-in-time random pattern, clipped.
- SKEBS: a second pattern acts as a streamfunction whose rotational wind
  increments (u' = -dpsi/dy, v' = +dpsi/dx) join the momentum tendencies.

The white noise is the reference's stateless uint32 hash of the global
(j, i) cell index, the step and a seed (the McICA hash, run in int64 with
each product cut to 32 bits by `mcica._mul32`), so the noise equals the
reference's bit for bit; it is smoothed by five-point diffusion passes
through the halo padding.  The patterns live in the model state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.physics.radiation.mcica import _M32, _hash_u32, _mul32

N_SMOOTH = 8               # five-point diffusion passes (set the length scale)
AR1_TAU_S = 6.0 * 3600.0   # pattern decorrelation time [s]
CLIP = 0.8                 # |r| clip for the SPPT multiplier
_SQRT12 = float(np.sqrt(np.float32(12.0)))


def white_noise(shape: Tuple[int, int], step: int, seed: int = 0,
                device=None, hx: Optional[HaloOps] = None) -> torch.Tensor:
    """(ny, nx) unit-variance float32 noise from a hash of the GLOBAL cell
    index and the step: on a block of `hx`'s mesh the index is offset by
    the block's place, so the noise is the same however the domain is
    decomposed."""
    ny, nx = shape
    jy = torch.arange(ny, dtype=torch.int64, device=device)[:, None]
    ix = torch.arange(nx, dtype=torch.int64, device=device)[None, :]
    if hx is not None and hx.mesh is not None:
        jy = jy + ny * hx.mesh.iy
        ix = ix + nx * hx.mesh.ix
    const = ((int(step) & _M32) * 0xC2B2AE3D + (seed & _M32) * 0x27D4EB2F) & _M32
    h = _hash_u32((_mul32(jy, 0x9E3779B1) + _mul32(ix, 0x85EBCA77) + const) & _M32)
    u = h.to(torch.float32) * (1.0 / 4294967296.0)
    return (u - 0.5) * _SQRT12


def _filter_variance(n: int, a: float = 0.2) -> float:
    """Variance of the n-fold 5-point filter applied to unit iid noise: the
    sum of squares of the n-fold kernel."""
    k = np.zeros((2 * n + 1, 2 * n + 1))
    k[n, n] = 1.0
    one = np.array([[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]])
    for _ in range(n):
        out = np.zeros_like(k)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                w = one[dy + 1, dx + 1]
                if w:
                    out += w * np.roll(np.roll(k, dy, 0), dx, 1)
        k = out
    return float((k ** 2).sum())


def smooth(r: torch.Tensor, hx: HaloOps, n: int = N_SMOOTH) -> torch.Tensor:
    """n passes of the plus-shaped 5-point diffusion filter, renormalised to
    unit variance by the exact n-fold kernel variance (a constant, so no
    global reduction)."""
    a = 0.2
    for _ in range(n):
        rp = hx.pad(r, 1)
        r = ((1.0 - 4.0 * a) * r
             + a * (rp[..., 1:-1, 2:] + rp[..., 1:-1, :-2]
                    + rp[..., 2:, 1:-1] + rp[..., :-2, 1:-1]))
    return r / float(np.sqrt(np.float32(_filter_variance(n, a))))


def evolve_pattern(pattern: torch.Tensor, hx: HaloOps, dt: float, step: int,
                   seed: int = 0) -> torch.Tensor:
    """AR(1) update toward a fresh smoothed noise field."""
    phi = np.exp(np.float32(-dt / AR1_TAU_S))
    amp = np.sqrt(np.maximum(np.float32(1.0) - phi * phi, np.float32(1e-12)))
    fresh = smooth(white_noise(pattern.shape[-2:], step, seed, pattern.device, hx), hx)
    return float(phi) * pattern + float(amp) * fresh


def apply_sppt(tend: Dict[str, torch.Tensor], pattern: torch.Tensor,
               amplitude: float) -> Dict[str, torch.Tensor]:
    """Multiply the theta, qv, u and v tendencies by (1 + r), r clipped."""
    r = torch.clamp(amplitude * pattern, -CLIP, CLIP)
    out = dict(tend)
    for name in ("th", "qv", "u", "v"):
        if name in out:
            out[name] = out[name] * (1.0 + r)[None]
    return out


def skebs_increments(psi_pattern: torch.Tensor, hx: HaloOps, amplitude: float,
                     dx: float, dy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotational wind tendencies of the streamfunction pattern,
    du/dt = -dpsi/dy and dv/dt = +dpsi/dx (barotropic)."""
    psi = amplitude * dx * psi_pattern
    pp = hx.pad(psi, 1)
    du = -(pp[..., 2:, 1:-1] - pp[..., :-2, 1:-1]) / (2.0 * dy)
    dv = (pp[..., 1:-1, 2:] - pp[..., 1:-1, :-2]) / (2.0 * dx)
    return du, dv
