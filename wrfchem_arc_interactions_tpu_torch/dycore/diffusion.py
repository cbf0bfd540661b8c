"""Subgrid turbulence / diffusion (port of the JAX package's
`dycore/diffusion.py`; canonical module_diffusion_em.F).

Ported: the 2D Smagorinsky closure on coordinate surfaces plus background
khdif, and the constant-K vertical diffusion (kvdif).  The TKE closure and
the 6th-order filter come with a later slice (`utils.support` refuses
them).  Tendencies are computed on uncoupled fields and returned as a
phys_tend dict ({u, v, th, <scalars>}).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.stencil import win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps

CS_SMAG = 0.25


def smagorinsky_k(u_pad, v_pad, grid: Grid, cfg: Config):
    """Horizontal eddy viscosity K_h at mass points (2D deformation)."""
    rdx, rdy = grid.rdx, grid.rdy
    dudx = (win(u_pad, 0, 1) - win(u_pad, 0, 0)) * rdx
    dvdy = (win(v_pad, 1, 0) - win(v_pad, 0, 0)) * rdy
    dudy_c = (win(u_pad, 0, 0) - win(u_pad, -1, 0)) * rdy
    dvdx_c = (win(v_pad, 0, 0) - win(v_pad, 0, -1)) * rdx
    d12 = dudy_c + dvdx_c
    defor2 = (dudx - dvdy) ** 2 + d12 ** 2
    delta2 = grid.dx * grid.dy
    return (CS_SMAG ** 2) * delta2 * torch.sqrt(torch.clamp(defor2, min=0.0)) \
        + cfg.dynamics.khdif


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
    """Constant-K vertical diffusion d/dz(K dq/dz) on mass levels."""
    dq_up = torch.cat([q[1:] - q[:-1], torch.zeros_like(q[:1])], dim=0)
    dq_dn = torch.cat([torch.zeros_like(q[:1]), q[1:] - q[:-1]], dim=0)
    return kv * (dq_up - dq_dn) / dz2


def diffusion_tendencies(state, grid: Grid, cfg: Config, hx: HaloOps,
                         scalars: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """phys_tend contributions from subgrid mixing (uncoupled rates)."""
    dyn = cfg.dynamics
    fields = {"u": state["u"], "v": state["v"], "t": state["t"]}
    for q in scalars:
        fields[q] = state[q]
    g = hx.pad_many(fields, 3)
    k_h = smagorinsky_k(g["u"], g["v"], grid, cfg)
    k_pad = hx.pad(k_h, 3)

    out: Dict[str, torch.Tensor] = {}
    out["u"] = _hdiff(g["u"], k_pad, grid)
    out["v"] = _hdiff(g["v"], k_pad, grid)
    out["th"] = _hdiff(g["t"], k_pad, grid)
    for q in scalars:
        out[q] = _hdiff(g[q], k_pad, grid)

    if dyn.kvdif > 0.0:
        ph_full = grid.phb + state["ph"]
        dz = (ph_full[1:] - ph_full[:-1]) / 9.81
        dz2 = dz * dz
        out["u"] = out["u"] + _vdiff(state["u"], dyn.kvdif, dz2)
        out["v"] = out["v"] + _vdiff(state["v"], dyn.kvdif, dz2)
        out["th"] = out["th"] + _vdiff(state["t"], dyn.kvdif, dz2)
        for q in scalars:
            out[q] = out[q] + _vdiff(state[q], dyn.kvdif, dz2)
    return out
