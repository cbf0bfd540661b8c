"""Plain version of the port's fused 5th/3rd-order scalar advection
tendency (the port's `ops/adv_kernel.py`, frozen): the kernel's wrapper is
replaced by its plain version, on every device.
"""

from __future__ import annotations


import torch

from port_bench.reference.wrf.dycore.advection import (
    _stencil_x, _stencil_y, _stencil_z, flux3, flux5,
)
from port_bench.reference.wrf.ops.stencil import win

def advect_scalar_5_3_reference(q_pad, ru_pad, rv_pad, ww, rdnw, rdx: float,
                                rdy: float, m2=None) -> torch.Tensor:
    """Plain PyTorch version: `advection.advect_scalar(..., 5, 3)` with the
    grid reduced to (rdnw, rdx, rdy, m2), in the same operation order."""
    fx = flux5(win(ru_pad, 0, 0, ex=1), *_stencil_x(q_pad))
    fy = flux5(win(rv_pad, 0, 0, ey=1), *_stencil_y(q_pad))
    qm3, qm2, qm1, q0, qp1, qp2 = _stencil_z(win(q_pad, 0, 0), ww.shape[0])
    fz = -flux3(-ww, qm2, qm1, q0, qp1)
    fz[0] = 0.0
    fz[-1] = 0.0
    hdiv = ((fx[..., 1:] - fx[..., :-1]) * rdx
            + (fy[..., 1:, :] - fy[..., :-1, :]) * rdy)
    if m2 is not None:
        hdiv = m2[None] * hdiv
    dfz = fz[1:] - fz[:-1]
    return -(hdiv + dfz * rdnw.reshape(-1, 1, 1))


def advect_scalar_5_3(q_pad, ru_pad, rv_pad, ww, rdnw, rdx: float,
                      rdy: float, m2=None) -> torch.Tensor:
    """The tendency as the port's wrapper returns it, by the plain version."""
    return advect_scalar_5_3_reference(q_pad, ru_pad, rv_pad, ww, rdnw, rdx, rdy, m2)
