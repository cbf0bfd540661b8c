"""Batched tridiagonal (Thomas) solve along the leading (z) axis (port of
the JAX package's `dycore/tridiag.py`).

The reference scans over z with ``lax.scan``; here the scan is a Python
loop over k, each step vectorised over all (ny, nx) columns.  That is
about 2*nz small launches per solve on the GPU — correct, but launch-bound;
a fused column kernel is a candidate for a later change (PERF.md).
"""

from __future__ import annotations

import torch


def thomas(a: torch.Tensor, b: torch.Tensor, cc: torch.Tensor,
           d: torch.Tensor) -> torch.Tensor:
    """Solve a[k] x[k-1] + b[k] x[k] + cc[k] x[k+1] = d[k], k = 0..n-1.

    Inputs are (n, ...) with matching trailing dims; a[0] and cc[n-1] are
    ignored.  Same arithmetic as the reference's two scans.
    """
    n = d.shape[0]
    cp_km1 = torch.zeros_like(d[0])
    dp_km1 = torch.zeros_like(d[0])
    cps, dps = [], []
    for k in range(n):
        ak, bk, ck, dk = a[k], b[k], cc[k], d[k]
        denom = bk - ak * cp_km1
        inv = 1.0 / denom
        cp_km1 = ck * inv
        dp_km1 = (dk - ak * dp_km1) * inv
        cps.append(cp_km1)
        dps.append(dp_km1)
    x = [None] * n
    x_kp1 = torch.zeros_like(d[0])
    for k in range(n - 1, -1, -1):
        x_kp1 = dps[k] - cps[k] * x_kp1
        x[k] = x_kp1
    return torch.stack(x, dim=0)
