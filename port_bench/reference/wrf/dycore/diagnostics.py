"""Stage diagnostics: pressure, specific volume, sound speed from the
prognostic state (port of the JAX package's `dycore/diagnostics.py`; the
calc_p_rho_phi equivalent)."""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference.wrf.grid import Grid
from port_bench.reference.wrf.registry.state import State
from port_bench.reference.wrf.utils import constants as c


@dataclasses.dataclass(frozen=True)
class Diag:
    mu_full: torch.Tensor    # (ny,nx)    mu_bar + mu'
    theta: torch.Tensor      # (nz,ny,nx) full dry potential temperature
    theta_m: torch.Tensor    # (nz,ny,nx) moist potential temperature
    alpha_d: torch.Tensor    # (nz,ny,nx) dry inverse density
    eps_ratio: torch.Tensor  # (nz,ny,nx) alpha/alpha_d = 1/(1+sum q)
    p_full: torch.Tensor     # (nz,ny,nx) full pressure
    p_pert: torch.Tensor     # (nz,ny,nx) p - pb
    al_pert: torch.Tensor    # (nz,ny,nx) alpha_d - alb
    cs2: torch.Tensor        # (nz,ny,nx) sound speed squared


def moist_sums(state: State, moist: tuple):
    """(qv, sum of all hydrometeor+vapor mass mixing ratios)."""
    qv = state.get("qv")
    if qv is None:
        zeros = torch.zeros_like(state["t"])
        return zeros, zeros
    qtot = torch.zeros_like(qv)
    for name in moist:
        if name.startswith("q") and name != "qgv":
            qtot = qtot + state[name]
    return qv, qtot


def diagnose(state: State, grid: Grid, moist: tuple) -> Diag:
    mu_full = grid.mub + state["mu"]
    theta = state["t"] + c.T0
    qv, qtot = moist_sums(state, moist)
    theta_m = theta * (1.0 + c.RVOVRD * qv)
    ph_full = grid.phb + state["ph"]
    rdnw = grid.rdnw.reshape(-1, 1, 1)
    alpha_d = -(ph_full[1:] - ph_full[:-1]) * rdnw / mu_full[None]
    eps_ratio = 1.0 / (1.0 + qtot)
    p_full = c.P0 * (c.R_D * theta_m / (c.P0 * alpha_d)) ** c.GAMMA
    return Diag(
        mu_full=mu_full,
        theta=theta,
        theta_m=theta_m,
        alpha_d=alpha_d,
        eps_ratio=eps_ratio,
        p_full=p_full,
        p_pert=p_full - grid.pb,
        al_pert=alpha_d - grid.alb,
        cs2=c.GAMMA * p_full * alpha_d,
    )


def ddz_center(p: torch.Tensor, znu: torch.Tensor) -> torch.Tensor:
    """d(p)/d(eta) at mass levels (central interior, one-sided ends)."""
    z = znu.reshape(-1, 1, 1)
    interior = (p[2:] - p[:-2]) / (z[2:] - z[:-2])
    lo = (p[1:2] - p[0:1]) / (z[1:2] - z[0:1])
    hi = (p[-1:] - p[-2:-1]) / (z[-1:] - z[-2:-1])
    return torch.cat([lo, interior, hi], dim=0)


def ddz_faces(p: torch.Tensor, grid: Grid, top_value: float = 0.0) -> torch.Tensor:
    """d(p)/d(eta) at w levels (k=0..nz) from mass-level p; the top uses
    p'(eta=0) = top_value."""
    interior = (p[1:] - p[:-1]) * grid.rdn[1:].reshape(-1, 1, 1)
    lo = interior[0:1]
    rdn_top = (-1.0 / grid.znu[-1]).reshape(1, 1, 1)
    hi = (top_value - p[-1:]) * rdn_top
    return torch.cat([lo, interior, hi], dim=0)
