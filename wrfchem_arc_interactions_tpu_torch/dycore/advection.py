"""Finite-volume flux advection (2nd-6th order, upwind-biased odd orders,
and WENO5) on the Arakawa-C grid, the positive-definite flux limiter and the
monotonic (FCT) limiter (port of the JAX package's `dycore/advection.py`;
canonical dyn_em/module_advect_em.F).

The arithmetic, including the order of every operation, is a transcription
of the reference so that the two agree to float32 rounding.  Fields are
(nz, ny, nx); horizontal stencils consume PAD(=3)-padded tensors and emit
face tensors with one extra point, so the flux divergence telescopes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.stencil import avg_z_centers_to_faces, win


# Face-flux formulas. `qm1` is the cell just upwind of the face for vel > 0,
# `q0` just downwind.

def flux1(vel, qm1, q0):
    return vel * torch.where(vel > 0, qm1, q0)


def flux2(vel, qm1, q0):
    return vel * 0.5 * (q0 + qm1)


def flux4(vel, qm2, qm1, q0, qp1):
    return vel * (7.0 * (q0 + qm1) - (qp1 + qm2)) * (1.0 / 12.0)


def flux3(vel, qm2, qm1, q0, qp1):
    return flux4(vel, qm2, qm1, q0, qp1) - torch.abs(vel) * (
        3.0 * (q0 - qm1) - (qp1 - qm2)) * (1.0 / 12.0)


def flux6(vel, qm3, qm2, qm1, q0, qp1, qp2):
    return vel * (37.0 * (q0 + qm1) - 8.0 * (qp1 + qm2) + (qp2 + qm3)) * (1.0 / 60.0)


def flux5(vel, qm3, qm2, qm1, q0, qp1, qp2):
    return flux6(vel, qm3, qm2, qm1, q0, qp1, qp2) - torch.abs(vel) * (
        10.0 * (q0 - qm1) - 5.0 * (qp1 - qm2) + (qp2 - qm3)) * (1.0 / 60.0)


def _weno5_face(a, b, c, d, e):
    """WENO5-JS face value from the five upwind-ordered cells a..e
    (q_{f-3}..q_{f+1} for flow toward +).  The smoothness indicators are
    normalised by their sum, so the weights do not depend on the field's
    scale or offset, and the weights are normalised before the candidate
    sum (w * p overflows float32 where every beta vanishes)."""
    beta0 = (13.0 / 12.0) * (a - 2.0 * b + c) ** 2 + 0.25 * (a - 4.0 * b + 3.0 * c) ** 2
    beta1 = (13.0 / 12.0) * (b - 2.0 * c + d) ** 2 + 0.25 * (b - d) ** 2
    beta2 = (13.0 / 12.0) * (c - 2.0 * d + e) ** 2 + 0.25 * (3.0 * c - 4.0 * d + e) ** 2
    scale = beta0 + beta1 + beta2 + 1e-30
    eps = 1e-8
    w0 = 0.1 / (eps + beta0 / scale) ** 2
    w1 = 0.6 / (eps + beta1 / scale) ** 2
    w2 = 0.3 / (eps + beta2 / scale) ** 2
    wsum = w0 + w1 + w2
    p0 = (2.0 * a - 7.0 * b + 11.0 * c) * (1.0 / 6.0)
    p1 = (-b + 5.0 * c + 2.0 * d) * (1.0 / 6.0)
    p2 = (2.0 * c + 5.0 * d - e) * (1.0 / 6.0)
    return (w0 / wsum) * p0 + (w1 / wsum) * p1 + (w2 / wsum) * p2


def flux_weno5(vel, qm3, qm2, qm1, q0, qp1, qp2):
    """5th-order WENO flux: both upwind orientations, selected by the sign
    of the face velocity."""
    q_pos = _weno5_face(qm3, qm2, qm1, q0, qp1)
    q_neg = _weno5_face(qp2, qp1, q0, qm1, qm2)
    return vel * torch.where(vel > 0, q_pos, q_neg)


def _hflux(vel, stencil, order: int):
    """Order-`order` flux of a 6-point stencil tuple (qm3..qp2)."""
    qm3, qm2, qm1, q0, qp1, qp2 = stencil
    if order == 1:
        return flux1(vel, qm1, q0)
    if order == 2:
        return flux2(vel, qm1, q0)
    if order == 3:
        return flux3(vel, qm2, qm1, q0, qp1)
    if order == 4:
        return flux4(vel, qm2, qm1, q0, qp1)
    if order == 5:
        return flux5(vel, qm3, qm2, qm1, q0, qp1, qp2)
    if order == 6:
        return flux6(vel, qm3, qm2, qm1, q0, qp1, qp2)
    if order == 7:   # AdvOrder.WENO5
        return flux_weno5(vel, qm3, qm2, qm1, q0, qp1, qp2)
    raise ValueError(order)


def _stencil_x(q_pad, ex=1, dy=0, ey=0):
    """6-point x stencil around west faces: face f sits between cells f-1, f."""
    return tuple(win(q_pad, dy, m, ey=ey, ex=ex) for m in (-3, -2, -1, 0, 1, 2))


def _stencil_y(q_pad, ey=1, dx=0, ex=0):
    return tuple(win(q_pad, m, dx, ey=ey, ex=ex) for m in (-3, -2, -1, 0, 1, 2))


def _zsl(q, lo, hi):
    """Slice the z axis (axis -3)."""
    return q[..., lo:hi, :, :]


def _zpad(q, n=2):
    """Edge-replicate ghost levels above/below along the z (-3) axis."""
    nz = q.shape[-3]
    top = _zsl(q, nz - 1, nz).repeat_interleave(n, dim=-3)
    bot = _zsl(q, 0, 1).repeat_interleave(n, dim=-3)
    return torch.cat([bot, q, top], dim=-3)


def _stencil_z(q, nfaces: int):
    """Stencil tuple for vertical faces k = 0..nfaces-1, face k between
    levels k-1 and k of `q`."""
    qe = _zpad(q, 3)
    return tuple(_zsl(qe, 3 + m, 3 + m + nfaces) for m in (-3, -2, -1, 0, 1, 2))


def vflux(vel_faces, q, order: int):
    """Vertical fluxes at the faces of the levels of q, face k between q[k-1]
    and q[k].

    Sign of the upwinding: eta decreases with k (rdnw < 0), so the
    index-space transport direction is -sign(ww).  Evaluating the shared
    formulas with -ww and negating selects the upwind cell and keeps the
    odd-order dissipation dissipative (feeding ww directly turns it into
    anti-diffusion, which blows up strong updrafts)."""
    return -_hflux(-vel_faces, _stencil_z(q, vel_faces.shape[-3]), order)


def flux_div(fx, fy, fz, grid: Grid, m_h=None) -> torch.Tensor:
    """-(m_h (d/dx Fx + d/dy Fy) + d/eta Fz): the coupled-scalar tendency.
    fx: (nz, ny, nx+1), fy: (nz, ny+1, nx), fz: (nz+1, ny, nx)."""
    rdnw = grid.rdnw.reshape(-1, 1, 1)
    hdiv = ((fx[..., 1:] - fx[..., :-1]) * grid.rdx
            + (fy[..., 1:, :] - fy[..., :-1, :]) * grid.rdy)
    if m_h is not None:
        hdiv = m_h[None] * hdiv
    dfz = _zsl(fz, 1, fz.shape[-3]) - _zsl(fz, 0, fz.shape[-3] - 1)
    return -(hdiv + dfz * rdnw)


def scalar_fluxes(q_pad, ru_pad, rv_pad, ww, h_order: int, v_order: int):
    """Fluxes of an uncoupled mass-point scalar.  q_pad/ru_pad/rv_pad are
    PAD-padded; ww is the unpadded (nz+1, ny, nx) omega."""
    fx = _hflux(win(ru_pad, 0, 0, ex=1), _stencil_x(q_pad), h_order)
    fy = _hflux(win(rv_pad, 0, 0, ey=1), _stencil_y(q_pad), h_order)
    fz = vflux(ww, win(q_pad, 0, 0), v_order)
    # omega vanishes at the rigid eta boundaries; enforce exactly (fz is
    # freshly computed, so writing into it is safe)
    fz[..., 0, :, :] = 0.0
    fz[..., -1, :, :] = 0.0
    return fx, fy, fz


def advect_scalar(q_pad, ru_pad, rv_pad, ww, grid: Grid,
                  h_order: int = 5, v_order: int = 3) -> torch.Tensor:
    fx, fy, fz = scalar_fluxes(q_pad, ru_pad, rv_pad, ww, h_order, v_order)
    m2 = grid.msft * grid.msft if grid.has_msf else None
    return flux_div(fx, fy, fz, grid, m_h=m2)


# ---------------------------------------------------------------------------
# Momentum advection: control volumes centred on the staggered points.
# ---------------------------------------------------------------------------

def advect_u(u_pad, ru_pad, rv_pad, ww_pad, grid: Grid,
             h_order: int = 5, v_order: int = 3) -> torch.Tensor:
    """Tendency of coupled U at u faces.  Horizontal args PAD-padded;
    ww_pad is (nz+1, ny+2P, nx+2P)."""
    vel_c = 0.5 * (win(ru_pad, 0, -1, ex=1) + win(ru_pad, 0, 0, ex=1))
    fx = _hflux(vel_c, _stencil_x(u_pad), h_order)
    vel_k = 0.5 * (win(rv_pad, 0, -1, ey=1) + win(rv_pad, 0, 0, ey=1))
    fy = _hflux(vel_k, _stencil_y(u_pad), h_order)
    ww_u = 0.5 * (win(ww_pad, 0, -1) + win(ww_pad, 0, 0))
    if grid.has_msf:
        ww_u = ww_u / grid.msfu[None]
    fz = vflux(ww_u, win(u_pad, 0, 0), v_order)
    fz[0] = 0.0
    fz[-1] = 0.0
    return flux_div(fx, fy, fz, grid, m_h=grid.msfu if grid.has_msf else None)


def advect_v(v_pad, ru_pad, rv_pad, ww_pad, grid: Grid,
             h_order: int = 5, v_order: int = 3) -> torch.Tensor:
    vel_k = 0.5 * (win(ru_pad, -1, 0, ex=1) + win(ru_pad, 0, 0, ex=1))
    fx = _hflux(vel_k, _stencil_x(v_pad), h_order)
    vel_c = 0.5 * (win(rv_pad, -1, 0, ey=1) + win(rv_pad, 0, 0, ey=1))
    fy = _hflux(vel_c, _stencil_y(v_pad), h_order)
    ww_v = 0.5 * (win(ww_pad, -1, 0) + win(ww_pad, 0, 0))
    if grid.has_msf:
        ww_v = ww_v / grid.msfv[None]
    fz = vflux(ww_v, win(v_pad, 0, 0), v_order)
    fz[0] = 0.0
    fz[-1] = 0.0
    return flux_div(fx, fy, fz, grid, m_h=grid.msfv if grid.has_msf else None)


def advect_w(w_pad, ru_pad, rv_pad, ww, grid: Grid,
             h_order: int = 5, v_order: int = 3) -> torch.Tensor:
    """Tendency of coupled W at w levels (nz+1); the surface level is
    boundary-determined (zeroed by the caller)."""
    fnm, fnp = grid.fnm, grid.fnp
    ru_w = avg_z_centers_to_faces(win(ru_pad, 0, 0, ex=1), fnm, fnp)
    fx = _hflux(ru_w, _stencil_x(w_pad), h_order)
    rv_w = avg_z_centers_to_faces(win(rv_pad, 0, 0, ey=1), fnm, fnp)
    fy = _hflux(rv_w, _stencil_y(w_pad), h_order)
    om_c = 0.5 * (ww[:-1] + ww[1:])
    if grid.has_msf:
        om_c = om_c / grid.msft[None]
    w_int = win(w_pad, 0, 0)
    fz_c = vflux(om_c, w_int[1:], v_order)          # faces between w levels k, k+1
    zeros = torch.zeros_like(fz_c[:1])
    fz_lo = torch.cat([zeros, fz_c], dim=0)          # below level k
    fz_hi = torch.cat([fz_c, zeros], dim=0)          # above level k
    rdn_w = torch.cat([grid.rdn[1:], -1.0 / grid.znu[-1:]]).reshape(-1, 1, 1)
    dfz = torch.cat([
        torch.zeros_like(fz_c[:1]),
        (fz_hi[1:] - fz_lo[1:]) * rdn_w,
    ], dim=0)
    hdiv = ((fx[:, :, 1:] - fx[:, :, :-1]) * grid.rdx
            + (fy[:, 1:, :] - fy[:, :-1, :]) * grid.rdy)
    if grid.has_msf:
        hdiv = grid.msft[None] * hdiv
    return -hdiv - dfz


# ---------------------------------------------------------------------------
# Positive-definite limiter (Skamarock 2006; canonical advect_scalar_pd)
# ---------------------------------------------------------------------------

def limit_low_order(phi_old, lx, ly, lz, dt, grid: Grid, hx):
    """Donor-cell renormalisation of the first-order upwind fluxes so the
    transported solution stays non-negative even where the summed outgoing
    Courant number exceeds 1; exactly conservative (each face is scaled
    once, by its donor's factor)."""
    rdnw = grid.rdnw.reshape(-1, 1, 1)
    m2 = (grid.msft * grid.msft)[None] if grid.has_msf else 1.0
    nzf = lz.shape[-3]
    out_x = torch.clamp(lx[..., 1:], min=0.0) - torch.clamp(lx[..., :-1], max=0.0)
    out_y = torch.clamp(ly[..., 1:, :], min=0.0) - torch.clamp(ly[..., :-1, :], max=0.0)
    up_c = -_zsl(lz, 1, nzf) * rdnw
    lo_c = _zsl(lz, 0, nzf - 1) * rdnw
    out_z = torch.clamp(-up_c, min=0.0) + torch.clamp(-lo_c, min=0.0)
    p_out = dt * (m2 * (out_x * grid.rdx + out_y * grid.rdy) + out_z)
    r = torch.where(p_out > 0.0,
                    torch.clamp(torch.clamp(phi_old, min=0.0)
                                / torch.clamp(p_out, min=1e-30), max=1.0), 1.0)
    r_pad = hx.pad(r, 1)

    def rw(dy, dx, ey=0, ex=0):
        return win(r_pad, dy, dx, ey=ey, ex=ex, pad=1)

    lx_s = lx * torch.where(lx > 0, rw(0, -1, ex=1), rw(0, 0, ex=1))
    ly_s = ly * torch.where(ly > 0, rw(-1, 0, ey=1), rw(0, 0, ey=1))
    r_ze = _zpad(r, 1)
    r_lo, r_hi = _zsl(r_ze, 0, nzf), _zsl(r_ze, 1, nzf + 1)
    # positive lz transports downward, draining the upper cell k
    lz_s = lz * torch.where(lz > 0, r_hi, r_lo)
    return lx_s, ly_s, lz_s


def pd_limit(q_pad, phi_old, fx, fy, fz, ru_pad, rv_pad, ww,
             dt: float, grid: Grid, hx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Renormalise high-order fluxes so the coupled scalar stays >= 0.
    phi_old = mu^t * q^t (coupled, interior).  Returns limited fluxes."""
    q_int = win(q_pad, 0, 0)
    lx = flux1(win(ru_pad, 0, 0, ex=1), win(q_pad, 0, -1, ex=1), win(q_pad, 0, 0, ex=1))
    ly = flux1(win(rv_pad, 0, 0, ey=1), win(q_pad, -1, 0, ey=1), win(q_pad, 0, 0, ey=1))
    lz = vflux(ww, q_int, 1)
    lz[..., 0, :, :] = 0.0
    lz[..., -1, :, :] = 0.0
    lx, ly, lz = limit_low_order(phi_old, lx, ly, lz, dt, grid, hx)
    m2 = (grid.msft * grid.msft) if grid.has_msf else None
    m2v = m2[None] if m2 is not None else 1.0
    phi_td = phi_old + dt * flux_div(lx, ly, lz, grid, m_h=m2)
    phi_td = torch.clamp(phi_td, min=0.0)
    # antidiffusive fluxes
    ax, ay, az = fx - lx, fy - ly, fz - lz
    rdnw = grid.rdnw.reshape(-1, 1, 1)
    nzf = az.shape[-3]
    out_x = torch.clamp(ax[..., 1:], min=0.0) - torch.clamp(ax[..., :-1], max=0.0)
    out_y = torch.clamp(ay[..., 1:, :], min=0.0) - torch.clamp(ay[..., :-1, :], max=0.0)
    up_c = -_zsl(az, 1, nzf) * rdnw
    lo_c = _zsl(az, 0, nzf - 1) * rdnw
    out_z = torch.clamp(-up_c, min=0.0) + torch.clamp(-lo_c, min=0.0)
    p_out = dt * (m2v * (out_x * grid.rdx + out_y * grid.rdy) + out_z)
    r = torch.where(p_out > 0.0,
                    torch.clamp(phi_td / torch.clamp(p_out, min=1e-30), max=1.0), 1.0)
    r_pad = hx.pad(r, 1)

    def rw(dy, dx, ey=0, ex=0):
        return win(r_pad, dy, dx, ey=ey, ex=ex, pad=1)

    # donor-cell scaling: a face's antidiffusive flux is limited by the cell
    # it drains
    ax_l = ax * torch.where(ax > 0, rw(0, -1, ex=1), rw(0, 0, ex=1))
    ay_l = ay * torch.where(ay > 0, rw(-1, 0, ey=1), rw(0, 0, ey=1))
    r_ze = _zpad(r, 1)
    r_lo = _zsl(r_ze, 0, nzf)       # level k-1 for face k
    r_hi = _zsl(r_ze, 1, nzf + 1)   # level k
    # eta increases downward: positive az at face k drains the upper cell k
    az_l = az * torch.where(az > 0, r_hi, r_lo)
    return lx + ax_l, ly + ay_l, lz + az_l


# ---------------------------------------------------------------------------
# Monotonic (FCT / Zalesak) limiter (canonical advect_scalar_mono)
# ---------------------------------------------------------------------------

def mono_limit(q_pad, phi_old, mu_new, fx, fy, fz, ru_pad, rv_pad, ww,
               dt: float, grid: Grid, hx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zalesak flux-corrected transport: the new coupled scalar stays within
    the min/max of the old field and of the low-order solution over each
    cell's 7-point neighbourhood (no new extrema, and positive).  The bounds
    are in coupled units Phi = mu q with the new column mass `mu_new`
    (ny, nx).  Leading axes before (z, y, x) batch, so one call limits a
    stack of scalars."""
    q_int = win(q_pad, 0, 0)
    lx = flux1(win(ru_pad, 0, 0, ex=1), win(q_pad, 0, -1, ex=1), win(q_pad, 0, 0, ex=1))
    ly = flux1(win(rv_pad, 0, 0, ey=1), win(q_pad, -1, 0, ey=1), win(q_pad, 0, 0, ey=1))
    lz = vflux(ww, q_int, 1)
    lz[..., 0, :, :] = 0.0
    lz[..., -1, :, :] = 0.0
    # a low-order solution that is positive by construction
    lx, ly, lz = limit_low_order(phi_old, lx, ly, lz, dt, grid, hx)
    m2 = (grid.msft * grid.msft) if grid.has_msf else None
    m2v = m2[None] if m2 is not None else 1.0
    phi_td = phi_old + dt * flux_div(lx, ly, lz, grid, m_h=m2)

    # local bounds from the 7-point neighbourhood of q (old) and q_td
    q_td = phi_td / mu_new[None]
    qtd_pad = hx.pad(q_td, 1)
    nz = q_int.shape[-3]
    neigh = [win(q_pad, 0, 1), win(q_pad, 0, -1), win(q_pad, 1, 0), win(q_pad, -1, 0),
             win(qtd_pad, 0, 0, pad=1), win(qtd_pad, 0, 1, pad=1),
             win(qtd_pad, 0, -1, pad=1), win(qtd_pad, 1, 0, pad=1),
             win(qtd_pad, -1, 0, pad=1),
             torch.cat([_zsl(q_int, 0, 1), _zsl(q_int, 0, nz - 1)], dim=-3),
             torch.cat([_zsl(q_int, 1, nz), _zsl(q_int, nz - 1, nz)], dim=-3)]
    q_max = q_int
    q_min = q_int
    for n_ in neigh:
        q_max = torch.maximum(q_max, n_)
        q_min = torch.minimum(q_min, n_)
    phi_max = q_max * mu_new[None]
    phi_min = torch.clamp(q_min, min=0.0) * mu_new[None]

    ax, ay, az = fx - lx, fy - ly, fz - lz
    rdnw = grid.rdnw.reshape(-1, 1, 1)
    nzf = az.shape[-3]
    # incoming / outgoing antidiffusive sums (in Phi units over dt)
    in_x = torch.clamp(-ax[..., 1:], min=0.0) + torch.clamp(ax[..., :-1], min=0.0)
    out_x = torch.clamp(ax[..., 1:], min=0.0) + torch.clamp(-ax[..., :-1], min=0.0)
    in_y = torch.clamp(-ay[..., 1:, :], min=0.0) + torch.clamp(ay[..., :-1, :], min=0.0)
    out_y = torch.clamp(ay[..., 1:, :], min=0.0) + torch.clamp(-ay[..., :-1, :], min=0.0)
    up_c = -_zsl(az, 1, nzf) * rdnw
    lo_c = _zsl(az, 0, nzf - 1) * rdnw
    in_z = torch.clamp(up_c, min=0.0) + torch.clamp(lo_c, min=0.0)
    p_in = dt * (m2v * (in_x * grid.rdx + in_y * grid.rdy) + in_z)
    out_z = torch.clamp(-up_c, min=0.0) + torch.clamp(-lo_c, min=0.0)
    p_out = dt * (m2v * (out_x * grid.rdx + out_y * grid.rdy) + out_z)
    r_plus = torch.where(p_in > 0.0,
                         torch.clamp((phi_max - phi_td) / torch.clamp(p_in, min=1e-30),
                                     max=1.0), 1.0)
    r_minus = torch.where(p_out > 0.0,
                          torch.clamp((phi_td - phi_min) / torch.clamp(p_out, min=1e-30),
                                      max=1.0), 1.0)
    r_plus = torch.clamp(r_plus, 0.0, 1.0)
    r_minus = torch.clamp(r_minus, 0.0, 1.0)
    rp, rm = hx.pad(r_plus, 1), hx.pad(r_minus, 1)

    def w1(a, dy, dx, ey=0, ex=0):
        return win(a, dy, dx, ey=ey, ex=ex, pad=1)

    # face factor = min(R- of the donor, R+ of the receiver)
    ax_f = torch.where(ax > 0,
                       torch.minimum(w1(rm, 0, -1, ex=1), w1(rp, 0, 0, ex=1)),
                       torch.minimum(w1(rm, 0, 0, ex=1), w1(rp, 0, -1, ex=1)))
    ay_f = torch.where(ay > 0,
                       torch.minimum(w1(rm, -1, 0, ey=1), w1(rp, 0, 0, ey=1)),
                       torch.minimum(w1(rm, 0, 0, ey=1), w1(rp, -1, 0, ey=1)))
    rp_ze = _zpad(r_plus, 1)
    rm_ze = _zpad(r_minus, 1)
    rp_lo, rp_hi = _zsl(rp_ze, 0, nzf), _zsl(rp_ze, 1, nzf + 1)
    rm_lo, rm_hi = _zsl(rm_ze, 0, nzf), _zsl(rm_ze, 1, nzf + 1)
    # positive az at face k moves mass downward, draining the upper cell k
    az_f = torch.where(az > 0, torch.minimum(rm_hi, rp_lo), torch.minimum(rm_lo, rp_hi))
    return lx + ax * ax_f, ly + ay * ay_f, lz + az * az_f
