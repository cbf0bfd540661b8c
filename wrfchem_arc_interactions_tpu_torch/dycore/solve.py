"""One RK3 split-explicit model timestep (port of the JAX package's
`dycore/solve.py`; canonical dyn_em/solve_em.F):

  for rk_step in 1..3:
      halo padding (group A, width 3)
      diagnostics (calc_p_rho_phi)
      large-step tendencies R (advection + PGF + buoyancy + Coriolis + physics)
      acoustic loop (1, ns/2, ns substeps)
      scalar advection (stage winds; final stage: time-averaged acoustic
      mass fluxes + PD limiter)

Scalars advance as stacks: the stage scalars (the moist set, TKE and
every scalar with a physics tendency) as one (nt, nz, ny, nx) tensor
carried through the three stages, and the chem scalars that advance on
the final stage only as a second one.  The reference chooses among an
unrolled per-tracer loop, a ``lax.scan`` and one stacked pass by the
scalar count; all three compute the same update, and the port has one
route at any count.  Each update of a stack is `_advance_stack`: with the
orders (5, 3) one call of the fused multi-tracer kernel
(`ops.tracers_kernel.advect_tracers`), the positive-definite limiter and
clip included under that limiter.  The kernel has no monotonic limiter
(the TPU kernel has none either), so under ``mono``, and with other
orders on every stage, the update is one plain batched pass of this
module's operators over the whole stack (`_plain_update`): the same
arithmetic per element as the reference's loop and scan bodies, with a
hundred or so launches whatever the scalar count.

The tendency of theta on every stage is the fused 5th/3rd-order advection
kernel (`ops.adv_kernel.advect_scalar_5_3`) whenever the configured orders
are (5, 3); other orders take `advection.advect_scalar`.

Terrain and map projections: over terrain the base state rides the
group-A padding into the pressure gradient, the geopotential tendency and
the acoustic coefficients (the sloped-coordinate terms and the kinematic
surface w); on a projected grid the coupled variables are U = mu u / m,
W = mu w / m, and every scalar update carries m^2 on its horizontal
divergence — the kernels take it as their ``m2`` argument.  After each
stage's update, a global lat-lon run (``fft_filter_lat`` < 90) filters the
poleward rows (`dycore.polar_filter`): the dynamical fields, and the
carried scalar stack itself, so that the next stage advects the filtered
values, as the reference's per-tracer loop does.

Tensors of the incoming state are never written: new stage fields are new
tensors, and the few in-place writes below go into tensors computed here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import AdvLimiter
from wrfchem_arc_interactions_tpu_torch.dycore import advection as adv
from wrfchem_arc_interactions_tpu_torch.dycore import big_step as bs
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import ddz_center, diagnose
from wrfchem_arc_interactions_tpu_torch.dycore.polar_filter import PolarFilter
from wrfchem_arc_interactions_tpu_torch.dycore.small_step import acoustic_loop
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.adv_kernel import advect_scalar_5_3
from wrfchem_arc_interactions_tpu_torch.ops.tracers_kernel import advect_tracers
from wrfchem_arc_interactions_tpu_torch.ops.stencil import avg_z_centers_to_faces, win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.registry.state import State, advected_names
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils import trace


def _mu_u(mu_full_pad):
    """mu at u faces, valid over the padded region except the outer ring."""
    return 0.5 * (mu_full_pad + torch.roll(mu_full_pad, 1, dims=-1))


def _mu_v(mu_full_pad):
    return 0.5 * (mu_full_pad + torch.roll(mu_full_pad, 1, dims=-2))


def _dphi_deta_w(ph_pert, grid: Grid):
    """d(phi_full)/d(eta) at w levels (interior arrays)."""
    znw = grid.znw.reshape(-1, 1, 1)
    dint = (ph_pert[2:] - ph_pert[:-2]) / (znw[2:] - znw[:-2])
    dtop = (ph_pert[-1:] - ph_pert[-2:-1]) / (znw[-1:] - znw[-2:-1])
    dbot = (ph_pert[1:2] - ph_pert[0:1]) / (znw[1:2] - znw[0:1])
    alb_w = avg_z_centers_to_faces(grid.alb, grid.fnm, grid.fnp)
    return torch.cat([dbot, dint, dtop], dim=0) - grid.mub[None] * alb_w


def _rdn_w(grid: Grid):
    top = (-1.0 / grid.znu[-1]).reshape(1)
    return torch.cat([torch.ones(1, dtype=grid.rdn.dtype, device=grid.rdn.device),
                      grid.rdn[1:], top]).reshape(-1, 1, 1)


# Implicit Rayleigh w-damping where the vertical Courant number exceeds
# W_DAMP_BETA (w_damping=1 analog, applied through the acoustic diagonal).
W_DAMP_BETA = 0.9
W_DAMP_ALPHA = 2.0


def _w_damp_profile(grid: Grid, cfg: Config):
    """Implicit Rayleigh w-damping coefficient at w levels (damp_opt=3)."""
    dyn = cfg.dynamics
    if dyn.damp_opt != 3:
        return torch.zeros((1, 1, 1), dtype=grid.phb.dtype, device=grid.phb.device)
    z_w = grid.phb / c.G
    z_top = z_w[-1:]
    zd = z_top - dyn.zdamp
    frac = torch.clamp((z_w - zd) / max(dyn.zdamp, 1.0), 0.0, 1.0)
    return dyn.dampcoef * torch.sin(0.5 * math.pi * frac) ** 2


def _plain_update(q_pad, phi_old, pt_q, limiter: AdvLimiter, ru_s, rv_s, ww_s,
                  mu_full, mu_full_new, dts, grid: Grid, hx: HaloOps, h_s: int, v_s: int,
                  m2=None):
    """(phi_old + dts (-div F + mu pt)) / mu_new for one scalar (nz, ny, nx)
    or a stack of them (nt, nz, ny, nx): the fluxes of the configured
    orders, limited by `limiter`, and the result clipped at zero under
    either limiter, as the reference's loop, scan and stacked bodies do;
    `m2` (ny, nx) scales the horizontal divergence on a projected grid."""
    fx, fy, fz = adv.scalar_fluxes(q_pad, ru_s, rv_s, ww_s, h_s, v_s)
    if limiter == AdvLimiter.POSITIVE_DEFINITE:
        fx, fy, fz = adv.pd_limit(q_pad, phi_old, fx, fy, fz, ru_s, rv_s, ww_s,
                                  dts, grid, hx)
    elif limiter == AdvLimiter.MONOTONIC:
        fx, fy, fz = adv.mono_limit(q_pad, phi_old, mu_full_new, fx, fy, fz,
                                    ru_s, rv_s, ww_s, dts, grid, hx)
    tend = adv.flux_div(fx, fy, fz, grid, m_h=m2)
    if pt_q is not None:
        tend = tend + mu_full * pt_q
    qn = (phi_old + dts * tend) / mu_full_new
    if limiter != AdvLimiter.NONE:
        qn = torch.clamp(qn, min=0.0)
    return qn


def _advance_stack(q_pad, phi_old, pt_q, limiter: AdvLimiter, ru_s, rv_s, ww_s,
                   mu_full, mu_full_new, dts, grid: Grid, hx: HaloOps, h_s: int, v_s: int,
                   m2=None):
    """One flux-form update of a padded scalar stack (nt, nz, ny+6, nx+6):
    the multi-tracer kernel at the orders (5, 3) without the monotonic
    limiter (the positive-definite limiter with its clip), else
    `_plain_update`."""
    if (h_s, v_s) == (5, 3) and limiter != AdvLimiter.MONOTONIC:
        pd = limiter == AdvLimiter.POSITIVE_DEFINITE
        return advect_tracers(q_pad, phi_old, ru_s, rv_s, ww_s, mu_full, mu_full_new, grid,
                              hx, dts, pt=pt_q, pd=pd, clip=pd)
    return _plain_update(q_pad, phi_old, pt_q, limiter, ru_s, rv_s, ww_s, mu_full, mu_full_new,
                         dts, grid, hx, h_s, v_s, m2=m2)


def step(state: State, grid: Grid, cfg: Config, hx: HaloOps, dt: float,
         phys_tend: Optional[Dict[str, torch.Tensor]] = None) -> State:
    """Advance the dynamical state one dt (physics tendencies held fixed)."""
    with trace.span("dycore"):
        dyn = cfg.dynamics
        moist = cfg.moist_species()
        scalars = advected_names(cfg)       # refuses the options check_config refuses
        ns_total = cfg.n_acoustic
        pt = phys_tend or {}

        # Chem-scalar stage split (solve_em.F advects chem/tracer arrays only on
        # the final RK3 stage: one flux-form update from the step-start value
        # with the time-averaged acoustic mass fluxes and the chem_adv_opt
        # limiter).  A scalar with a physics tendency rides every stage; with
        # diffusion on (configs 3 and 4) every scalar has one, so the final-only
        # set is empty there.
        stage_set = set(moist) | {"tke", "qke"} | set(pt)
        if dyn.chem_adv_final_only:
            final_scalars = tuple(q for q in scalars if q not in stage_set)
        else:
            final_scalars = ()
        stage_scalars = tuple(q for q in scalars if q not in final_scalars)

        h_m, v_m = dyn.h_mom_adv_order.value, dyn.v_mom_adv_order.value
        h_s, v_s = dyn.h_sca_adv_order.value, dyn.v_sca_adv_order.value

        # ---- map-factor coupling (U = mu u / m, W = mu w / m; m2 on every
        # scalar divergence); the flat path does no extra work ----------------
        msf = grid.has_msf
        inv_mu_f = 1.0 / grid.msfu if msf else None
        inv_mv_f = 1.0 / grid.msfv if msf else None
        inv_mt = 1.0 / grid.msft if msf else None
        m2_t = grid.msft * grid.msft if msf else None

        def scalar_tend(q_pad, ru, rv, ww_):
            """-div F of an uncoupled scalar, no limiter."""
            if (h_s, v_s) == (5, 3):
                return advect_scalar_5_3(q_pad, ru, rv, ww_, grid.rdnw, grid.rdx, grid.rdy,
                                         m2=m2_t)
            return adv.advect_scalar(q_pad, ru, rv, ww_, grid, h_s, v_s)

        w_damp = _w_damp_profile(grid, cfg)
        rdn_w = _rdn_w(grid)
        polar = (PolarFilter(grid, dyn.fft_filter_lat, grid.nx, hx)
                 if dyn.fft_filter_lat < 90.0 else None)
        # the time-invariant grid fields the stencils read in the halo: the base
        # state over terrain, the map factors of a projected grid (padded once a
        # step; the reference sends them with every stage's exchange)
        static = {}
        if grid.has_terrain:
            static.update(phb=grid.phb, mub=grid.mub, alb=grid.alb)
        if msf:
            static.update(msfu=grid.msfu, msfv=grid.msfv)
        static = hx.pad_many(static, 3)
        base_pads = ({k: static[k] for k in ("phb", "mub", "alb")}
                     if grid.has_terrain else None)

        # ---- step-start (t0) coupled quantities ------------------------------
        mu_full_0 = grid.mub + state["mu"]
        g0 = hx.pad_many({"u": state["u"], "v": state["v"], "mu": mu_full_0}, 1)
        mu_u0 = win(_mu_u(g0["mu"]), 0, 0, pad=1)
        mu_v0 = win(_mu_v(g0["mu"]), 0, 0, pad=1)
        if msf:
            mu_u0 = mu_u0 * inv_mu_f
            mu_v0 = mu_v0 * inv_mv_f
        cpl0 = {
            "u": mu_u0[None] * state["u"],
            "v": mu_v0[None] * state["v"],
            "w": (mu_full_0 * inv_mt if msf else mu_full_0)[None] * state["w"],
            "th": mu_full_0[None] * (state["t"] + c.T0),
            "mu": state["mu"],
            "ph": state["ph"],
        }
        if final_scalars:
            sc_fin = torch.stack([state[q] for q in final_scalars])
            phi_fin = mu_full_0[None, None] * sc_fin
        sc_stack = torch.stack([state[q] for q in stage_scalars])
        phi_stack = mu_full_0[None, None] * sc_stack
        moist_idx = {q: i for i, q in enumerate(stage_scalars) if q in moist}
        # physics tendencies are stage-invariant: stacked once per step
        pt_stack = None
        if any(q in pt for q in stage_scalars):
            zeros = torch.zeros_like(state["t"])
            pt_stack = torch.stack([torch.broadcast_to(pt[q], zeros.shape)
                                    if q in pt else zeros for q in stage_scalars])

        stage_state = state
        stage_dts = [dt / 3.0, dt / 2.0, dt]
        stage_ns = [1, max(ns_total // 2, 1), ns_total]

        for istage in range(3):
            with trace.span("stage"):
                dts = stage_dts[istage]
                ns = stage_ns[istage]
                dtau = dts / ns

                with trace.span("large_step"):
                    diag = diagnose(stage_state, grid, moist)
                    mu_full = diag.mu_full

                    # ---- group-A halo padding (width 3) ------------------------------
                    gA = hx.pad_many({
                        "u": stage_state["u"], "v": stage_state["v"], "w": stage_state["w"],
                        "ph": stage_state["ph"], "t": stage_state["t"],
                        "mu": mu_full, "p": diag.p_pert, "al": diag.alpha_d, "eps": diag.eps_ratio,
                    }, 3)
                    gA.update(static)

                    mu_u_pad = _mu_u(gA["mu"])
                    mu_v_pad = _mu_v(gA["mu"])
                    if msf:
                        ru_pad = mu_u_pad[None] * gA["u"] / gA["msfu"][None]
                        rv_pad = mu_v_pad[None] * gA["v"] / gA["msfv"][None]
                    else:
                        ru_pad = mu_u_pad[None] * gA["u"]
                        rv_pad = mu_v_pad[None] * gA["v"]
                    dmudt, ww = bs.omega_diagnosis(ru_pad, rv_pad, grid)
                    ww_pad = hx.pad(ww, 3)
                    th_full_pad = gA["t"] + c.T0

                    # ---- large-step tendencies R --------------------------------------
                    pgf_u, pgf_v = bs.pgf_uv(gA["p"], gA["ph"], gA["al"], gA["eps"], gA["mu"],
                                             grid, base_pads=base_pads)
                    cor_u, cor_v = bs.coriolis_uv(gA["u"], gA["v"], gA["mu"], grid)
                    mu_u = win(mu_u_pad, 0, 0)
                    mu_v = win(mu_v_pad, 0, 0)
                    # physics tendencies couple into the momentum-flux units mu/m
                    mu_u_c = mu_u * inv_mu_f if msf else mu_u
                    mu_v_c = mu_v * inv_mv_f if msf else mu_v

                    R = {}
                    R["ru"] = (adv.advect_u(gA["u"], ru_pad, rv_pad, ww_pad, grid, h_m, v_m)
                               + pgf_u + cor_u + mu_u_c[None] * pt.get("u", 0.0))
                    R["rv"] = (adv.advect_v(gA["v"], ru_pad, rv_pad, ww_pad, grid, h_m, v_m)
                               + pgf_v + cor_v + mu_v_c[None] * pt.get("v", 0.0))
                    rw_adv = adv.advect_w(gA["w"], ru_pad, rv_pad, ww, grid, h_m, v_m)
                    buoy = bs.buoyancy_w(diag.p_pert, diag.eps_ratio, stage_state["mu"], grid)
                    R["rw"] = rw_adv + buoy
                    R["rw"][0] = 0.0
                    if dyn.w_damping:
                        # runaway-updraft protection (w_damping=1)
                        cflv = torch.abs(ww) * dt * rdn_w / mu_full[None]
                        rate = torch.clamp(
                            W_DAMP_ALPHA * torch.clamp(cflv - W_DAMP_BETA, min=0.0), max=0.3)
                        mu_w_c = mu_full * inv_mt if msf else mu_full
                        R["rw"] = R["rw"] - (rate / dt) * (mu_w_c[None] * stage_state["w"])
                    R["rth"] = (scalar_tend(th_full_pad, ru_pad, rv_pad, ww)
                                + mu_full[None] * pt.get("th", 0.0))
                    # rphi takes the coupled W so its g W / mu term matches the acoustic
                    # loop's fast term exactly
                    R["rph"] = bs.rphi_tendency(ru_pad, rv_pad, gA["ph"],
                                                mu_full[None] * stage_state["w"], ww,
                                                mu_full, grid, phb_pad=gA.get("phb"))
                    R["rmu"] = dmudt

                with trace.span("acoustic"):
                    # ---- acoustic coefficients ----------------------------------------
                    th_cpl = mu_full[None] * (stage_state["t"] + c.T0)
                    eal_pad = gA["eps"] * gA["al"]
                    eal_u = 0.5 * (win(eal_pad, 0, -1) + win(eal_pad, 0, 0))
                    eal_v = 0.5 * (win(eal_pad, -1, 0) + win(eal_pad, 0, 0))
                    eps_u = 0.5 * (win(gA["eps"], 0, -1) + win(gA["eps"], 0, 0))
                    eps_v = 0.5 * (win(gA["eps"], -1, 0) + win(gA["eps"], 0, 0))
                    dpdn = ddz_center(win(gA["p"], 0, -1, ex=1), grid.znu)
                    dpdn_u = 0.5 * (dpdn[..., :-1] + dpdn[..., 1:])
                    dpdn_y = ddz_center(win(gA["p"], -1, 0, ey=1), grid.znu)
                    dpdn_v = 0.5 * (dpdn_y[:, :-1, :] + dpdn_y[:, 1:, :])
                    dpdx_ref = (win(gA["p"], 0, 0) - win(gA["p"], 0, -1)) * grid.rdx
                    dpdy_ref = (win(gA["p"], 0, 0) - win(gA["p"], -1, 0)) * grid.rdy

                    ac = {
                        "coef_pt": c.GAMMA * diag.p_full / th_cpl,
                        "s": c.GAMMA * diag.p_full * grid.rdnw.reshape(-1, 1, 1)
                             / (diag.alpha_d * mu_full[None]),
                        "inv_mu": 1.0 / mu_full,
                        "eps_w": avg_z_centers_to_faces(diag.eps_ratio, grid.fnm, grid.fnp),
                        "rdn_w": rdn_w,
                        "dphdn_ref": _dphi_deta_w(stage_state["ph"], grid),
                        "c_ux": win(mu_u_pad, 0, 0)[None] * eal_u,
                        "c_vy": win(mu_v_pad, 0, 0)[None] * eal_v,
                        "c_ux2": eps_u * (grid.mub[None] + dpdn_u),
                        "c_vy2": eps_v * (grid.mub[None] + dpdn_v),
                        "c_ux3": eal_u * dpdx_ref,
                        "c_vy3": eal_v * dpdy_ref,
                        "th_x": 0.5 * (win(th_full_pad, 0, -1, ex=1)
                                       + win(th_full_pad, 0, 0, ex=1)),
                        "th_y": 0.5 * (win(th_full_pad, -1, 0, ey=1)
                                       + win(th_full_pad, 0, 0, ey=1)),
                        "th_z": avg_z_centers_to_faces(stage_state["t"] + c.T0, grid.fnm,
                                                       grid.fnp),
                        "w_damp": w_damp,
                        "ru_ref": win(ru_pad, 0, 0),
                        "rv_ref": win(rv_pad, 0, 0),
                        "ww_ref": ww,
                    }
                    if msf:
                        ac["msft"] = grid.msft
                        ac["inv_msft"] = inv_mt
                    if grid.has_terrain:
                        # sloped-coordinate terms of the acoustic linearisation: the
                        # terrain PGF term linearised around the stage reference gives a
                        # mu''-coefficient (in c_ux3) and a d(p'')/d(eta)-coefficient
                        # (c_ux4)
                        mub_u = 0.5 * (win(gA["mub"], 0, -1) + win(gA["mub"], 0, 0))
                        mub_v = 0.5 * (win(gA["mub"], -1, 0) + win(gA["mub"], 0, 0))
                        alb_u = 0.5 * (win(gA["alb"], 0, -1) + win(gA["alb"], 0, 0))
                        alb_v = 0.5 * (win(gA["alb"], -1, 0) + win(gA["alb"], 0, 0))
                        ald_u = 0.5 * (win(gA["al"], 0, -1) + win(gA["al"], 0, 0))
                        ald_v = 0.5 * (win(gA["al"], -1, 0) + win(gA["al"], 0, 0))
                        dphbdx_w = (win(gA["phb"], 0, 0, ex=1)
                                    - win(gA["phb"], 0, -1, ex=1)) * grid.rdx
                        dphbdx = 0.5 * (dphbdx_w[:-1, :, :-1] + dphbdx_w[1:, :, :-1])
                        dphbdy_w = (win(gA["phb"], 0, 0, ey=1)
                                    - win(gA["phb"], -1, 0, ey=1)) * grid.rdy
                        dphbdy = 0.5 * (dphbdy_w[:-1, :-1, :] + dphbdy_w[1:, :-1, :])
                        ac["c_ux2"] = eps_u * (mub_u[None] + dpdn_u)
                        ac["c_vy2"] = eps_v * (mub_v[None] + dpdn_v)
                        ac["c_ux3"] = eal_u * dpdx_ref - eps_u * dphbdx * (ald_u / alb_u)
                        ac["c_vy3"] = eal_v * dpdy_ref - eps_v * dphbdy * (ald_v / alb_v)
                        ac["c_ux4"] = eps_u * dphbdx
                        ac["c_vy4"] = eps_v * dphbdy

                        # kinematic surface BC w_sfc = (u dx(phi_sfc) + v dy(phi_sfc))/g:
                        # a reference part (wsfc_const) and coefficients of the acoustic
                        # wind perturbations at the four faces around the cell
                        mu_u_facex = win(mu_u_pad, 0, 0, ex=1)
                        mu_v_facey = win(mu_v_pad, 0, 0, ey=1)
                        dhdx_f = dphbdx_w[0] / c.G
                        dhdy_f = dphbdy_w[0] / c.G
                        if msf:
                            msfu_fx = win(gA["msfu"], 0, 0, ex=1)
                            msfv_fy = win(gA["msfv"], 0, 0, ey=1)
                            mu_w_cpl = mu_full * inv_mt
                        else:
                            msfu_fx = torch.ones_like(mu_u_facex)
                            msfv_fy = torch.ones_like(mu_v_facey)
                            mu_w_cpl = mu_full
                        u_ref_f = win(ru_pad, 0, 0, ex=1)[0] * msfu_fx / mu_u_facex
                        v_ref_f = win(rv_pad, 0, 0, ey=1)[0] * msfv_fy / mu_v_facey
                        w_ref_sfc = 0.5 * (u_ref_f[:, :-1] * dhdx_f[:, :-1]
                                           + u_ref_f[:, 1:] * dhdx_f[:, 1:]
                                           + v_ref_f[:-1, :] * dhdy_f[:-1, :]
                                           + v_ref_f[1:, :] * dhdy_f[1:, :])
                        ac["wsfc_const"] = mu_w_cpl * (w_ref_sfc - stage_state["w"][0])
                        ac["cwx_w"] = (mu_w_cpl * 0.5 * dhdx_f[:, :-1] * msfu_fx[:, :-1]
                                       / mu_u_facex[:, :-1])
                        ac["cwx_e"] = (mu_w_cpl * 0.5 * dhdx_f[:, 1:] * msfu_fx[:, 1:]
                                       / mu_u_facex[:, 1:])
                        ac["cwy_s"] = (mu_w_cpl * 0.5 * dhdy_f[:-1, :] * msfv_fy[:-1, :]
                                       / mu_v_facey[:-1, :])
                        ac["cwy_n"] = (mu_w_cpl * 0.5 * dhdy_f[1:, :] * msfv_fy[1:, :]
                                       / mu_v_facey[1:, :])

                    # ---- acoustic perturbation initial values -------------------------
                    cplref = {
                        "u": ac["ru_ref"], "v": ac["rv_ref"],
                        "w": (mu_full * inv_mt if msf else mu_full)[None] * stage_state["w"],
                        "th": th_cpl, "mu": stage_state["mu"], "ph": stage_state["ph"],
                    }
                    if istage == 0:
                        pp = {k: torch.zeros_like(v) for k, v in cplref.items()}
                    else:
                        pp = {k: cpl0[k] - cplref[k] for k in cplref}

                    pp_out, avg_flux = acoustic_loop(pp, R, ac, ns, dtau, grid, cfg, hx)

                    # ---- assemble the new stage state ---------------------------------
                    mu_new = cplref["mu"] + pp_out["mu"]
                    mu_full_new = grid.mub + mu_new
                    gmu = hx.pad(mu_full_new, 1)
                    mu_u_new = win(_mu_u(gmu), 0, 0, pad=1)
                    mu_v_new = win(_mu_v(gmu), 0, 0, pad=1)
                    if msf:
                        mu_u_new = mu_u_new * inv_mu_f
                        mu_v_new = mu_v_new * inv_mv_f
                    mu_w_new = mu_full_new * inv_mt if msf else mu_full_new
                    new = dict(stage_state)
                    new["u"] = (cplref["u"] + pp_out["u"]) / mu_u_new[None]
                    new["v"] = (cplref["v"] + pp_out["v"]) / mu_v_new[None]
                    new["w"] = (cplref["w"] + pp_out["w"]) / mu_w_new[None]
                    new["t"] = (cplref["th"] + pp_out["th"]) / mu_full_new[None] - c.T0
                    new["mu"] = mu_new
                    new["ph"] = cplref["ph"] + pp_out["ph"]

                with trace.span("scalars"):
                    # ---- scalars --------------------------------------------------------
                    final = istage == 2
                    if final:
                        gF = hx.pad_many({"ru": avg_flux["ru"], "rv": avg_flux["rv"]}, 3)
                        # the multi-tracer kernel takes contiguous fluxes; the average
                        # keeps w's layout, (y, z, x) in a nest's child
                        ru_s, rv_s, ww_s = gF["ru"], gF["rv"], avg_flux["ww"].contiguous()
                    else:
                        ru_s, rv_s, ww_s = ru_pad, rv_pad, ww
                    limiter = dyn.moist_adv_opt if final else AdvLimiter.NONE

                    def advance(stack, phi, pt_q, lim):
                        """One flux-form update of the scalar stack `stack`, the result
                        filtered under the polar filter."""
                        out = _advance_stack(hx.pad(stack, 3), phi, pt_q, lim, ru_s, rv_s,
                                             ww_s, mu_full, mu_full_new, dts, grid, hx, h_s,
                                             v_s, m2=m2_t)
                        return out if polar is None else polar.scalar(out)

                    sc_stack = advance(sc_stack, phi_stack, pt_stack, limiter)
                    # diagnose() reads the moist subset every stage; the others
                    # unstack once, at the end
                    for q, i in moist_idx.items():
                        new[q] = sc_stack[i]
                    if final:
                        for i, q in enumerate(stage_scalars):
                            new[q] = sc_stack[i]
                        if final_scalars:
                            # chem tracers: one final-stage update from the step-start
                            # value (their state still holds it) with the time-averaged
                            # fluxes
                            fin_new = advance(sc_fin, phi_fin, None, dyn.chem_adv_opt)
                            for i, q in enumerate(final_scalars):
                                new[q] = fin_new[i]

                    if polar is not None:
                        # global lat-lon runs: zonally truncate the poleward rows after
                        # each stage's updates (the solve_em.F pxft call sites), sharp on
                        # the dynamical fields, tapered and clipped on the scalar stacks
                        # above
                        new = polar.momentum(new)

                stage_state = new

        return stage_state
