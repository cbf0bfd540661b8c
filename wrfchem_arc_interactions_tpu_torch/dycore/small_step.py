"""Acoustic (small) substeps: forward-backward horizontal integration plus
the vertically implicit w-geopotential solve (port of the JAX package's
`dycore/small_step.py`; canonical module_small_step_em.F).

Perturbations X'' are relative to the RK-stage reference state; per substep:
EOS linearisation with divergence damping, forward U'' V'' update, column
mass and omega'' by vertical integration, forward Theta'', and the implicit
W''-phi'' tridiagonal solve with off-centering beta (epssm) and implicit
Rayleigh damping.  Flat grid, single device: the terrain and map-factor
branches of the reference come with a later slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops.stencil import win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import overlap_stencil
from wrfchem_arc_interactions_tpu_torch.utils.constants import G

Tensors = Dict[str, torch.Tensor]


def acoustic_loop(pp: Tensors, R: Tensors, ac: Tensors, ns: int, dtau: float,
                  grid: Grid, cfg, hx) -> Tuple[Tensors, Tensors]:
    """Run `ns` acoustic substeps of length `dtau`.

    pp: initial perturbations {u, v, w, th, mu, ph}; R: slow tendencies
    {ru, rv, rw, rth, rph, rmu}; ac: stage reference coefficients (built in
    `solve.step`).  Returns (final perturbations, {ru, rv, ww} time-averaged
    total mass fluxes for scalar advection).
    """
    dyn = cfg.dynamics
    beta = dyn.epssm
    bp, bm = 0.5 * (1.0 + beta), 0.5 * (1.0 - beta)
    smdiv = dyn.smdiv
    # external-mode filter: -nu * grad(dmu_ac) of the previous substep
    emdiv = dyn.emdiv

    dnw = grid.dnw.reshape(-1, 1, 1)
    rdnw = grid.rdnw.reshape(-1, 1, 1)

    coef_pt = ac["coef_pt"]
    s = ac["s"]
    inv_mu = ac["inv_mu"]
    eps_w = ac["eps_w"]
    rdn_w = ac["rdn_w"]
    dphdn_ref = ac["dphdn_ref"]

    def p_of2(th_pp, ph_pp):
        return coef_pt * th_pp + s * (ph_pp[1:] - ph_pp[:-1])

    u, v, w, th, mu, ph = pp["u"], pp["v"], pp["w"], pp["th"], pp["mu"], pp["ph"]
    p_prev = p_of2(th, ph)

    ru_avg = torch.zeros_like(u)
    rv_avg = torch.zeros_like(v)
    ww_avg = torch.zeros_like(w)
    mudf = torch.zeros_like(mu)

    th_x_w, th_x_e = ac["th_x"][:, :, :-1], ac["th_x"][:, :, 1:]
    th_y_s, th_y_n = ac["th_y"][:, :-1, :], ac["th_y"][:, 1:, :]

    def mom_fn(padded, cs):
        """Forward U'', V'' update from padded p_d/ph/mu/mudf."""
        p_pad, ph_pad = padded["p"], padded["ph"]
        mu_pad, mudf_pad = padded["mu"], padded["mudf"]
        dppdx = (win(p_pad, 0, 0, pad=1) - win(p_pad, 0, -1, pad=1)) * grid.rdx
        dphdx_w = (win(ph_pad, 0, 0, pad=1) - win(ph_pad, 0, -1, pad=1)) * grid.rdx
        dphdx = 0.5 * (dphdx_w[:-1] + dphdx_w[1:])
        mu_u = 0.5 * (win(mu_pad, 0, -1, pad=1) + win(mu_pad, 0, 0, pad=1))
        du = (cs["R_ru"] - cs["c_ux"] * dppdx - cs["c_ux2"] * dphdx
              - mu_u[None] * cs["c_ux3"])
        if emdiv > 0.0:
            dxs = 1.0 / grid.rdx
            du = du - (emdiv * dxs) * (win(mudf_pad, 0, 0, pad=1)
                                       - win(mudf_pad, 0, -1, pad=1))[None]
        dppdy = (win(p_pad, 0, 0, pad=1) - win(p_pad, -1, 0, pad=1)) * grid.rdy
        dphdy_w = (win(ph_pad, 0, 0, pad=1) - win(ph_pad, -1, 0, pad=1)) * grid.rdy
        dphdy = 0.5 * (dphdy_w[:-1] + dphdy_w[1:])
        mu_v = 0.5 * (win(mu_pad, -1, 0, pad=1) + win(mu_pad, 0, 0, pad=1))
        dv = (cs["R_rv"] - cs["c_vy"] * dppdy - cs["c_vy2"] * dphdy
              - mu_v[None] * cs["c_vy3"])
        if emdiv > 0.0:
            dys = 1.0 / grid.rdy
            dv = dv - (emdiv * dys) * (win(mudf_pad, 0, 0, pad=1)
                                       - win(mudf_pad, -1, 0, pad=1))[None]
        return {"u": cs["u"] + dtau * du, "v": cs["v"] + dtau * dv}

    def divth_fn(padded, cs):
        """Horizontal divergence + theta horizontal flux divergence."""
        u_e = win(padded["u"], 0, 1, pad=1)
        u_w = win(padded["u"], 0, 0, pad=1)
        v_n = win(padded["v"], 1, 0, pad=1)
        v_s = win(padded["v"], 0, 0, pad=1)
        div = (u_e - u_w) * grid.rdx + (v_n - v_s) * grid.rdy
        hdiv_th = ((u_e * cs["th_x_e"] - u_w * cs["th_x_w"]) * grid.rdx
                   + (v_n * cs["th_y_n"] - v_s * cs["th_y_s"]) * grid.rdy)
        return {"div": div, "hdiv_th": hdiv_th}

    mom_consts = {"R_ru": R["ru"], "R_rv": R["rv"],
                  "c_ux": ac["c_ux"], "c_ux2": ac["c_ux2"], "c_ux3": ac["c_ux3"],
                  "c_vy": ac["c_vy"], "c_vy2": ac["c_vy2"], "c_vy3": ac["c_vy3"]}
    divth_consts = {"th_x_w": th_x_w, "th_x_e": th_x_e,
                    "th_y_s": th_y_s, "th_y_n": th_y_n}

    for _ in range(ns):
        p_now = p_of2(th, ph)
        p_d = p_now + smdiv * (p_now - p_prev)
        p_prev = p_now

        # --- forward horizontal momentum ----------------------------------
        uv = overlap_stencil(hx, {"p": p_d, "ph": ph, "mu": mu, "mudf": mudf},
                             1, mom_fn, {**mom_consts, "u": u, "v": v})
        u, v = uv["u"], uv["v"]

        # --- divergence + theta fluxes ------------------------------------
        dd = overlap_stencil(hx, {"u": u, "v": v}, 1, divth_fn, divth_consts)
        div = dd["div"]

        # --- column mass and omega'' --------------------------------------
        dmu_ac = torch.sum(dnw * div, dim=0)
        mudf = dmu_ac
        mu = mu + dtau * (R["rmu"] + dmu_ac)
        incr = dnw * (-dmu_ac[None] - div)
        om = torch.cat([torch.zeros_like(div[:1]), torch.cumsum(incr, dim=0)], dim=0)

        # --- forward Theta'' ----------------------------------------------
        fz = om * ac["th_z"]
        dth = R["rth"] - (dd["hdiv_th"] + (fz[1:] - fz[:-1]) * rdnw)
        th = th + dtau * dth

        # --- implicit W''-phi'' -------------------------------------------
        a_w = dtau * G * bp * inv_mu
        gw_m = G * inv_mu[None]
        ph_exp_t = (R["rph"] - om * dphdn_ref * inv_mu[None]
                    + gw_m * bm * w)
        ph_exp = ph + dtau * ph_exp_t
        ph_exp[0] = ph[0]                                 # phi''_sfc frozen

        p_theta = coef_pt * th
        p_exp = p_theta + s * (ph_exp[1:] - ph_exp[:-1])
        # p'' = 0 above the lid: "up" arrays padded with zero at k = nz
        zero2d = torch.zeros_like(p_exp[:1])
        p_exp_up = torch.cat([p_exp, zero2d], dim=0)
        p_exp_dn = torch.cat([zero2d, p_exp], dim=0)
        p_old_up = torch.cat([p_now, zero2d], dim=0)
        p_old_dn = torch.cat([zero2d, p_now], dim=0)
        s_up = torch.cat([s, torch.zeros_like(s[:1])], dim=0)
        s_dn = torch.cat([torch.zeros_like(s[:1]), s], dim=0)

        dpdn_exp = rdn_w * (p_exp_up - p_exp_dn)
        dpdn_old = rdn_w * (p_old_up - p_old_dn)

        K = dtau * G * eps_w * bp * rdn_w * a_w[None]
        A = -K * s_dn
        C = -K * s_up
        B = 1.0 + K * (s_up + s_dn) + dtau * ac["w_damp"]
        D = (w + dtau * (R["rw"]
                         + G * eps_w * (bp * dpdn_exp + bm * dpdn_old)
                         - G * mu[None]))
        # flat surface row: W'' = 0
        A[0] = 0.0
        C[0] = 0.0
        B[0] = 1.0
        D[0] = 0.0
        w = thomas(A, B, C, D)
        ph = ph_exp + a_w[None] * w
        ph[0] = ph_exp[0]

        # --- averaged mass fluxes for scalar advection --------------------
        ru_avg = ru_avg + (ac["ru_ref"] + u) * (1.0 / ns)
        rv_avg = rv_avg + (ac["rv_ref"] + v) * (1.0 / ns)
        ww_avg = ww_avg + (ac["ww_ref"] + om) * (1.0 / ns)

    out = {"u": u, "v": v, "w": w, "th": th, "mu": mu, "ph": ph}
    avg = {"ru": ru_avg, "rv": rv_avg, "ww": ww_avg}
    return out, avg
