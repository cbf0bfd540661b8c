"""Acoustic (small) substeps: forward-backward horizontal integration plus
the vertically implicit w-geopotential solve (port of the JAX package's
`dycore/small_step.py`; canonical module_small_step_em.F).

Perturbations X'' are relative to the RK-stage reference state; per substep:
EOS linearisation with divergence damping, forward U'' V'' update, column
mass and omega'' by vertical integration, forward Theta'', and the implicit
W''-phi'' tridiagonal solve with off-centering beta (epssm) and implicit
Rayleigh damping (`ops/advance_w_kernel.py::advance_w`: one kernel launch a
substep on the card).  Single device.

Over terrain the forward momentum update carries the sloped-coordinate
term -eps d(phb)/dx d(p'')/d(eta), and the surface row of the implicit
solve is the kinematic free-slip value w = u.grad(phi_sfc)/g of the
substep's new winds instead of 0.  On a projected grid m^2 scales the
divergence and theta flux terms, 1/m the buoyancy of the W'' row and m the
g W / mu coupling of phi''; the implicit diagonal is m-free (the two
cancel along a column).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import ddz_center
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.ops import advance_w_kernel
from wrfchem_arc_interactions_tpu_torch.ops.stencil import column_sum, win
from wrfchem_arc_interactions_tpu_torch.parallel.halo import overlap_stencil

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
    smdiv = dyn.smdiv
    # external-mode filter: -nu * grad(dmu_ac) of the previous substep
    emdiv = dyn.emdiv

    dnw = grid.dnw.reshape(-1, 1, 1)
    rdnw = grid.rdnw.reshape(-1, 1, 1)

    coef_pt = ac["coef_pt"]
    s = ac["s"]

    # map factors (real projections)
    msf = "msft" in ac
    m_t = ac.get("msft")
    m2 = (m_t * m_t) if msf else None

    def p_of2(th_pp, ph_pp):
        return coef_pt * th_pp + s * (ph_pp[1:] - ph_pp[:-1])

    u, v, w, th, mu, ph = pp["u"], pp["v"], pp["w"], pp["th"], pp["mu"], pp["ph"]
    p_prev = p_of2(th, ph)

    ru_avg = torch.zeros_like(u)
    rv_avg = torch.zeros_like(v)
    ww_avg = torch.zeros_like(w)
    mudf = torch.zeros_like(mu)

    # the implicit update's stage inputs, contiguous as its kernel takes
    # them (a nest's child on a mesh holds its fields in (y, z, x) order)
    ac_w = {k: ac[k].contiguous() for k in advance_w_kernel.STAGE_KEYS if k in ac}
    rw, rph = R["rw"].contiguous(), R["rph"].contiguous()

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
        if grid.has_terrain:
            # sloped-coordinate term: -eps d(phb)/dx * d(p'')/d(eta)
            dpdn = ddz_center(win(p_pad, 0, -1, ex=1, pad=1), grid.znu)
            dpdn_u = 0.5 * (dpdn[..., :-1] + dpdn[..., 1:])
            du = du - cs["c_ux4"] * dpdn_u
            dpdn_y = ddz_center(win(p_pad, -1, 0, ey=1, pad=1), grid.znu)
            dpdn_v = 0.5 * (dpdn_y[:, :-1, :] + dpdn_y[:, 1:, :])
            dv = dv - cs["c_vy4"] * dpdn_v
        return {"u": cs["u"] + dtau * du, "v": cs["v"] + dtau * dv}

    def divth_fn(padded, cs):
        """Horizontal divergence + theta horizontal flux divergence (+ the
        kinematic surface-w target over terrain, from the same winds)."""
        u_e = win(padded["u"], 0, 1, pad=1)
        u_w = win(padded["u"], 0, 0, pad=1)
        v_n = win(padded["v"], 1, 0, pad=1)
        v_s = win(padded["v"], 0, 0, pad=1)
        div = (u_e - u_w) * grid.rdx + (v_n - v_s) * grid.rdy
        hdiv_th = ((u_e * cs["th_x_e"] - u_w * cs["th_x_w"]) * grid.rdx
                   + (v_n * cs["th_y_n"] - v_s * cs["th_y_s"]) * grid.rdy)
        if "m2" in cs:
            div = cs["m2"][None] * div
            hdiv_th = cs["m2"][None] * hdiv_th
        out = {"div": div, "hdiv_th": hdiv_th}
        if grid.has_terrain:
            out["wsfc_pp"] = (cs["cwx_w"] * u_w[0] + cs["cwx_e"] * u_e[0]
                              + cs["cwy_s"] * v_s[0] + cs["cwy_n"] * v_n[0])
        return out

    mom_consts = {"R_ru": R["ru"], "R_rv": R["rv"],
                  "c_ux": ac["c_ux"], "c_ux2": ac["c_ux2"], "c_ux3": ac["c_ux3"],
                  "c_vy": ac["c_vy"], "c_vy2": ac["c_vy2"], "c_vy3": ac["c_vy3"]}
    divth_consts = {"th_x_w": th_x_w, "th_x_e": th_x_e,
                    "th_y_s": th_y_s, "th_y_n": th_y_n}
    if msf:
        divth_consts["m2"] = m2
    if grid.has_terrain:
        mom_consts["c_ux4"] = ac["c_ux4"]
        mom_consts["c_vy4"] = ac["c_vy4"]
        for k in ("cwx_w", "cwx_e", "cwy_s", "cwy_n"):
            divth_consts[k] = ac[k]

    for _ in range(ns):
        p_now = p_of2(th, ph)
        p_d = p_now + smdiv * (p_now - p_prev)
        p_prev = p_now

        # --- forward horizontal momentum ----------------------------------
        uv = overlap_stencil(hx, {"p": p_d, "ph": ph, "mu": mu, "mudf": mudf},
                             1, mom_fn, {**mom_consts, "u": u, "v": v},
                             overlap=dyn.overlap_halo)
        u, v = uv["u"], uv["v"]

        # --- divergence + theta fluxes ------------------------------------
        dd = overlap_stencil(hx, {"u": u, "v": v}, 1, divth_fn, divth_consts,
                             overlap=dyn.overlap_halo)
        div = dd["div"]

        # --- column mass and omega'' --------------------------------------
        dmu_ac = column_sum(dnw * div)
        mudf = dmu_ac
        mu = mu + dtau * (R["rmu"] + dmu_ac)
        incr = dnw * (-dmu_ac[None] - div)
        om = torch.cat([torch.zeros_like(div[:1]), torch.cumsum(incr, dim=0)], dim=0)

        # --- forward Theta'' ----------------------------------------------
        fz = om * ac["th_z"]
        dth = R["rth"] - (dd["hdiv_th"] + (fz[1:] - fz[:-1]) * rdnw)
        th = th + dtau * dth

        # --- implicit W''-phi'' (one kernel launch on the card) -------------
        # surface row: flat => W'' = 0; terrain => the kinematic BC with the
        # new acoustic winds (reference part + perturbation-wind part)
        wsfc = (ac["wsfc_const"] + dd["wsfc_pp"]).contiguous() if grid.has_terrain else None
        w, ph = advance_w_kernel.advance_w(
            w.contiguous(), ph.contiguous(), th.contiguous(), mu.contiguous(), om,
            p_now.contiguous(), rw, rph, ac_w, dtau, beta, wsfc)

        # --- averaged mass fluxes for scalar advection --------------------
        ru_avg = ru_avg + (ac["ru_ref"] + u) * (1.0 / ns)
        rv_avg = rv_avg + (ac["rv_ref"] + v) * (1.0 / ns)
        ww_avg = ww_avg + (ac["ww_ref"] + om) * (1.0 / ns)

    out = {"u": u, "v": v, "w": w, "th": th, "mu": mu, "ph": ph}
    avg = {"ru": ru_avg, "rv": rv_avg, "ww": ww_avg}
    return out, avg
