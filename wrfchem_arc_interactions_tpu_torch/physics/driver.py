"""Physics orchestration around the dynamics step (port of the JAX
package's `physics/driver.py`).

- `pre_dynamics`: tendencies computed once per dt and held through the RK
  stages, in the reference's order: the held radiative heating
  rthraten_sw + rthraten_lw, the surface layer and PBL (YSU or MYNN, with
  the slab or the Noah land surface), the LES surface heat flux, cumulus
  (BMJ, KF or Grell, accumulating rainc), the subgrid diffusion, and SPPT
  and SKEBS.  Radiation and chemistry run as their own steppers on their
  alarms (`models.driver.Simulation`).
- `post_dynamics`: microphysics on the post-advection state: Kessler,
  WSM6, or Morrison two-moment, which with ``progn`` and a chem package
  takes its activated droplet number from the MOSAIC bins through
  `mixactivate.activate` (the ARC indirect effect).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.driver import _nbin
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import (
    CUScheme, MPScheme, PBLScheme, SFScheme,
)
from wrfchem_arc_interactions_tpu_torch.dycore import stoch
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.dycore.diffusion import diffusion_tendencies
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.physics.cumulus import bmj_adjust
from wrfchem_arc_interactions_tpu_torch.physics.cumulus_grell import grell_ensemble
from wrfchem_arc_interactions_tpu_torch.physics.cumulus_kf import kf_mass_flux
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import kessler
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.morrison import morrison
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.wsm6 import wsm6
from wrfchem_arc_interactions_tpu_torch.physics.mixactivate import activate
from wrfchem_arc_interactions_tpu_torch.physics.pbl import surface_and_pbl
from wrfchem_arc_interactions_tpu_torch.physics.pbl_mynn import mynn_column
from wrfchem_arc_interactions_tpu_torch.registry.state import State, advected_names
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils import trace

_CUMULUS = {CUScheme.BMJ: bmj_adjust, CUScheme.GRELL: grell_ensemble,
            CUScheme.KF: kf_mass_flux}


def _add(tend: Dict[str, torch.Tensor], more: Dict[str, torch.Tensor]) -> None:
    for k, v in more.items():
        tend[k] = tend.get(k, 0.0) + v


def pre_dynamics(state: State, grid: Grid, cfg: Config, hx: HaloOps, dt: float,
                 time_s) -> Tuple[State, Dict[str, torch.Tensor]]:
    """`time_s` is the model time (float32, as the reference carries it):
    the stochastic patterns' noise hashes the step round(time_s / dt)."""
    with trace.span("pre_physics"):
        phys, dyn = cfg.physics, cfg.dynamics
        tend: Dict[str, torch.Tensor] = {}
        state = dict(state)
        # held radiative heating applied every step (the rthraten pattern)
        if "rthraten_sw" in state:
            tend["th"] = state["rthraten_sw"] + state["rthraten_lw"]

        if phys.sf_sfclay_physics != SFScheme.NONE or phys.bl_pbl_physics != PBLScheme.NONE:
            pbl = mynn_column if phys.bl_pbl_physics == PBLScheme.MYNN else surface_and_pbl
            with trace.span("pbl"):
                state, pbl_tend = pbl(state, grid, cfg, dt)
                _add(tend, pbl_tend)

        if phys.tke_heat_flux > 0.0:
            # em_les's imposed kinematic surface heat flux [K m/s]: a theta
            # source in the lowest layer
            ph_full = grid.phb + state["ph"]
            dz0 = (ph_full[1] - ph_full[0]) / c.G
            src = torch.zeros_like(state["t"])
            src[0] = phys.tke_heat_flux / dz0
            _add(tend, {"th": src})

        if phys.cu_physics != CUScheme.NONE:
            with trace.span("cumulus"):
                # the cumulus_driver slot: tendencies held through the RK stages
                diag = diagnose(state, grid, cfg.moist_species())
                rho = 1.0 / (diag.alpha_d * diag.eps_ratio)
                ph_full = grid.phb + state["ph"]
                dz = (ph_full[1:] - ph_full[:-1]) / c.G
                cu_tend, precip = _CUMULUS[phys.cu_physics](diag.theta, state["qv"], diag.p_full,
                                                            rho, dz, dt)
                _add(tend, cu_tend)
                state["rainc"] = state["rainc"] + precip * dt

        if dyn.diff_opt.value != "none":
            with trace.span("diffusion"):
                _add(tend, diffusion_tendencies(state, grid, cfg, hx, dt, advected_names(cfg)))

        if dyn.sppt_amp > 0.0 or dyn.skebs_amp > 0.0:
            # stochastic physics: SPPT on the assembled tendencies, SKEBS on momentum
            step_no = int(np.round(np.float32(time_s) / np.float32(dt)))
            if dyn.sppt_amp > 0.0:
                pat = stoch.evolve_pattern(state["sppt_pattern"], hx, dt, step_no, seed=0)
                state["sppt_pattern"] = pat
                tend = stoch.apply_sppt(tend, pat, dyn.sppt_amp)
            if dyn.skebs_amp > 0.0:
                psi = stoch.evolve_pattern(state["skebs_psi"], hx, dt, step_no, seed=1)
                state["skebs_psi"] = psi
                du, dv = stoch.skebs_increments(psi, hx, dyn.skebs_amp,
                                                1.0 / grid.rdx, 1.0 / grid.rdy)
                _add(tend, {"u": du[None], "v": dv[None]})
        return state, tend


def post_dynamics(state: State, grid: Grid, cfg: Config, dt: float) -> State:
    with trace.span("post_physics"):
        mp = cfg.physics.mp_physics
        if mp == MPScheme.NONE:
            return state
        diag = diagnose(state, grid, cfg.moist_species())
        if mp == MPScheme.KESSLER:
            with trace.span("microphysics"):
                return kessler(state, diag, grid, dt)
        if mp == MPScheme.WSM6:
            with trace.span("microphysics"):
                return wsm6(state, diag, grid, cfg, dt)
        n_act = None
        if cfg.physics.progn and cfg.chem.chem_opt.value != "none":
            with trace.span("activation"):
                # ARC indirect effect: MOSAIC bins -> AR&G activation -> Nc
                exner = (diag.p_full / c.P0) ** c.RCP
                t_air = diag.theta * exner
                rho_air = 1.0 / (diag.alpha_d * diag.eps_ratio)
                w_c = 0.5 * (state["w"][:-1] + state["w"][1:])
                chem = {k: v for k, v in state.items() if k.startswith("chem_")}
                n_act, _ = activate(chem, t_air, diag.p_full, rho_air, w_c, _nbin(cfg))
        with trace.span("microphysics"):
            return morrison(state, diag, grid, cfg, dt, n_act=n_act)
