"""Physics orchestration around the dynamics step (port of the JAX
package's `physics/driver.py`, the part that configs 3 and 4 run).

- `pre_dynamics`: tendencies computed once per dt and held through the RK
  stages — the held radiative heating rthraten_sw + rthraten_lw and the
  subgrid diffusion.  Radiation and chemistry run as their own steppers on
  their alarms (`models.driver.Simulation`).  Surface layer, PBL, cumulus
  and stochastic physics come with later slices
  (`utils.support.check_config` refuses them).
- `post_dynamics`: microphysics on the post-advection state: Kessler, or
  Morrison two-moment, which with ``progn`` and a chem package takes its
  activated droplet number from the MOSAIC bins through
  `mixactivate.activate` (the ARC indirect effect).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.chem.driver import _nbin
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import MPScheme
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.dycore.diffusion import diffusion_tendencies
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import kessler
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.morrison import morrison
from wrfchem_arc_interactions_tpu_torch.physics.mixactivate import activate
from wrfchem_arc_interactions_tpu_torch.registry.state import State, advected_names
from wrfchem_arc_interactions_tpu_torch.utils import constants as c


def pre_dynamics(state: State, grid: Grid, cfg: Config,
                 hx: HaloOps) -> Tuple[State, Dict[str, torch.Tensor]]:
    tend: Dict[str, torch.Tensor] = {}
    # held radiative heating applied every step (the rthraten pattern)
    if "rthraten_sw" in state:
        tend["th"] = state["rthraten_sw"] + state["rthraten_lw"]
    if cfg.dynamics.diff_opt.value != "none":
        d = diffusion_tendencies(state, grid, cfg, hx, advected_names(cfg))
        for k, v in d.items():
            tend[k] = tend.get(k, 0.0) + v
    return state, tend


def post_dynamics(state: State, grid: Grid, cfg: Config, dt: float) -> State:
    if cfg.physics.mp_physics == MPScheme.KESSLER:
        diag = diagnose(state, grid, cfg.moist_species())
        state = kessler(state, diag, grid, dt)
    elif cfg.physics.mp_physics == MPScheme.MORRISON2:
        diag = diagnose(state, grid, cfg.moist_species())
        n_act = None
        if cfg.physics.progn and cfg.chem.chem_opt.value != "none":
            # ARC indirect effect: MOSAIC bins -> AR&G activation -> Nc
            exner = (diag.p_full / c.P0) ** c.RCP
            t_air = diag.theta * exner
            rho_air = 1.0 / (diag.alpha_d * diag.eps_ratio)
            w_c = 0.5 * (state["w"][:-1] + state["w"][1:])
            chem = {k: v for k, v in state.items() if k.startswith("chem_")}
            n_act, _ = activate(chem, t_air, diag.p_full, rho_air, w_c, _nbin(cfg))
        state = morrison(state, diag, grid, cfg, dt, n_act=n_act)
    return state
