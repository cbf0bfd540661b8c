"""Physics orchestration around the dynamics step (port of the JAX
package's `physics/driver.py`, the part that config 3 runs).

- `pre_dynamics`: tendencies computed once per dt and held through the RK
  stages — the held radiative heating rthraten_sw + rthraten_lw and the
  subgrid diffusion.  Radiation and chemistry run as their own steppers on
  their alarms (`models.driver.Simulation`).  Surface layer, PBL, cumulus
  and stochastic physics come with later slices
  (`utils.support.check_config` refuses them).
- `post_dynamics`: microphysics on the post-advection state (Kessler).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import MPScheme
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.dycore.diffusion import diffusion_tendencies
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.physics.microphysics.kessler import kessler
from wrfchem_arc_interactions_tpu_torch.registry.state import State, advected_names


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
    return state
