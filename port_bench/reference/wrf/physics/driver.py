"""Physics orchestration around the dynamics step (port of the JAX
package's `physics/driver.py`).

- `pre_dynamics`: tendencies computed once per dt and held through the RK
  stages, in the reference's order: the held radiative heating
  rthraten_sw + rthraten_lw, the LES surface heat flux and the subgrid
  diffusion.  Radiation and chemistry run as their own steppers on their
  alarms (`models.driver.Simulation`).
- `post_dynamics`: microphysics on the post-advection state: Kessler, or
  Morrison two-moment, which with ``progn`` and a chem package takes its
  activated droplet number from the MOSAIC bins through
  `mixactivate.activate` (the ARC indirect effect).

Cut to the options the benchmark's configurations hold: the surface
layer, the PBL schemes, cumulus, WSM6 and the stochastic physics of the
port were left out of the copy, and a configuration that asks for one is
refused.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from port_bench.reference.wrf.chem.driver import _nbin
from port_bench.reference.wrf.config import Config
from port_bench.reference.wrf.config.namelist import (
    CUScheme, MPScheme, PBLScheme, SFScheme,
)
from port_bench.reference.wrf.dycore.diagnostics import diagnose
from port_bench.reference.wrf.dycore.diffusion import diffusion_tendencies
from port_bench.reference.wrf.grid import Grid
from port_bench.reference.wrf.parallel.halo import HaloOps
from port_bench.reference.wrf.physics.microphysics.kessler import kessler
from port_bench.reference.wrf.physics.microphysics.morrison import morrison
from port_bench.reference.wrf.physics.mixactivate import activate
from port_bench.reference.wrf.registry.state import State, advected_names
from port_bench.reference.wrf.utils import constants as c



def _refuse(what: str) -> None:
    raise NotImplementedError(f"the benchmark's reference holds no {what}")


def _add(tend: Dict[str, torch.Tensor], more: Dict[str, torch.Tensor]) -> None:
    for k, v in more.items():
        tend[k] = tend.get(k, 0.0) + v


def pre_dynamics(state: State, grid: Grid, cfg: Config, hx: HaloOps, dt: float,
                 time_s) -> Tuple[State, Dict[str, torch.Tensor]]:
    """`time_s` is the model time (float32, as the reference carries it),
    which the port's stochastic physics reads; the copy holds none."""
    phys, dyn = cfg.physics, cfg.dynamics
    tend: Dict[str, torch.Tensor] = {}
    state = dict(state)
    # held radiative heating applied every step (the rthraten pattern)
    if "rthraten_sw" in state:
        tend["th"] = state["rthraten_sw"] + state["rthraten_lw"]

    if phys.sf_sfclay_physics != SFScheme.NONE or phys.bl_pbl_physics != PBLScheme.NONE:
        _refuse("surface layer or PBL scheme")

    if phys.tke_heat_flux > 0.0:
        # em_les's imposed kinematic surface heat flux [K m/s]: a theta
        # source in the lowest layer
        ph_full = grid.phb + state["ph"]
        dz0 = (ph_full[1] - ph_full[0]) / c.G
        src = torch.zeros_like(state["t"])
        src[0] = phys.tke_heat_flux / dz0
        _add(tend, {"th": src})

    if phys.cu_physics != CUScheme.NONE:
        _refuse("cumulus scheme")

    if dyn.diff_opt.value != "none":
        _add(tend, diffusion_tendencies(state, grid, cfg, hx, dt, advected_names(cfg)))

    if dyn.sppt_amp > 0.0 or dyn.skebs_amp > 0.0:
        _refuse("stochastic physics")
    return state, tend


def post_dynamics(state: State, grid: Grid, cfg: Config, dt: float) -> State:
    mp = cfg.physics.mp_physics
    if mp == MPScheme.NONE:
        return state
    diag = diagnose(state, grid, cfg.moist_species())
    if mp == MPScheme.KESSLER:
        return kessler(state, diag, grid, dt)
    if mp != MPScheme.MORRISON2:
        _refuse(f"microphysics {mp.value}")
    n_act = None
    if cfg.physics.progn and cfg.chem.chem_opt.value != "none":
        # ARC indirect effect: MOSAIC bins -> AR&G activation -> Nc
        exner = (diag.p_full / c.P0) ** c.RCP
        t_air = diag.theta * exner
        rho_air = 1.0 / (diag.alpha_d * diag.eps_ratio)
        w_c = 0.5 * (state["w"][:-1] + state["w"][1:])
        chem = {k: v for k, v in state.items() if k.startswith("chem_")}
        n_act, _ = activate(chem, t_air, diag.p_full, rho_air, w_c, _nbin(cfg))
    return morrison(state, diag, grid, cfg, dt, n_act=n_act)
