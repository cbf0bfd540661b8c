"""Time-integration driver (port of the JAX package's `models/driver.py`,
the single-domain run loop).

A `Simulation` owns the steppers, the step clock and the radt/chemdt alarm
cadence.  The reference compiles three executables — "main" every step,
"rad" and "chem" on their alarms — and the port keeps the same three
steppers in the same alarm order within a step: chem, then rad, then main.
Model time reaches the solar ephemeris (of the rad and of the chem stepper,
whose photolysis rates follow the sun) and the McICA seed as float32, as
the reference's ``t_now = jnp.float32(time_s)`` does.  Constant emissions
(a dict of (ny, nx) fluxes) feed every chem call, as the reference's
``"chem"`` stepper passes them.  History, restart, tslist, the hourly
emission stream and nesting come with later slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.driver import chem_driver
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.dycore.solve import step as dyn_step
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.physics.driver import post_dynamics, pre_dynamics
from wrfchem_arc_interactions_tpu_torch.physics.radiation.driver import radiation_driver
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils.clock import ModelClock
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike, resolve_device, sync
from wrfchem_arc_interactions_tpu_torch.utils.support import SLICE_RUN, check_config, check_grid


class Simulation:
    def __init__(self, cfg: Config, grid: Grid, state: State,
                 device: DeviceLike = None,
                 emissions: Optional[Mapping[str, torch.Tensor]] = None):
        """Run `cfg` from (grid, state) on `device` (default ``cuda``; raises
        if there is none and the CPU was not asked for).  The grid, the state
        and the `emissions` ({species or ``elev_`` species: (ny, nx) flux,
        ``heat_mw``: (ny, nx)}, used under ``emiss_opt``) are moved there."""
        check_config(cfg)
        check_grid(grid)
        if emissions is not None and not isinstance(emissions, Mapping):
            raise NotImplementedError(
                f"an emission stream ({type(emissions).__name__}) is not ported yet; "
                f"it comes with {SLICE_RUN}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.grid = grid.to(self.device)
        self.state = {k: v.to(self.device) for k, v in state.items()}
        self.emissions = (None if emissions is None
                          else {k: v.to(self.device) for k, v in emissions.items()})
        self.dt = cfg.time_control.dt
        self.time_s = 0.0
        self.step_idx = 0
        self.hx = HaloOps(bc_x=cfg.dynamics.bc_x, bc_y=cfg.dynamics.bc_y)
        # calendar clock for the solar geometry (utils/clock.py)
        self.clock = ModelClock(cfg.time_control.start_date)
        self._solar_off = self.clock.utc_offset_s()
        self._julian = self.clock.julian_day()

        # alarm cadences in steps (0 = never)
        ph = cfg.physics
        self.rad_every = max(1, round(ph.radt_s / self.dt)) \
            if ph.ra_sw_physics.value != "none" or ph.ra_lw_physics.value != "none" else 0
        self.chem_every = max(1, round(cfg.chem.chemdt_s / self.dt)) \
            if cfg.chem.chem_opt.value != "none" else 0
        self._steppers: Dict[str, Callable] = {}

    def _solar_time(self, t_s: np.float32):
        """(UTC seconds, julian day) of model time `t_s`, in float32 in the
        reference's order: the julian day advances with model time."""
        ts = t_s + np.float32(self._solar_off)
        return ts, np.float32(self._julian) + ts / np.float32(86400.0)

    def _stepper(self, key: str) -> Callable:
        """The (state, grid, t_s) -> state function of one executable;
        `t_s` is the model time as a numpy float32."""
        if key not in self._steppers:
            cfg, hx, dt = self.cfg, self.hx, self.dt
            if key == "main":
                def fn(s, g, t_s):
                    s, tend = pre_dynamics(s, g, cfg, hx)
                    s = dyn_step(s, g, cfg, hx, dt, tend)
                    return post_dynamics(s, g, cfg, dt)
            elif key == "rad":
                def fn(s, g, t_s):
                    ts, jd = self._solar_time(t_s)
                    return radiation_driver(s, g, cfg, ts, julian_day=jd)
            elif key == "chem":
                emissions = self.emissions

                def fn(s, g, t_s):
                    ts, jd = self._solar_time(t_s)
                    return chem_driver(s, g, cfg, cfg.chem.chemdt_s, time_s=ts,
                                       emissions=emissions, julian_day=jd)
            else:
                raise ValueError(key)
            self._steppers[key] = fn
        return self._steppers[key]

    def sync(self):
        """Block until every queued step has executed (window barrier)."""
        sync(self.device)

    def advance(self, n_steps: int):
        """Advance n steps.  On the GPU the steps are queued asynchronously;
        close a timed window with `sync()`."""
        for _ in range(n_steps):
            do_rad = self.rad_every > 0 and self.step_idx % self.rad_every == 0
            do_chem = self.chem_every > 0 and self.step_idx % self.chem_every == 0
            t_now = np.float32(self.time_s)
            if do_chem:
                self.state = self._stepper("chem")(self.state, self.grid, t_now)
            if do_rad:
                self.state = self._stepper("rad")(self.state, self.grid, t_now)
            self.state = self._stepper("main")(self.state, self.grid, t_now)
            self.step_idx += 1
            self.time_s += self.dt
