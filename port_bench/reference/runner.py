"""The reference's run loop: the frozen plain path stepped as the port's
`Simulation.advance` steps its executables.

A model step n of a configuration with alarms every `chem_every` and
`rad_every` steps is: the chem call (if n is a multiple of chem_every),
then the rad call (if of rad_every), then the main step (the pre-dynamics
physics, the dynamics, the post-dynamics physics).  Model time reaches the
sun and the McICA seed as float32 seconds of the start date's UTC day, as
the port's run loop passes them.

`precision` picks the control's arithmetic: ``float32`` is the reference;
``tf32`` lets float32 matrix products run in TF32; ``bfloat16`` stores
every float32 field of the state in bfloat16 between executables (a state
kept in half the bytes).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from port_bench.reference.wrf.chem.driver import chem_driver
from port_bench.reference.wrf.config import namelist
from port_bench.reference.wrf.dycore.solve import step as dyn_step
from port_bench.reference.wrf.grid import make_grid
from port_bench.reference.wrf.models import ideal, soundings
from port_bench.reference.wrf.parallel.halo import HaloOps
from port_bench.reference.wrf.physics.driver import post_dynamics, pre_dynamics
from port_bench.reference.wrf.physics.radiation.driver import radiation_driver
from port_bench.reference.wrf.registry.state import advected_names
from port_bench.reference.wrf.utils.clock import ModelClock
from port_bench.reference.wrf.utils.device import resolve_device

PRECISIONS = ("float32", "tf32", "bfloat16")

# the cases whose grid `ideal.make_case` makes from a base sounding alone,
# before their state, and that sounding
GRID_SOUNDINGS = {"warm_bubble": "constant_n2_theta", "squall2d_x": "weisman_klemp_theta",
                  "squall2d_y": "weisman_klemp_theta", "quarter_ss": "weisman_klemp_theta",
                  "quiescent": "constant_n2_theta"}


class Model:
    def __init__(self, cfg: namelist.Config, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
        self.cfg, self.precision = cfg, precision
        self.dt = cfg.time_control.dt
        self.hx = HaloOps(bc_x=cfg.dynamics.bc_x, bc_y=cfg.dynamics.bc_y,
                          fuse=cfg.parallel.halo_fuse)
        clock = ModelClock(cfg.time_control.start_date)
        self._solar_off, self._julian = clock.utc_offset_s(), clock.julian_day()
        ph = cfg.physics
        rad = ph.ra_sw_physics.value != "none" or ph.ra_lw_physics.value != "none"
        self.rad_every = max(1, round(ph.radt_s / self.dt)) if rad else 0
        self.chem_every = (max(1, round(cfg.chem.chemdt_s / self.dt))
                           if cfg.chem.chem_opt.value != "none" else 0)

    def scalars(self) -> int:
        """The advected scalars' count."""
        return len(advected_names(self.cfg))

    def case(self, name: str, device, **kw):
        """(grid, state) of the named ideal case."""
        return ideal.make_case(self.cfg, name, device=device, **kw)

    def grid(self, name: str, device):
        """The named ideal case's grid alone, where the case makes it from
        its base sounding before, and apart from, its state (as
        `ideal.make_case` does); else the whole case's."""
        sounding = GRID_SOUNDINGS.get(name)
        if sounding is None:
            return self.case(name, device)[0]
        return make_grid(self.cfg, getattr(soundings, sounding)(), resolve_device(device))

    def _solar_time(self, t_s: np.float32):
        ts = t_s + np.float32(self._solar_off)
        return ts, np.float32(self._julian) + ts / np.float32(86400.0)

    def _lower(self, state: dict) -> dict:
        if self.precision != "bfloat16":
            return state
        return {k: v.to(torch.bfloat16).float() if v.dtype == torch.float32 else v
                for k, v in state.items()}

    @contextlib.contextmanager
    def _arithmetic(self):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def _time(self, n: int):
        t_now = np.float32(n * self.dt)
        return (t_now,) + self._solar_time(t_now)

    def chem(self, state: dict, grid, n: int) -> dict:
        """The chem call at step `n`."""
        _, ts, jd = self._time(n)
        with self._arithmetic():
            return chem_driver(self._lower(state), grid, self.cfg, self.cfg.chem.chemdt_s,
                               time_s=ts, emissions=None, julian_day=jd)

    def rad(self, state: dict, grid, n: int) -> dict:
        """The rad call at step `n`."""
        _, ts, jd = self._time(n)
        with self._arithmetic():
            return radiation_driver(self._lower(state), grid, self.cfg, ts, julian_day=jd)

    def main(self, state: dict, grid, n: int) -> dict:
        """The main step `n`: the pre-dynamics physics, the dynamics, the
        post-dynamics physics."""
        cfg, dt, hx = self.cfg, self.dt, self.hx
        t_now, _, _ = self._time(n)
        with self._arithmetic():
            state, tend = pre_dynamics(self._lower(state), grid, cfg, hx, dt, t_now)
            state = dyn_step(state, grid, cfg, hx, dt, tend)
            return post_dynamics(state, grid, cfg, dt)

    def step(self, state: dict, grid, n: int) -> dict:
        """Model step `n` (the step index the alarms count) of `state`."""
        if self.chem_every and n % self.chem_every == 0:
            state = self.chem(state, grid, n)
        if self.rad_every and n % self.rad_every == 0:
            state = self.rad(state, grid, n)
        return self.main(state, grid, n)
