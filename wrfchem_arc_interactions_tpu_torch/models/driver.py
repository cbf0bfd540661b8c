"""Time-integration driver (port of the JAX package's `models/driver.py`,
the single-domain run loop).

A `Simulation` owns the steppers, the step clock and the alarms (radt,
chemdt, history, restart, auxhist), the NaN guard, the tslist series and
the hourly emission stream.  Each step is a span of `utils.trace`, and in
it each executable call and the output; with tracing on, `trace.flush`
prints the ``Timing for main`` line of each step from its span's device
time, and `advance(..., phase_timing=True)` adds each executable's
synchronised time to `phase_times`.  The reference compiles three
executables — "main" every step, "rad" and "chem" on their alarms — and the
port keeps the same steppers in the same alarm order within a step: chem,
then rad, then main.  Model time reaches the solar ephemeris (of the rad
and of the chem stepper, whose photolysis rates follow the sun) and the
McICA seed as float32, as the reference's ``t_now = jnp.float32(time_s)``
does.  Emissions are a dict of constant (ny, nx) fluxes, fed to every chem
call, or an `io.auxinput.EmissionStream`, whose snapshots go to the device
once, when the `Simulation` is built.

Every alarm counts from `step_idx`, so a run restarted from a restart file
(`io.history.read_restart`, then `step_idx` and `time_s` set from it) writes
and steps as the unbroken run does, bit for bit.

Real-data runs: with specified lateral boundaries the main stepper applies
the Davies zones (`models.lateral_bc`) toward ``sim.boundary`` after the
post-dynamics physics, at the step's start time as the reference does;
the caller swaps ``sim.boundary`` for the next segment as model time
crosses its end.  With ``grid_fdda`` the analysis nudging
(`models.fdda`) joins the held physics tendencies before the RK loop.

On a process mesh (``mesh=parallel.mesh.make_mesh(...)``, one block per
rank) every rank passes the same global grid, state, boundary, emissions
and nudging target; the `Simulation` keeps the rank's block of each
(`parallel.sharded.place`) and steps it with the mesh's halos.  The
steppers and alarms are the same.  The output streams gather the state to
rank 0, which alone writes (the same bytes as a run on one block); the
tslist points are recorded by the rank that owns them and gathered at the
end of every `advance`.  `gather_state` brings the global state to rank 0.
`phase_times` and the spans are this rank's.

`full_step` is the reference's one-call step (radiation, the physics, the
dynamics, chemistry and the boundary forcing) for callers that drive the
pieces without a `Simulation`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.chem.driver import chem_driver
from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
from wrfchem_arc_interactions_tpu_torch.dycore.solve import step as dyn_step
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.io import diags
from wrfchem_arc_interactions_tpu_torch.io import history as hio
from wrfchem_arc_interactions_tpu_torch.io.auxinput import EmissionStream
from wrfchem_arc_interactions_tpu_torch.models.fdda import apply_nudging
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import make_specified_bc
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
from wrfchem_arc_interactions_tpu_torch.parallel.sharded import (
    gather, halo_ops_for, place, place_fields,
)
from wrfchem_arc_interactions_tpu_torch.physics.driver import post_dynamics, pre_dynamics
from wrfchem_arc_interactions_tpu_torch.physics.radiation.driver import radiation_driver
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import trace
from wrfchem_arc_interactions_tpu_torch.utils.checks import all_finite
from wrfchem_arc_interactions_tpu_torch.utils.clock import ModelClock
from wrfchem_arc_interactions_tpu_torch.utils.device import DeviceLike, resolve_device, sync
from wrfchem_arc_interactions_tpu_torch.utils.logging import log
from wrfchem_arc_interactions_tpu_torch.utils.support import check_config

# pending tslist values are brought to the host at least this often
_TS_PENDING_MAX = 1024


def full_step(state: State, grid: Grid, cfg: Config, hx: HaloOps, dt: float,
              do_radiation: bool, do_chem: bool, time_s: float,
              boundary=None, spec_bc=None) -> State:
    """One complete model step in the reference's order: radiation (with
    `do_radiation`), the pre-dynamics physics, the dynamics, the
    post-dynamics physics, chemistry (with `do_chem`), then the Davies
    specified/relaxation forcing toward `boundary` when boundary data and
    its operator `spec_bc` are given.  As in the reference, radiation's sun
    stands at UTC second `time_s` of the default julian day, and the chem
    call's at the chem driver's defaults (0 s of that day).

    `Simulation` runs the same pieces as separate steppers and, on a step
    where both alarms ring, calls chemistry first: from 00 UTC of the
    default julian day, where its calendar puts the sun where `full_step`
    does, its `advance(1)` is the chem call followed by ``full_step(...,
    do_radiation=True, do_chem=False)``."""
    t_s = np.float32(time_s)
    if do_radiation and (cfg.physics.ra_sw_physics.value != "none"
                         or cfg.physics.ra_lw_physics.value != "none"):
        state = radiation_driver(state, grid, cfg, t_s)
    state, tend = pre_dynamics(state, grid, cfg, hx, dt, t_s)
    state = dyn_step(state, grid, cfg, hx, dt, tend)
    state = post_dynamics(state, grid, cfg, dt)
    if do_chem and cfg.chem.chem_opt.value != "none":
        state = chem_driver(state, grid, cfg, cfg.chem.chemdt_s)
    if boundary is not None and spec_bc is not None:
        state = spec_bc.apply(state, boundary, t_s, dt, hx=hx)
    return state


class Simulation:
    def __init__(self, cfg: Config, grid: Grid, state: State,
                 mesh=None, check_nans: bool = False,
                 output_dir: Optional[str] = None,
                 boundary=None, emissions=None, fdda=None,
                 device: DeviceLike = None):
        """Run `cfg` from (grid, state) on `device` (default ``cuda``; raises
        if there is none and the CPU was not asked for).  The grid, the state
        and the emissions — a dict ({species or ``elev_`` species: (ny, nx)
        flux tensor, ``heat_mw``: (ny, nx)}, used under ``emiss_opt``) or an
        `EmissionStream` — are moved there.  With `output_dir`, the history,
        restart and auxhist alarms of ``cfg.time_control`` write files there;
        with `check_nans`, every step checks theta (one device sync a step).
        `boundary` (a `models.lateral_bc.LateralBoundary`) is required with
        specified lateral boundaries; `fdda` (the same kind of two-snapshot
        target) is the analysis that ``cfg.fdda.grid_fdda`` nudges toward.
        Both are moved to the device, also when set later.  `mesh` (a
        `parallel.mesh.Mesh`) runs this rank's block of the global inputs,
        on the mesh's device unless `device` says otherwise."""
        check_config(cfg)
        if not (emissions is None or isinstance(emissions, (Mapping, EmissionStream))):
            raise TypeError(f"emissions must be a dict of (ny, nx) fluxes or an "
                            f"EmissionStream, not {type(emissions).__name__}")
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None and device is None
                                     else device)
        self.cfg = cfg
        self._ny, self._nx = grid.ny, grid.nx          # the global domain
        if mesh is not None:
            if self.device != mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {mesh.device}")
            self.state, self.grid = place(state, grid, mesh, cfg)
            # the diagnostics stream reads the global grid on rank 0
            self._grid_out = grid.to("cpu") if mesh.rank == 0 else None
        else:
            self.grid = grid.to(self.device)
            self.state = {k: v.to(self.device) for k, v in state.items()}
            self._grid_out = self.grid
        self.boundary = boundary
        # analysis-nudging target, active when cfg.fdda.grid_fdda is set
        self.fdda = fdda if cfg.fdda.grid_fdda else None
        self.spec_bc = None
        if BCKind.SPECIFIED in (cfg.dynamics.bc_x, cfg.dynamics.bc_y):
            if boundary is None:
                raise ValueError("specified lateral boundaries need a LateralBoundary")
            self.spec_bc = make_specified_bc(
                cfg, self.grid, names=("u", "v", "w", "t", "mu", "ph") + cfg.moist_species(),
                mesh=mesh)
        self._stream_snaps = None
        if isinstance(emissions, EmissionStream):
            self.emissions = emissions
            self._stream_snaps = [
                self._place({k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in snap.items()}) for snap in emissions.snaps]
        else:
            self.emissions = None if emissions is None else self._place(emissions)
        self.check_nans = check_nans
        self.output_dir = output_dir
        self.dt = cfg.time_control.dt
        self.time_s = 0.0
        self.step_idx = 0
        self.hx = halo_ops_for(cfg, mesh)
        # calendar clock for the solar geometry and the log's timestamps
        self.clock = ModelClock(cfg.time_control.start_date)
        self._solar_off = self.clock.utc_offset_s()
        self._julian = self.clock.julian_day()

        # alarm cadences in steps (0 = never)
        tc, ph = cfg.time_control, cfg.physics
        self.hist_every = max(1, round(tc.history_interval_s / self.dt)) \
            if (output_dir and tc.history_interval_s > 0) else 0
        self.rst_every = max(1, round(tc.restart_interval_s / self.dt)) \
            if (output_dir and tc.restart_interval_s > 0) else 0
        self.aux_every = max(1, round(tc.auxhist_interval_s / self.dt)) \
            if (output_dir and tc.auxhist_interval_s > 0) else 0
        self.rad_every = max(1, round(ph.radt_s / self.dt)) \
            if ph.ra_sw_physics.value != "none" or ph.ra_lw_physics.value != "none" else 0
        self.chem_every = max(1, round(cfg.chem.chemdt_s / self.dt)) \
            if cfg.chem.chem_opt.value != "none" else 0
        self._steppers: Dict[str, Callable] = {}
        self._init_ts(grid.mub)

    def _place(self, fields: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Global fields on the device: this rank's block under a mesh."""
        if self.mesh is None:
            return {k: v.to(self.device) for k, v in fields.items()}
        return place_fields(fields, self.mesh, self._ny, self._nx)

    def _place_window(self, bdy):
        """A `LateralBoundary` (two global snapshots) on the device."""
        if bdy is None:
            return None
        if self.mesh is None:
            return bdy.to(self.device)
        return dataclasses.replace(bdy, lo=self._place(bdy.lo), hi=self._place(bdy.hi))

    @property
    def boundary(self):
        return self._boundary

    @boundary.setter
    def boundary(self, bdy):
        self._boundary = self._place_window(bdy)

    @property
    def fdda(self):
        return self._fdda

    @fdda.setter
    def fdda(self, target):
        self._fdda = self._place_window(target)

    def _solar_time(self, t_s: np.float32):
        """(UTC seconds, julian day) of model time `t_s`, in float32 in the
        reference's order: the julian day advances with model time."""
        ts = t_s + np.float32(self._solar_off)
        return ts, np.float32(self._julian) + ts / np.float32(86400.0)

    def _stepper(self, key: str) -> Callable:
        """The (state, grid, t_s) -> state function of one executable
        (``chem_stream`` takes the emissions as a fourth argument); `t_s` is
        the model time as a numpy float32."""
        if key not in self._steppers:
            cfg, hx, dt = self.cfg, self.hx, self.dt
            if key == "main":
                def fn(s, g, t_s):
                    s, tend = pre_dynamics(s, g, cfg, hx, dt, t_s)
                    if self.fdda is not None:
                        tend = apply_nudging(tend, s, self.fdda, t_s, cfg)
                    s = dyn_step(s, g, cfg, hx, dt, tend)
                    s = post_dynamics(s, g, cfg, dt)
                    if self.spec_bc is not None:
                        s = self.spec_bc.apply(s, self.boundary, t_s, dt, hx=hx)
                    return s
            elif key == "rad":
                def fn(s, g, t_s):
                    ts, jd = self._solar_time(t_s)
                    return radiation_driver(s, g, cfg, ts, julian_day=jd)
            elif key == "chem_stream":
                def fn(s, g, t_s, emissions):
                    ts, jd = self._solar_time(t_s)
                    return chem_driver(s, g, cfg, cfg.chem.chemdt_s, time_s=ts,
                                       emissions=emissions, julian_day=jd)
            elif key == "chem":
                with_emissions = self._stepper("chem_stream")
                emissions = self.emissions

                def fn(s, g, t_s):
                    return with_emissions(s, g, t_s, emissions)
            else:
                raise ValueError(key)
            self._steppers[key] = fn
        return self._steppers[key]

    def sync(self):
        """Block until every queued step has executed (window barrier)."""
        sync(self.device)

    def advance(self, n_steps: int,
                on_step: Optional[Callable[["Simulation"], None]] = None,
                phase_timing: bool = False):
        """Advance n steps; call `on_step(self)` after each.  On the GPU the
        steps are queued asynchronously.  Each step, and in it each
        executable call (chem, rad, main) and the output, is a span
        (`utils.trace`).  With `phase_timing` every executable's span ends
        in a device synchronisation and its host seconds add to
        `self.phase_times`; where tracing is off, it is on for this call
        alone.  The reference fetches one element of a field the phase
        writes for this; on CUDA one synchronisation closes every queued
        phase, whatever it wrote."""
        if phase_timing and not hasattr(self, "phase_times"):
            self.phase_times = {"chem": 0.0, "rad": 0.0, "main": 0.0}
        # phase timing reads the executables' spans; a recorder of its own
        # keeps a step's spans no longer than the step
        own = trace.start(self.device) if phase_timing and not trace.enabled() else None
        try:
            for _ in range(n_steps):
                with trace.span("step", step=self.step_idx, report=self._report_step):
                    self._step(phase_timing)
                if own is not None:
                    own.discard()
                if on_step is not None:
                    on_step(self)
        finally:
            if own is not None:
                trace.stop()
        if self.mesh is not None:
            self._ts_materialise()

    def _step(self, phase_timing: bool):
        do_rad = self.rad_every > 0 and self.step_idx % self.rad_every == 0
        do_chem = self.chem_every > 0 and self.step_idx % self.chem_every == 0
        t_now = np.float32(self.time_s)
        if do_chem:
            with self._phase("chem", phase_timing):
                if self._stream_snaps is not None:
                    emis = self._stream_snaps[self.emissions.index_at(self.time_s)]
                    self.state = self._stepper("chem_stream")(self.state, self.grid,
                                                              t_now, emis)
                else:
                    self.state = self._stepper("chem")(self.state, self.grid, t_now)
        if do_rad:
            with self._phase("rad", phase_timing):
                self.state = self._stepper("rad")(self.state, self.grid, t_now)
        with self._phase("main", phase_timing):
            self.state = self._stepper("main")(self.state, self.grid, t_now)
        self.step_idx += 1
        self.time_s += self.dt
        if self.check_nans and not bool(all_finite(self.state["t"], self.hx)):
            raise FloatingPointError(
                f"NaN in theta at step {self.step_idx} (t={self.time_s}s)")
        if self._ts_points:
            self._record_ts()
        self._write_output()

    def _phase(self, name: str, timed: bool):
        """The span of one executable call; `timed`: closed by a
        synchronisation, its host seconds added to ``phase_times``."""
        return self._timed_phase(name) if timed else trace.span(name)

    @contextlib.contextmanager
    def _timed_phase(self, name: str):
        with trace.span(name) as sp:
            yield
            self.sync()
        self.phase_times[name] += sp.host_s

    def _report_step(self, step: int, seconds: float):
        """WRF's per-step timing line, from a step's span at `trace.flush`."""
        log(f"Timing for main: time {self.clock.timestamp((step + 1) * self.dt)} "
            f"on domain 1: {seconds:.5f} elapsed seconds", level=2)

    def gather_state(self, dst: int = 0) -> Optional[State]:
        """The global state on the host of mesh rank `dst` (None on the
        other ranks; every rank must call it).  Without a mesh, host
        copies of the state."""
        return gather(self.state, self.mesh, dst)

    def _write_output(self):
        """The history, restart and auxhist alarms of the step just taken.
        Under a mesh the state is gathered to rank 0, which writes."""
        n, out = self.step_idx, self.output_dir
        hist = self.hist_every and n % self.hist_every == 0
        rst = self.rst_every and n % self.rst_every == 0
        aux = self.aux_every and n % self.aux_every == 0
        if not (hist or rst or aux):
            return
        with trace.span("output"):
            state = self.state if self.mesh is None else self.gather_state()
            if state is None:
                return
            ext = hio.default_extension()
            if hist:
                hio.write_history(f"{out}/hist_{n:06d}{ext}", self.cfg, self._grid_out,
                                  state, self.time_s)
            if rst:
                hio.write_restart(f"{out}/restart_{n:06d}{ext}", self.cfg, state, n,
                                  self.time_s)
            if aux:
                diags.write_diags(f"{out}/auxdiag_{n:06d}{ext}", self.cfg, self._grid_out,
                                  state, self.time_s)

    # -- tslist: per-step surface series at registered (label, j, i) points

    def _init_ts(self, mub_global: torch.Tensor):
        """The points' indices on the device and the base column mass at
        each on the host.  Each step gathers the points' values into one
        small device tensor; the host reads them only when `ts_series` is
        read or written.  Under a mesh a rank records the points of its
        block (zeros for the others), and `_ts_materialise` takes each
        point from the rank that owns it."""
        self._ts_points = tuple(self.cfg.time_control.ts_points)
        self._ts_rows: Dict[str, list] = {label: [] for label, _, _ in self._ts_points}
        self._ts_pending: list = []
        if not self._ts_points:
            return
        jj = [j for _, j, _ in self._ts_points]
        ii = [i for _, _, i in self._ts_points]
        by, bx = self.grid.ny, self.grid.nx
        mx = 1 if self.mesh is None else self.mesh.mesh_x
        self._ts_owner = [(j // by) * mx + i // bx for j, i in zip(jj, ii)]
        rank = 0 if self.mesh is None else self.mesh.rank
        self._ts_j = torch.tensor([j % by for j in jj], device=self.device)
        self._ts_i = torch.tensor([i % bx for i in ii], device=self.device)
        self._ts_mine = torch.tensor([o == rank for o in self._ts_owner], device=self.device)
        mub = mub_global.cpu().numpy()
        self._ts_mub = [float(mub[j, i]) for j, i in zip(jj, ii)]
        # gathered per point: these fields at the surface (rainnc and qv
        # where the state has them), then |w| max over the column
        self._ts_fields = ("t", "u", "v", "mu") + tuple(
            k for k in ("rainnc", "qv") if k in self.state)

    def _record_ts(self):
        s = self.state
        planes = [s[k][0] if s[k].dim() == 3 else s[k] for k in self._ts_fields]
        j, i = self._ts_j, self._ts_i
        vals = torch.cat([torch.stack(planes)[:, j, i],
                          s["w"][:, j, i].abs().amax(0, keepdim=True)])
        if self.mesh is not None:
            vals = torch.where(self._ts_mine, vals, torch.zeros_like(vals))
        self._ts_pending.append((self.time_s, vals))
        if len(self._ts_pending) >= _TS_PENDING_MAX:
            self._ts_materialise()

    def _ts_materialise(self):
        """Turn the pending device values into the reference's rows (one
        dict per point and step) in one host copy."""
        if not self._ts_pending:
            return
        vals = torch.stack([v for _, v in self._ts_pending])
        if self.mesh is not None:
            # every rank's points; each point from the rank that owns it
            parts = [p.cpu() for p in self.mesh.all_gather(vals)]
            vals = torch.stack([parts[o][:, :, p] for p, o in enumerate(self._ts_owner)],
                               dim=-1)
        vals = vals.cpu().numpy()
        p_top = self.grid.p_top
        for (time_s, _), v in zip(self._ts_pending, vals):
            for p, (label, _, _) in enumerate(self._ts_points):
                x = dict(zip(self._ts_fields, v[:-1, p]))
                row = {
                    "time_s": time_s,
                    "t_sfc": float(x["t"]) + 300.0,
                    "u_sfc": float(x["u"]),
                    "v_sfc": float(x["v"]),
                    "w_max": float(v[-1, p]),
                    "psfc": float(x["mu"]) + self._ts_mub[p] + p_top,
                    "rainnc": float(x["rainnc"]) if "rainnc" in x else 0.0,
                }
                if "qv" in x:
                    row["qv_sfc"] = float(x["qv"])
                self._ts_rows[label].append(row)
        self._ts_pending = []

    @property
    def ts_series(self) -> Dict[str, list]:
        """{label: [row per step]}, each row a dict of time_s, t_sfc, u_sfc,
        v_sfc, w_max, psfc, rainnc and (with moisture) qv_sfc."""
        self._ts_materialise()
        return self._ts_rows

    def write_tslist(self, out_dir: str):
        """Write each registered point's series as <label>.TS (one header
        and one line per step)."""
        os.makedirs(out_dir, exist_ok=True)
        for label, rows in self.ts_series.items():
            path = os.path.join(out_dir, f"{label}.TS")
            with open(path, "w") as f:
                if rows:
                    cols = list(rows[0].keys())
                    f.write(" ".join(cols) + "\n")
                    for r in rows:
                        f.write(" ".join(f"{r[c]:.6g}" for c in cols) + "\n")
        return [os.path.join(out_dir, f"{k}.TS") for k in self.ts_series]

    def run_seconds(self, seconds: float, **kw):
        self.advance(int(round(seconds / self.dt)), **kw)
