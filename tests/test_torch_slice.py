"""The port as a whole against the JAX package: the squall-line case
construction and `Simulation.advance` with radiation and chemistry off
(slice 1's path) and on (BASELINE config 3) on small grids, both on the
CPU.

Measured on the CPU (x86-64, torch 2.13; the case is deterministic): the
grids are bit-identical and the initial states agree to float32 rounding.
After 5 steps at nx=32, ny=8, nz=20, max |d| / max |field| is 1.8e-5 (mu),
6.6e-5 (u), 1.4e-6 (t), 2.7e-7 (qv), 2.1e-7 (phi, at the magnitude of
phb) and 1.5e-3 (w); the reference run again from theta changed by one
ulp differs from itself by 2.7e-5, 5.5e-5, 1.2e-6, 2.7e-7, 2.3e-7 and
9.0e-4 — the port agrees with the reference to the reference's own
float32 noise.  qc, qr and rainnc are still zero after 30 s; Kessler's
condensation path is compared in test_torch_dycore.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import constant_boundary  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(nx=32, ny=8, nz=20):
    """The same squall-line configuration in both packages: config 3's
    dx, dt, ztop, p_top and kvdif with radiation and chemistry off."""
    out = []
    for m in (jcfg, tcfg):
        out.append(m.Config(
            domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                  ztop=17000.0, p_top=8000.0),
            time_control=m.TimeControl(dt=6.0),
            dynamics=m.DynamicsConfig(kvdif=30.0)))
    return out


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / max(scale, 1e-30))


def _jgrid_numpy(g):
    return {f.name: (np.asarray(getattr(g, f.name))
                     if not isinstance(getattr(g, f.name), (float, bool))
                     else getattr(g, f.name))
            for f in dataclasses.fields(g)}


def jax_grid_to_port(g, device="cpu"):
    """The JAX package's Grid carried over to the port, field by field."""
    return grid_from_numpy(_jgrid_numpy(g), device)


def test_make_case_matches_jax():
    jc, tc = _cfgs()
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    tg, ts = tideal.make_case(tc, "squall2d_x", device="cpu", bubble_amp=3.0)
    assert set(js) == set(ts)
    for name in ("znw", "rdnw", "fnm", "fnp", "mub", "pb", "alb", "phb", "t_init"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in js:
        a, b = np.asarray(js[name]), ts[name].numpy()
        assert a.shape == b.shape and b.dtype == np.float32, name
        scale = float(np.abs(a).max())
        assert _rel(a, b, scale) <= 1e-7, (name, _rel(a, b, scale))


def test_simulation_advance_matches_jax():
    """5 steps (30 s) of the squall line, port against reference.

    Tolerance, per field, as max |d| / max |field| (phi at the magnitude of
    phb + ph, since float32 rounding scales with the full geopotential):
    1e-4, or three times the reference's own float32 noise where that is
    larger (the port rounds differently in many operations, the noise probe
    in one input).  The noise is measured here: the reference run again
    from theta changed by one ulp.  Only w exceeds 1e-4 that way: it is the
    small residual of the acoustic w-phi solve on column masses of ~1e5 Pa,
    and one ulp of theta moves it by ~1e-3 of its magnitude in one step.

    The port starts from the JAX package's own grid and state, carried over
    with grid_from_numpy/state_from_numpy."""
    jc, tc = _cfgs()
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
    js_ulp = dict(js, t=js["t"] * np.float32(1.0 + 2.0 ** -23))
    jsim = JSim(jc, jg, js)
    jsim_ulp = JSim(jc, jg, js_ulp)
    tsim = TSim(tc, tg, ts, device="cpu")
    for sim in (jsim, jsim_ulp, tsim):
        sim.advance(5)
    phb_scale = float(np.abs(np.asarray(jg.phb)).max())
    worst, noise = {}, {}
    for name, a in jsim.state.items():
        a = np.asarray(a)
        b = tsim.state[name].numpy()
        assert np.isfinite(b).all(), name
        scale = phb_scale if name == "ph" else float(np.abs(a).max())
        worst[name] = _rel(a, b, scale)
        noise[name] = _rel(a, np.asarray(jsim_ulp.state[name]), scale)
    print("port vs reference after 5 steps:", worst)
    print("reference vs reference with one ulp of theta:", noise)
    assert float(np.asarray(jsim.state["w"]).max()) > 0.0
    for name, r in worst.items():
        assert r <= max(1e-4, 3.0 * noise[name]), (name, r, noise[name])


def _cfg3(m, nx=16, ny=4, nz=12, steps_per_alarm=2):
    """BASELINE config 3 (bench.py's _cfg3) in package `m` at a small size,
    starting at noon UTC, with both alarms every `steps_per_alarm` steps."""
    nl = m.namelist
    every = 6.0 * steps_per_alarm
    return m.Config(
        domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                              ztop=17000.0, p_top=8000.0),
        time_control=m.TimeControl(dt=6.0, start_date="2000-06-20_12:00:00"),
        dynamics=m.DynamicsConfig(kvdif=30.0),
        physics=m.PhysicsConfig(mp_physics=nl.MPScheme.KESSLER,
                                ra_sw_physics=nl.RAScheme.RRTMG,
                                ra_lw_physics=nl.RAScheme.RRTMG, radt_s=every),
        chem=m.ChemConfig(chem_opt=nl.ChemOpt.MOSAIC_4BIN, chemdt_s=every,
                          aer_ra_feedback=True, gaschem_onoff=False,
                          aerchem_onoff=False))


def seed_chem(state, full_like):
    """bench.py's chem seed: so4 2.0 and oc 1.0 ug/kg, 2e9 /kg in bins 1-2."""
    for b in (1, 2):
        state[f"chem_so4_a{b:02d}"] = full_like(state["t"], 2.0)
        state[f"chem_oc_a{b:02d}"] = full_like(state["t"], 1.0)
        state[f"chem_num_a{b:02d}"] = full_like(state["t"], 2e9)
    return state


def test_config3_simulation_matches_jax():
    """4 steps of config 3 at 16x4x12 with radiation and chemistry on and
    both alarms every 2 steps (so each rings at steps 0 and 2): the
    radiation, optics, dry deposition, held heating and the 47-scalar
    batched advection (the fused multi-tracer path) against the reference.
    Tolerance as in test_simulation_advance_matches_jax: 1e-4 of each
    field's magnitude, or three times the reference's own one-ulp noise."""
    jc, tc = _cfg3(jcfg), _cfg3(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    assert len([k for k in js if k.startswith("chem_")]) == 44
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    js = {k: jnp.asarray(v) for k, v in js.items()}
    js_ulp = dict(js, t=js["t"] * np.float32(1.0 + 2.0 ** -23))
    jsim, jsim_ulp = JSim(jc, jg, js), JSim(jc, jg, js_ulp)
    tsim = TSim(tc, tg, ts, device="cpu")
    for sim in (jsim, jsim_ulp, tsim):
        sim.advance(4)
    phb_scale = float(np.abs(np.asarray(jg.phb)).max())
    worst, noise = {}, {}
    for name, a in jsim.state.items():
        a = np.asarray(a)
        b = tsim.state[name].numpy()
        assert np.isfinite(b).all(), name
        scale = phb_scale if name == "ph" else float(np.abs(a).max())
        worst[name] = _rel(a, b, scale)
        noise[name] = _rel(a, np.asarray(jsim_ulp.state[name]), scale)
    print("port vs reference after 4 config-3 steps:",
          {k: v for k, v in worst.items() if v > 1e-6})
    assert float(np.asarray(jsim.state["swdown"]).min()) > 100.0
    assert float(np.asarray(jsim.state["tau_aer_sw"]).max()) > 0.0
    for name, r in worst.items():
        assert r <= max(1e-4, 3.0 * noise[name]), (name, r, noise[name])


def test_port_imports_no_jax_and_needs_cuda_by_default():
    """In a fresh interpreter: the port runs config 3 with radiation and
    chemistry on, on the CPU, without importing jax or the JAX package,
    and refuses to pick a device itself when there is no GPU."""
    code = r"""
import sys
import torch
from wrfchem_arc_interactions_tpu_torch.config import (
    ChemConfig, Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl)
from wrfchem_arc_interactions_tpu_torch.config.namelist import ChemOpt, RAScheme
from wrfchem_arc_interactions_tpu_torch.models import ideal
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
cfg = Config(domain=DomainConfig(nx=12, ny=4, nz=10, dx=1000.0, dy=1000.0,
                                 ztop=17000.0, p_top=8000.0),
             time_control=TimeControl(dt=6.0, start_date="2000-06-20_12:00:00"),
             dynamics=DynamicsConfig(kvdif=30.0),
             physics=PhysicsConfig(ra_sw_physics=RAScheme.RRTMG,
                                   ra_lw_physics=RAScheme.RRTMG, radt_s=6.0),
             chem=ChemConfig(chem_opt=ChemOpt.MOSAIC_4BIN, chemdt_s=6.0,
                             aer_ra_feedback=True, aerchem_onoff=False))
grid, state = ideal.make_case(cfg, "squall2d_x", device="cpu")
for b in (1, 2):
    state[f"chem_so4_a{b:02d}"] = torch.full_like(state["t"], 2.0)
    state[f"chem_num_a{b:02d}"] = torch.full_like(state["t"], 2e9)
sim = Simulation(cfg, grid, state, device="cpu")
sim.advance(2)
assert all(bool(torch.isfinite(v).all()) for v in sim.state.values())
assert float(sim.state["tau_aer_sw"].max()) > 0.0 and float(sim.state["olr"].min()) > 0.0
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "wrfchem_arc_interactions_tpu"
       or m.startswith("wrfchem_arc_interactions_tpu.")]
assert not bad, bad
if not torch.cuda.is_available():
    for call in (lambda: Simulation(cfg, grid, state),
                 lambda: ideal.make_case(cfg, "squall2d_x")):
        try:
            call()
        except RuntimeError as e:
            assert "device='cpu'" in str(e)
        else:
            raise AssertionError("no error without CUDA and without device=")
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


@pytest.mark.parametrize("change,case,item", [
    ({"dynamics": (("bc_x", "specified"),)}, "squall2d_x", "item 9"),
    ({"dynamics": (("fft_filter_lat", 45.0),)}, "squall2d_x", "item 9"),
    ({"fdda": (("grid_fdda", True),)}, "squall2d_x", "item 9"),
    ({"parallel": (("mesh_x", 2),)}, "squall2d_x", "item 10"),
    ({}, "hill2d_x", "item 9"),
])
def test_unported_options_raise(change, case, item):
    """What the port does not carry yet raises, naming the ROADMAP item that
    brings it; the options of item 9 (specified boundaries, the polar
    filter, analysis nudging, the hill2d_x case over terrain) and a mesh
    layout in ``cfg.parallel`` (item 10: the mesh itself is `Simulation`'s
    argument) build and step once, and their own tests hold them to the
    reference."""
    _, tc = _cfgs(nx=8, ny=4, nz=6)
    for group, fields in change.items():
        sub = getattr(tc, group)
        sub = dataclasses.replace(sub, **{field: type(getattr(sub, field))(value)
                                          for field, value in fields})
        tc = tc.replace(**{group: sub})
    if item not in ("item 9", "item 10"):
        with pytest.raises(NotImplementedError, match=item):
            tideal.make_case(tc, case, device="cpu")
        return
    grid, state = tideal.make_case(tc, case, device="cpu")
    target = constant_boundary({k: state[k] for k in ("u", "v", "w", "t", "mu", "ph")})
    sim = TSim(tc, grid, state, boundary=target, fdda=target, device="cpu")
    sim.advance(1)
    assert all(bool(torch.isfinite(v).all()) for v in sim.state.values())


@pytest.mark.parametrize("arg,item", [("mesh", "item 10"), ("boundary", "item 9"),
                                      ("fdda", "item 9")])
def test_unported_simulation_arguments_raise(arg, item):
    """`Simulation` takes the reference's mesh argument (item 10: a
    `parallel.mesh.Mesh`, here the 1 x 1 one that needs no process group;
    a nest on a mesh raises, naming item 10b) and the boundary and fdda
    arguments of item 9 (a `LateralBoundary`, moved to the Simulation's
    device); each steps."""
    _, tc = _cfgs(nx=8, ny=4, nz=6)
    grid, state = tideal.make_case(tc, "squall2d_x", device="cpu", bubble_amp=3.0)
    if arg == "mesh":
        sim = TSim(tc, grid, state, device="cpu", mesh=make_mesh(1, 1, device="cpu"))
        sim.advance(1)
        assert all(bool(torch.isfinite(v).all()) for v in sim.state.values())
        return
    tc = tc.replace(fdda=dataclasses.replace(tc.fdda, grid_fdda=True))
    target = constant_boundary({k: state[k] for k in ("u", "v", "t", "qv")})
    sim = TSim(tc, grid, state, device="cpu", **{arg: target})
    assert getattr(sim, arg) is not None
    sim.advance(1)
    assert all(bool(torch.isfinite(v).all()) for v in sim.state.values())
