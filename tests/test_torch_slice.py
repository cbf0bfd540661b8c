"""The port's slice as a whole against the JAX package: the squall-line
case construction and `Simulation.advance` (dycore + diffusion + Kessler,
radiation and chemistry off) on a small grid, both on the CPU.

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

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
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
    tg = grid_from_numpy(_jgrid_numpy(jg), "cpu")
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


def test_port_imports_no_jax_and_needs_cuda_by_default():
    """In a fresh interpreter: the port runs its slice on the CPU without
    importing jax or the JAX package, and refuses to pick a device itself
    when there is no GPU."""
    code = r"""
import sys
import torch
from wrfchem_arc_interactions_tpu_torch.config import Config, DomainConfig, DynamicsConfig, TimeControl
from wrfchem_arc_interactions_tpu_torch.models import ideal
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
cfg = Config(domain=DomainConfig(nx=12, ny=4, nz=10, dx=1000.0, dy=1000.0,
                                 ztop=17000.0, p_top=8000.0),
             time_control=TimeControl(dt=6.0), dynamics=DynamicsConfig(kvdif=30.0))
grid, state = ideal.make_case(cfg, "squall2d_x", device="cpu")
sim = Simulation(cfg, grid, state, device="cpu")
sim.advance(2)
assert all(bool(torch.isfinite(v).all()) for v in sim.state.values())
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


@pytest.mark.parametrize("change", [
    {"physics": ("ra_sw_physics", "rrtmg")},
    {"chem": ("chem_opt", "mosaic_4bin")},
    {"physics": ("mp_physics", "morrison2")},
    {"physics": ("bl_pbl_physics", "ysu")},
    {"dynamics": ("moist_adv_opt", "mono")},
])
def test_unported_options_raise(change):
    (group, (field, value)), = change.items()
    _, tc = _cfgs(nx=8, ny=4, nz=6)
    sub = getattr(tc, group)
    ftype = type(getattr(sub, field))
    tc = tc.replace(**{group: dataclasses.replace(sub, **{field: ftype(value)})})
    with pytest.raises(NotImplementedError, match="slice"):
        tideal.make_case(tc, "squall2d_x", device="cpu")
