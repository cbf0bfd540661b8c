"""Slice 7's path of the port against the JAX package, both on the CPU:
`Simulation` on config 4 with WRF-Chem's usual transport and boundary
layer (`_cfg7`: the monotonic limiter for moist and chem scalars, the
6th-order filter, 2D Smagorinsky with kvdif = 0, YSU over the revised MM5
surface layer and the Noah land surface) at 16x8x20 from noon UTC, chem and
rad alarms every 2 steps, 3 steps; then small `Simulation`s of the other
item-7 options: the LES case with the TKE closure and WENO5 momentum and
scalars (stacked), and the squall line with SPPT and SKEBS.  Last, the
reference's LES property test on the port.

Tolerance as `test_torch_slice4.py` holds config 4: every field to 1e-4 of
its magnitude, or three times the reference's own float32 noise (the
reference run again from theta changed by one ulp) where that is larger.
"""

import dataclasses

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
# the reference's physics driver imports the LSM inside the traced step, and
# an import that runs under a trace leaks its module-level arrays as tracers
# (the JAX package's own Noah tests import it first, as here)
import wrfchem_arc_interactions_tpu.physics.lsm  # noqa: E402,F401

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    advected_names, state_from_numpy,
)

from test_torch_slice import jax_grid_to_port, seed_chem  # noqa: E402
from test_torch_slice4 import GAS_SEED, _cfg4, _compare  # noqa: E402


def _cfg7(m, nx=16, ny=8, nz=20):
    """Config 4 with WRF-Chem's usual transport and boundary layer, from
    noon UTC, both alarms every 2 steps."""
    nl = m.namelist
    c = _cfg4(m, nx=nx, ny=ny, nz=nz)
    return c.replace(
        dynamics=dataclasses.replace(
            c.dynamics, moist_adv_opt=nl.AdvLimiter.MONOTONIC,
            chem_adv_opt=nl.AdvLimiter.MONOTONIC, diff_6th_opt=2, diff_6th_factor=0.12,
            km_opt=nl.KMOpt.SMAGORINSKY_2D, kvdif=0.0),
        physics=dataclasses.replace(
            c.physics, bl_pbl_physics=nl.PBLScheme.YSU,
            sf_sfclay_physics=nl.SFScheme.REVISED_MM5, sf_surface_physics=nl.SFSurface.NOAH))


def _run_both(jc, tc, jg, js, steps, full_theta_ulp=False):
    """The reference from `js` and from `js` with theta one ulp up (one
    compiled Simulation, reset between the runs), and the port from `js`.
    The ulp is the perturbation's, or with `full_theta_ulp` the full
    theta's (t + 300 K), for a case whose perturbation is zero."""
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    jsim = JSim(jc, jg, jsj)
    jsim.advance(steps)
    jstate = jsim.state
    t = jsj["t"]
    jsim.state = dict(jsj, t=((t + 300.0) * np.float32(1.0 + 2.0 ** -23) - 300.0
                              if full_theta_ulp else t * np.float32(1.0 + 2.0 ** -23)))
    jsim.time_s, jsim.step_idx = 0.0, 0
    jsim.advance(steps)
    tsim = TSim(tc, jax_grid_to_port(jg), state_from_numpy(js, "cpu"), device="cpu")
    tsim.advance(steps)
    assert set(jstate) == set(tsim.state)
    _compare(jstate, jsim.state, tsim.state, float(np.abs(np.asarray(jg.phb)).max()))
    return tsim


def _case7():
    jc, tc = _cfg7(jcfg), _cfg7(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    for s, v in GAS_SEED:
        js[f"chem_{s}"] = np.full(js["t"].shape, v, np.float32)
    return jc, tc, jg, {k: np.array(v, np.float32) for k, v in js.items()}


def test_slice7_tables():
    jc, tc, jg, js = _case7()
    names = advected_names(tc)
    assert len(names) == 107 and [k for k in js if k in names] == list(names)
    for k in ("hfx", "qfx", "ust", "pblh", "tmn", "tslb", "smois", "rain_prev", "snow",
              "ivgtyp"):
        assert k in js
    assert js["tslb"].shape == (4,) + js["tsk"].shape


def test_slice7_simulation_matches_jax():
    jc, tc, jg, js = _case7()
    s = _run_both(jc, tc, jg, js, 3).state
    ztop = float(jg.phb[-1].max()) / 9.81
    assert 0.0 < float(s["pblh"].min()) and float(s["pblh"].max()) < ztop
    assert float(s["hfx"].abs().max()) > 0.0
    assert 0.02 <= float(s["smois"].min()) and float(s["smois"].max()) <= 0.45
    assert float(s["swdown"].min()) > 100.0
    assert all(float(v.min()) >= 0.0 for k, v in s.items() if k.startswith("chem_"))
    assert all(float(s[q].min()) >= 0.0 for q in tc.moist_species())


def _les_cfg(m, nx=12, ny=12, nz=16):
    nl = m.namelist
    weno = nl.AdvOrder.WENO5
    return m.Config(
        domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=100.0, dy=100.0, ztop=2000.0,
                              p_top=80000.0),
        time_control=m.TimeControl(dt=0.5),
        dynamics=m.DynamicsConfig(km_opt=nl.KMOpt.TKE_15, h_mom_adv_order=weno,
                                  v_mom_adv_order=weno, h_sca_adv_order=weno,
                                  v_sca_adv_order=weno, scan_tracer_min=2),
        physics=m.PhysicsConfig(sf_sfclay_physics=nl.SFScheme.REVISED_MM5,
                                tke_heat_flux=0.2))


def test_les_tke_weno5_matches_jax():
    """The LES case with the 1.5-order TKE closure, the imposed surface heat
    flux, the surface layer, and WENO5 for momentum and for the scalars,
    which ride every stage as one stack (scan_tracer_min = 2); 4 steps."""
    jc, tc = _les_cfg(jcfg), _les_cfg(tcfg)
    jg, js = jideal.make_case(jc, "les")
    js = {k: np.asarray(v) for k, v in js.items()}
    js["tke"] = np.full(js["t"].shape, 0.1, np.float32)
    # a mean wind with seeded eddies: WENO5's weights are well set only
    # where the fields vary above their rounding
    rng = np.random.default_rng(12)
    for k, mean in (("u", 2.0), ("v", 1.0)):
        js[k] = (mean + rng.normal(scale=0.5, size=js[k].shape)).astype(np.float32)
    s = _run_both(jc, tc, jg, js, 4, full_theta_ulp=True).state
    assert float(s["tke"].min()) >= 0.0 and float((s["tke"] - 0.1).abs().max()) > 0.0


def test_sppt_skebs_matches_jax():
    """The squall line with SPPT and SKEBS on: the patterns (their noise
    hashes the step) and every field after 3 steps."""
    cfgs = []
    for m in (jcfg, tcfg):
        cfgs.append(m.Config(
            domain=m.DomainConfig(nx=16, ny=8, nz=12, dx=1000.0, dy=1000.0, ztop=17000.0,
                                  p_top=8000.0),
            time_control=m.TimeControl(dt=6.0),
            dynamics=m.DynamicsConfig(kvdif=30.0, sppt_amp=0.5, skebs_amp=0.5)))
    jc, tc = cfgs
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    s = _run_both(jc, tc, jg, {k: np.asarray(v) for k, v in js.items()}, 3).state
    assert float(s["sppt_pattern"].abs().max()) > 0.0
    assert float(s["skebs_psi"].abs().max()) > 0.0


def test_les_tke_develops():
    """The reference's LES test on the port, shortened: from a small warm
    bubble over a heated surface the TKE closure produces bounded,
    non-negative subgrid TKE."""
    nl = tcfg.namelist
    cfg = tcfg.Config(
        domain=tcfg.DomainConfig(nx=16, ny=16, nz=16, dx=100.0, dy=100.0, ztop=2000.0,
                                 p_top=80000.0),
        time_control=tcfg.TimeControl(dt=0.4),
        dynamics=tcfg.DynamicsConfig(km_opt=nl.KMOpt.TKE_15),
        physics=tcfg.PhysicsConfig(sf_sfclay_physics=nl.SFScheme.REVISED_MM5))
    grid, state = tideal.make_case(cfg, "warm_bubble", device="cpu", amplitude=0.5,
                                   zc=300.0, xr=400.0, zr=200.0, three_d=True)
    state["tsk"] = state["tsk"] + 6.0
    state["tke"] = torch.full_like(state["tke"], 0.1)
    sim = TSim(cfg, grid, state, device="cpu")
    sim.advance(60)
    tke = sim.state["tke"]
    assert bool(torch.isfinite(tke).all())
    assert 0.05 < float(tke.max()) < 50.0 and float(tke.min()) >= 0.0
