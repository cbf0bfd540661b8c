"""The interactive-ARC slice (BASELINE config 4) of the port against the JAX
package, both on the CPU: `Simulation` on bench.py's `_cfg4` values
(Morrison with progn, CBM-Z + MOSAIC 4-bin with the default stage list, aerosol
feedback on radiation) at 16x4x12 with bench.py's aerosol and gas seed,
starting at noon UTC so that photolysis is live, chem and rad alarms every 2
steps, 4 steps; and one `chem_driver` call alone.

Tolerance: every field to 1e-4 of its magnitude, or three times the
reference's own float32 noise (the reference run again from theta changed by
one ulp) where that is larger, as `test_torch_slice.py` holds config 3.
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
from wrfchem_arc_interactions_tpu.chem import driver as jchem  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import driver as tchem  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    advected_names, state_from_numpy,
)

from test_torch_slice import _rel, jax_grid_to_port, seed_chem  # noqa: E402

GAS_SEED = (("o3", 0.04), ("no2", 2e-3), ("no", 1e-3), ("co", 0.12), ("so2", 2e-3),
            ("h2o2", 1e-3))


def _cfg4(m, nx=16, ny=4, nz=12, steps_per_alarm=2):
    """bench.py's _cfg4 in package `m` at a small size, from noon UTC, with
    both alarms every `steps_per_alarm` steps."""
    nl = m.namelist
    every = 6.0 * steps_per_alarm
    return m.Config(
        domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                              ztop=17000.0, p_top=8000.0),
        time_control=m.TimeControl(dt=6.0, start_date="2000-06-20_12:00:00"),
        dynamics=m.DynamicsConfig(kvdif=30.0),
        physics=m.PhysicsConfig(mp_physics=nl.MPScheme.MORRISON2, progn=True,
                                ra_sw_physics=nl.RAScheme.RRTMG,
                                ra_lw_physics=nl.RAScheme.RRTMG, radt_s=every),
        chem=m.ChemConfig(chem_opt=nl.ChemOpt.CBMZ_MOSAIC_4BIN, chemdt_s=every,
                          aer_ra_feedback=True))


def _seeded_case():
    jc, tc = _cfg4(jcfg), _cfg4(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    for s, v in GAS_SEED:
        js[f"chem_{s}"] = np.full(js["t"].shape, v, np.float32)
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    return jc, tc, jg, js


def _compare(jstate, jstate_ulp, tstate, phb_scale):
    worst, noise = {}, {}
    for name, a in jstate.items():
        a = np.asarray(a)
        b = tstate[name].numpy()
        assert np.isfinite(b).all(), name
        scale = phb_scale if name == "ph" else float(np.abs(a).max())
        worst[name] = _rel(a, b, scale)
        noise[name] = _rel(a, np.asarray(jstate_ulp[name]), scale)
    print("port vs reference:", {k: f"{v:.2e}" for k, v in worst.items() if v > 1e-6})
    for name, r in worst.items():
        assert r <= max(1e-4, 3.0 * noise[name]), (name, r, noise[name])
    return worst


def test_config4_tables():
    jc, tc, jg, js = _seeded_case()
    assert tuple(tc.moist_species()) == tuple(jc.moist_species())
    names = advected_names(tc)
    assert len(names) == 107 and len(set(names)) == 107     # 12 moist + 40 aerosol + 55 gases
    assert [k for k in js if k in names] == list(names)      # the reference's table order
    assert len([k for k in js if k.startswith("chem_")]) == 95


def test_config4_simulation_matches_jax():
    jc, tc, jg, js = _seeded_case()
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    js_ulp = dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23))
    jsim, jsim_ulp = JSim(jc, jg, jsj), JSim(jc, jg, js_ulp)
    tsim = TSim(tc, tg, ts, device="cpu")
    assert tsim.chem_every == tsim.rad_every == 2
    for sim in (jsim, jsim_ulp, tsim):
        sim.advance(4)
    assert set(jsim.state) == set(tsim.state)
    _compare(jsim.state, jsim_ulp.state, tsim.state, float(np.abs(np.asarray(jg.phb)).max()))
    s = tsim.state
    assert float(s["swdown"].min()) > 100.0                   # the sun is up
    assert float((s["chem_o3"] - 0.04).abs().max()) > 1e-6    # the mechanism ran
    assert float(s["chem_oh"].max()) > 0.0                    # photolysis is live
    assert float(s["chem_h2so4"].max()) > 0.0 or float(s["chem_so4_a01"].max()) > 2.0
    assert float(s["tau_aer_sw"].max()) > 0.0
    assert all(float(v.min()) >= 0.0 for k, v in s.items() if k.startswith("chem_"))


@pytest.mark.parametrize("phot_opt,adaptive", [(2, False), (1, False), (2, True)])
def test_chem_driver_config4(phot_opt, adaptive):
    """One chem call of config 4 on one state, each photolysis option, and
    the adaptive integrator in place of the fixed substeps."""
    jc, tc, jg, js = _seeded_case()
    jc = jc.replace(chem=dataclasses.replace(jc.chem, phot_opt=phot_opt,
                                             gas_adaptive=adaptive))
    tc = tc.replace(chem=dataclasses.replace(tc.chem, phot_opt=phot_opt,
                                             gas_adaptive=adaptive))
    rng = np.random.default_rng(11)
    js["qc"] = (1e-3 * rng.uniform(0, 1, js["t"].shape)
                * (rng.uniform(size=js["t"].shape) > 0.7)).astype(np.float32)
    js["tau_aer_sw"] = (0.02 * rng.uniform(0, 1, js["tau_aer_sw"].shape)).astype(np.float32)
    js["ssa_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.9)
    js["asy_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.65)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    hx = JHalo(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y)
    t_s, jd = np.float32(43200.0), np.float32(172.5)
    jout = jchem.chem_driver(jsj, jg, jc, hx, 60.0, time_s=t_s, julian_day=jd)
    jout_ulp = jchem.chem_driver(dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23)),
                                 jg, jc, hx, 60.0, time_s=t_s, julian_day=jd)
    tout = tchem.chem_driver(ts, tg, tc, 60.0, time_s=t_s, julian_day=jd)
    assert set(jout) == set(tout)
    _compare(jout, jout_ulp, tout, float(np.abs(np.asarray(jg.phb)).max()))
    assert float(tout["chem_oh"].max()) > 0.0


@pytest.mark.parametrize("limiter", ["pd", "none"])
def test_final_stage_only_chem_advection(limiter):
    """With diffusion off the chem tracers carry no physics tendency and are
    advected on the final RK stage only, from their step-start values with
    the time-averaged mass fluxes (the moist scalars still ride every
    stage): 3 steps of a seeded MOSAIC 4-bin state against the reference."""
    def cfg(m):
        nl = m.namelist
        return m.Config(
            domain=m.DomainConfig(nx=16, ny=4, nz=12, dx=1000.0, dy=1000.0,
                                  ztop=17000.0, p_top=8000.0),
            time_control=m.TimeControl(dt=6.0),
            dynamics=m.DynamicsConfig(diff_opt=nl.DiffOpt.NONE,
                                      chem_adv_opt=nl.AdvLimiter(limiter)),
            physics=m.PhysicsConfig(mp_physics=nl.MPScheme.KESSLER),
            chem=m.ChemConfig(chem_opt=nl.ChemOpt.MOSAIC_4BIN, chemdt_s=6000.0,
                              gaschem_onoff=False, aerchem_onoff=False))
    jc, tc = cfg(jcfg), cfg(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    rng = np.random.default_rng(12)
    for b in (1, 2):
        for sp, v in (("so4", 2.0), ("oc", 1.0), ("num", 2e9)):
            js[f"chem_{sp}_a{b:02d}"] = (v * rng.uniform(0.0, 2.0, js["t"].shape)
                                         * (rng.uniform(size=js["t"].shape) > 0.3)
                                         ).astype(np.float32)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    js_ulp = dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23))
    jsim, jsim_ulp = JSim(jc, jg, jsj), JSim(jc, jg, js_ulp)
    tsim = TSim(tc, tg, ts, device="cpu")
    for sim in (jsim, jsim_ulp, tsim):
        sim.advance(3)
    worst = _compare(jsim.state, jsim_ulp.state, tsim.state,
                     float(np.abs(np.asarray(jg.phb)).max()))
    assert float(np.abs(tsim.state["chem_so4_a01"].numpy() - js["chem_so4_a01"]).max()) > 1e-4
    assert worst["chem_so4_a01"] <= 1e-4 and worst["chem_num_a02"] <= 1e-4
