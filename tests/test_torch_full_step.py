"""The port's `models.driver.full_step` against the JAX package's: config 4
(bench.py's `_cfg4` values) at 16x8x20 from one state seeded with numpy
(bench.py's aerosol and gas seed, and a cloud), 2 steps with radiation and
chemistry on every step, through JAX's jitted `full_step` on the CPU and
through the port's.  Two clouds: a warm one in the lowest 5 levels of random
columns, and an icy one at every level of random cells, which Morrison turns
partly into ice and snow before the second radiation call.

Tolerance: `test_torch_slice4._compare` — every field to 1e-4 of its
magnitude, or three times the reference's own float32 noise (the reference
run again from theta changed by one ulp) where that is larger.

The icy cloud is held step by step: the first step from the seeded state,
and the second stage by stage (radiation with the pre-dynamics physics, the
dynamics, the post-dynamics physics with chemistry), each stage in both
packages fed the reference's own output of the stage before.  Run free, the
two packages' first-step states differ by float32 noise, and McICA's binary
subcolumn draw (`x > 1 - cldfra`) turns that noise into a different cloud
mask in one g-point of one layer, which moves that column's heating by far
more than the noise.  The free run is held everywhere else, and the test
asserts that the columns it leaves out are those where the reference itself
draws a different mask from the two first-step states.

And the port's `full_step` against its `Simulation` with both alarms
ringing, bit for bit: the `Simulation` calls chemistry first in a step and
the reference's `full_step` last, so `advance(1)` is the chem call followed
by ``full_step(..., do_radiation=True, do_chem=False)``, and ``full_step(...,
True, True)`` is the `Simulation`'s rad, main and chem steppers in that
order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu.dycore.solve import step as jdyn_step  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import full_step as jfull_step  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.sharded import halo_ops_for as jhalo  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import driver as jpd  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import bands as jbands  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import mcica as jmcica  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation.driver import (  # noqa: E402
    _columns as jcolumns,
)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.driver import chem_driver  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore.solve import step as dyn_step  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import (  # noqa: E402
    Simulation, full_step,
)
from wrfchem_arc_interactions_tpu_torch.parallel.sharded import halo_ops_for  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.driver import (  # noqa: E402
    post_dynamics, pre_dynamics,
)
from wrfchem_arc_interactions_tpu_torch.physics.radiation.driver import (  # noqa: E402
    radiation_driver,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_slice import jax_grid_to_port, seed_chem  # noqa: E402
from test_torch_slice4 import GAS_SEED, _cfg4, _compare  # noqa: E402

NOON = 43200.0
ULP = np.float32(1.0 + 2.0 ** -23)


def _case(cloud="warm"):
    """Config 4 at 16x8x20 in both packages, and one seeded state (numpy)."""
    jc, tc = (_cfg4(m, nx=16, ny=8, nz=20, steps_per_alarm=1) for m in (jcfg, tcfg))
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    for s, v in GAS_SEED:
        js[f"chem_{s}"] = np.full(js["t"].shape, v, np.float32)
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    rng = np.random.default_rng(20)
    if cloud == "warm":
        # a warm cloud in the lowest 5 levels of 30% of the columns
        where = rng.uniform(size=js["t"].shape[1:]) > 0.7
        js["qc"][:5] = np.where(where, 5e-4 * rng.uniform(0.5, 1.0, js["qc"][:5].shape),
                                0.0).astype(np.float32)
    else:
        # cloud water up to 1e-3 kg/kg in 30% of the cells at every level
        js["qc"] = (1e-3 * rng.uniform(0.0, 1.0, js["t"].shape)
                    * (rng.uniform(size=js["t"].shape) > 0.7)).astype(np.float32)
    return jc, tc, jg, js


_JIT = {}


def _jax_stages(jc):
    """The reference's jitted `full_step` (rad and chem on) and its stages:
    radiation with the pre-dynamics physics, the dynamics, and the
    post-dynamics physics with chemistry; built once for the module (both
    clouds run one configuration)."""
    if not _JIT:
        dt = jc.time_control.dt
        hx = jhalo(jc, None)
        _JIT["step"] = jax.jit(lambda s, g, t: jfull_step(s, g, jc, hx, dt, True, True, t))
        _JIT["pre"] = jax.jit(lambda s, g, t: jpd.pre_dynamics(s, g, jc, hx, dt, True, t))
        _JIT["dyn"] = jax.jit(lambda s, g, tend: jdyn_step(s, g, jc, hx, dt, tend))
        _JIT["post"] = jax.jit(lambda s, g: jpd.post_dynamics(s, g, jc, hx, dt, True))
    return _JIT


def test_full_step_matches_jax():
    jc, tc, jg, js = _case()
    dt = jc.time_control.dt
    stepf = _jax_stages(jc)["step"]
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    runs = {"ref": jsj, "ulp": dict(jsj, t=jsj["t"] * ULP)}
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    hx_t = halo_ops_for(tc, None)
    for i in range(2):
        t_s = np.float32(NOON + i * dt)
        runs = {k: stepf(s, jg, t_s) for k, s in runs.items()}
        ts = full_step(ts, tg, tc, hx_t, dt, True, True, t_s)
    assert set(runs["ref"]) == set(ts)
    _compare(runs["ref"], runs["ulp"], ts, float(np.abs(np.asarray(jg.phb)).max()))
    assert float(ts["swdown"].min()) > 100.0                  # radiation saw the sun
    assert float((ts["chem_o3"] - 0.04).abs().max()) > 1e-6   # the mechanism ran
    assert float(ts["tau_aer_sw"].max()) > 0.0                # the optics ran
    assert float(ts["qr"].max()) > 0.0                        # the cloud rained


def test_full_step_is_the_simulation_step():
    _, tc, jg, js = _case()
    tc = tc.replace(time_control=dataclasses.replace(
        tc.time_control, start_date="2000-06-20_00:00:00"))
    tg = jax_grid_to_port(jg)
    s0 = state_from_numpy(js, "cpu")
    sim = Simulation(tc, tg, s0, device="cpu")
    assert sim.rad_every == sim.chem_every == 1
    # at 00 UTC of the default julian day the Simulation's sun is the one
    # full_step's radiation and chemistry take
    assert (sim._solar_off, sim._julian) == (0.0, 172.0)
    rad, main, chem = (sim._stepper(k) for k in ("rad", "main", "chem"))
    t0 = np.float32(0.0)
    want_all = chem(main(rad(s0, tg, t0), tg, t0), tg, t0)
    sim.advance(1)
    hx = halo_ops_for(tc, None)
    dt = tc.time_control.dt
    got_all = full_step(s0, tg, tc, hx, dt, True, True, 0.0)
    got_step = full_step(chem_driver(s0, tg, tc, tc.chem.chemdt_s), tg, tc, hx, dt, True,
                         False, 0.0)
    for want, got in ((want_all, got_all), (sim.state, got_step)):
        assert set(want) == set(got)
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        assert not differ, differ


def _numpy(state):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in state.items()}


@pytest.fixture(scope="module")
def icy():
    """The icy cloud's runs: the reference (`ref`) and its one-ulp-theta twin
    (`ulp`) for two free steps and the port's two free steps; and the second
    step's stages in both packages, each stage fed the reference's own
    output of the stage before (`stages`: name -> (reference, the reference
    on its input's one-ulp-theta twin, port))."""
    jc, tc, jg, js = _case("icy")
    jit = _jax_stages(jc)
    dt = jc.time_control.dt
    tg = jax_grid_to_port(jg)
    hx = halo_ops_for(tc, None)
    t0, t1 = np.float32(NOON), np.float32(NOON + dt)
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    r = {"ref1": jit["step"](jsj, jg, t0), "ulp1": jit["step"](dict(jsj, t=jsj["t"] * ULP), jg, t0),
         "port1": full_step(state_from_numpy(js, "cpu"), tg, tc, hx, dt, True, True, t0)}
    r["ref2"], r["ulp2"] = jit["step"](r["ref1"], jg, t1), jit["step"](r["ulp1"], jg, t1)
    r["port2"] = full_step(r["port1"], tg, tc, hx, dt, True, True, t1)

    def port(state):
        return state_from_numpy(_numpy(state), "cpu")

    def ulp(state):
        return dict(state, t=state["t"] * ULP)

    # each reference stage twice: on its input and on that input's one-ulp-theta twin
    (pre, tend), (pre_u, tend_u) = (jit["pre"](s, jg, t1) for s in (r["ref1"], ulp(r["ref1"])))
    dyn, dyn_u = jit["dyn"](pre, jg, tend), jit["dyn"](ulp(pre), jg, tend)
    post, post_u = jit["post"](dyn, jg), jit["post"](ulp(dyn), jg)
    port_pre, port_tend = pre_dynamics(radiation_driver(port(r["ref1"]), tg, tc, t1), tg, tc,
                                       hx, dt, t1)
    port_dyn = dyn_step(port(pre), tg, tc, hx, dt, port(tend))
    port_post = chem_driver(post_dynamics(port(dyn), tg, tc, dt), tg, tc, tc.chem.chemdt_s)
    r["stages"] = {"rad+pre": (pre, pre_u, port_pre), "tendencies": (tend, tend_u, port_tend),
                   "dyn": (dyn, dyn_u, port_dyn), "post+chem": (post, post_u, port_post)}
    return dict(r, jc=jc, jg=jg, t1=t1, phb=float(np.abs(np.asarray(jg.phb)).max()))


def test_full_step_icy_cloud_matches_jax(icy):
    """The first step on the icy cloud, and each stage of the second step
    fed the reference's own input, within `_compare`'s bound."""
    assert float(icy["port1"]["qs"].max()) > 0.0 and float(icy["port1"]["qi"].max()) > 0.0
    _compare(icy["ref1"], icy["ulp1"], icy["port1"], icy["phb"])
    for name, (ref, ref_ulp, port) in icy["stages"].items():
        assert set(ref) == set(port), name
        _compare(ref, ref_ulp, port, icy["phb"])
    assert float(icy["stages"]["rad+pre"][2]["swdown"].max()) > 100.0   # the sun is up


def _mcica_flips(icy):
    """(ny, nx) columns where the reference's LW or SW McICA mask at the
    second radiation call differs between its own and the port's first-step
    state, and the largest cloud-fraction difference there."""
    jc, jg = icy["jc"], icy["jg"]
    ny, nx = jg.phb.shape[1:]

    def cldfra(state):
        s = {k: jnp.asarray(np.asarray(v)) for k, v in state.items()}
        p_lay, t_lay, _, qv, _, qcond, *_ = jcolumns(s, jg, jc)
        return jmcica.xu_randall_cldfra(p_lay, t_lay, qv, qcond)

    cf_ref, cf_port = cldfra(icy["ref1"]), cldfra(icy["port1"])
    seed = np.uint32(icy["t1"])
    flips = np.zeros(ny * nx, bool)
    for ngpt in (jbands.NGPT_LW, jbands.NGPT_SW):
        a, b = (np.asarray(jmcica.mcica_mask(cf, ngpt, seed)) for cf in (cf_ref, cf_port))
        flips |= (a != b).any(axis=(0, 1))
    dcf = np.abs(np.asarray(cf_ref) - np.asarray(cf_port))[:, flips]
    return flips.reshape(ny, nx), float(dcf.max(initial=0.0))


def test_full_step_icy_cloud_free_run(icy):
    """Two free steps: every field within `_compare`'s bound, the radiative
    heating in the columns where McICA draws a different subcolumn mask
    left out, and there the two cloud fractions differ by float32 noise."""
    flips, dcf = _mcica_flips(icy)
    assert dcf < 1e-5 and flips.mean() < 0.05, (dcf, int(flips.sum()))
    heat = ("rthraten_lw", "rthraten_sw")

    def outside(state, name):
        v = np.array(np.asarray(state[name]))
        if name in heat:
            v[:, flips] = 0.0
        return v

    ref, ulp = ({k: outside(icy[run], k) for k in icy[run]} for run in ("ref2", "ulp2"))
    port = {k: torch.from_numpy(outside(icy["port2"], k)) for k in icy["port2"]}
    _compare(ref, ulp, port, icy["phb"])
