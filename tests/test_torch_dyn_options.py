"""The port's dycore options against the JAX package, on identical seeded
inputs (CPU): WENO5 fluxes, the monotonic limiter on a stack of scalars,
the 6th-order filter, the 1.5-order TKE closure, the stochastic patterns,
and one dycore step under each option; then the reference's own property
tests of the same operators, run on the port.

Tolerances: the operators are transcriptions of the reference with the same
operation order, so they agree to float32 rounding (1e-6 of the field's
magnitude) where no branch can flip.  The limiters and WENO5 choose
branches (`where`, `min`, `max`) on values that float32 noise can move, so
they are held in float64 on both sides, to 1e-12.  The stochastic noise is
the reference's integer hash and is held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import advection as jadv  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import diffusion as jdiff  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import solve as jsolve  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import stoch as jstoch  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import advection as tadv  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import diffusion as tdiff  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import stoch as tstoch  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import make_grid as tmake_grid  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.soundings import constant_n2_theta  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_advection import NX, NY, _inputs, _rel, _t, grids  # noqa: E402,F401
from test_torch_slice import jax_grid_to_port  # noqa: E402


def _f64(*arrays):
    return tuple(np.asarray(a, np.float64) for a in arrays)


# ---------------------------------------------------------------------------
# WENO5
# ---------------------------------------------------------------------------

def test_weno5_fluxes_match_jax(grids):
    """scalar_fluxes at order 7 (WENO5) and the momentum advection with
    WENO5, float64 on both sides: 1e-12 of the magnitude."""
    jg, tg = grids
    q, ru, rv, ww = _f64(*_inputs(seed=7))
    with jax.enable_x64(True):
        jf = jadv.scalar_fluxes(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                                jnp.asarray(ww), 7, 7)
        jdiv = jadv.flux_div(*jf, jg)
        ww_pad = np.pad(ww, ((0, 0), (3, 3), (3, 3)), mode="wrap")
        ju = jadv.advect_u(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                           jnp.asarray(ww_pad), jg, 7, 7)
        jf, jdiv, ju = [np.asarray(a) for a in jf], np.asarray(jdiv), np.asarray(ju)
    tf = tadv.scalar_fluxes(_t(q), _t(ru), _t(rv), _t(ww), 7, 7)
    tdiv = tadv.flux_div(*tf, tg)
    tu = tadv.advect_u(_t(q), _t(ru), _t(rv), _t(ww_pad), tg, 7, 7)
    for a, b in zip(jf + [jdiv, ju], list(tf) + [tdiv, tu]):
        assert b.dtype == torch.float64 and a.shape == tuple(b.shape)
        assert _rel(a, b) <= 1e-12


def test_weno5_float32_matches_jax(grids):
    """The same fluxes in float32: 1e-6 of the magnitude (the face-velocity
    sign picks the branch, and the velocities are inputs, so nothing flips)."""
    q, ru, rv, ww = _inputs(seed=8)
    jf = jadv.scalar_fluxes(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                            jnp.asarray(ww), 7, 3)
    tf = tadv.scalar_fluxes(_t(q), _t(ru), _t(rv), _t(ww), 7, 3)
    for a, b in zip(jf, tf):
        assert b.dtype == torch.float32
        assert _rel(a, b) <= 1e-6


def _x_advection_error(nx, order):
    """Error of the x flux divergence against d/dx for q = sin(2 pi x), u = 1
    (the reference's tests/test_advection.py, on the port, float64)."""
    cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=4, nz=4, dx=1.0 / nx, dy=1.0))
    grid = tmake_grid(cfg, constant_n2_theta(), "cpu")
    hx = THalo()
    x = (np.arange(nx) + 0.5) / nx
    q = torch.from_numpy(np.broadcast_to(np.sin(2 * np.pi * x), (4, 4, nx)).copy())
    ones, zeros = torch.ones_like(q), torch.zeros_like(q)
    tend = tadv.advect_scalar(hx.pad(q), hx.pad(ones), hx.pad(zeros),
                              torch.zeros((5, 4, nx), dtype=torch.float64), grid, order, 3)
    exact = -2 * np.pi * np.cos(2 * np.pi * x)
    return float(np.abs(tend[0, 0].numpy() - exact).max())


def test_weno5_smooth_convergence():
    """WENO5 reaches ~5th order on a smooth field (reference: rate > 4.2)."""
    rate = np.log2(_x_advection_error(32, 7) / _x_advection_error(64, 7))
    assert rate > 4.2, rate


def test_weno5_essentially_nonoscillatory():
    """On a step, WENO5 overshoots far less than linear 5th order and
    conserves mass (the reference's test, on the port)."""
    nz, ny, nx = 4, 4, 64
    cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx, dy=1.0))
    grid = tmake_grid(cfg, constant_n2_theta(), "cpu")
    hx = THalo()
    q = torch.zeros((nz, ny, nx))
    q[:, :, 20:33] = 1.0
    u = torch.full((nz, ny, nx), float(nx) / 4)
    dt = 0.5 * (1.0 / nx) / float(u.max())
    ru_pad, rv_pad = hx.pad(u), hx.pad(torch.zeros_like(u))
    ww = torch.zeros((nz + 1, ny, nx))

    def overshoot(order):
        qq = q.clone()
        for _ in range(20):
            qq = qq + dt * tadv.advect_scalar(hx.pad(qq), ru_pad, rv_pad, ww, grid,
                                              order, order)
        return max(float(qq.max()) - 1.0, -float(qq.min())), float(qq.sum())

    over5, _ = overshoot(5)
    overw, massw = overshoot(7)
    np.testing.assert_allclose(massw, float(q.sum()), rtol=1e-5)
    assert overw < 0.2 * max(over5, 1e-12) or overw < 1e-3, (overw, over5)


# ---------------------------------------------------------------------------
# Monotonic limiter
# ---------------------------------------------------------------------------

def _mono_inputs(nt, seed):
    """A stack of `nt` positive scalars with sharp features, the winds and
    the coupled old values (mu ~ 9e4 Pa), float64."""
    q0, ru, rv, ww = _f64(*_inputs(seed=seed, ww_scale=50.0))
    rng = np.random.default_rng(seed + 100)
    qs = np.stack([np.where(rng.uniform(size=q0.shape) < 0.3,
                            rng.uniform(0.0, 5.0, q0.shape), 0.0) for _ in range(nt)])
    ru, rv = 2e5 * ru, 2e5 * rv          # coupled mass fluxes [Pa m/s]
    mu = 9e4 + 1e3 * rng.normal(size=(NY, NX))
    mu_new = mu + 50.0 * rng.normal(size=(NY, NX))
    phi = mu[None, None] * qs[:, :, 3:-3, 3:-3]
    return qs, ru, rv, ww, phi, mu_new


def test_mono_limit_stacked_matches_jax(grids):
    """mono_limit on a stack of 3 scalars in one call against the JAX
    package's, one scalar at a time (the reference's scan body), float64:
    1e-12 of each flux's magnitude."""
    jg, tg = grids
    qs, ru, rv, ww, phi, mu_new = _mono_inputs(3, seed=11)
    dt = 3.0
    tq = _t(qs)
    tf = tadv.scalar_fluxes(tq, _t(ru), _t(rv), _t(ww), 5, 3)
    tl = tadv.mono_limit(tq, _t(phi), _t(mu_new), *tf, _t(ru), _t(rv), _t(ww), dt, tg,
                         THalo())
    with jax.enable_x64(True):
        for i in range(qs.shape[0]):
            jq = jnp.asarray(qs[i])
            jf = jadv.scalar_fluxes(jq, jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(ww),
                                    5, 3)
            jl = jadv.mono_limit(jq, jnp.asarray(phi[i]), jnp.asarray(mu_new), *jf,
                                 jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(ww), dt, jg,
                                 JHalo())
            for a, b in zip(jl, tl):
                assert b.dtype == torch.float64
                assert _rel(np.asarray(a), b[i]) <= 1e-12
    # the limiter changed the fluxes somewhere (the test has teeth)
    assert max(float((a - b).abs().max()) for a, b in zip(tf, tl)) > 0.0


def test_mono_limiter_no_new_extrema():
    """FCT keeps the solution within local bounds and conserves mass (the
    reference's test, on the port)."""
    nz, ny, nx = 6, 4, 32
    cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx, dy=1.0))
    grid = tmake_grid(cfg, constant_n2_theta(), "cpu")
    hx = THalo()
    rng = np.random.default_rng(5)
    q = np.zeros((nz, ny, nx))
    q[:, :, 10:13] = 1.0
    mu_new = torch.ones((ny, nx), dtype=torch.float64)
    u = np.broadcast_to(rng.uniform(0.5, 1.0, (nz, ny, 1)), (nz, ny, nx)).copy() * nx / 4
    ww = torch.zeros((nz + 1, ny, nx), dtype=torch.float64)
    dt = 0.5 * (1.0 / nx) / np.max(u)
    q_pad, ru_pad = hx.pad(_t(q)), hx.pad(_t(u))
    rv_pad = hx.pad(torch.zeros((nz, ny, nx), dtype=torch.float64))
    fx, fy, fz = tadv.scalar_fluxes(q_pad, ru_pad, rv_pad, ww, 5, 3)
    phi_old = _t(q)
    q_unlim = (phi_old + dt * tadv.flux_div(fx, fy, fz, grid)).numpy()
    assert q_unlim.min() < -1e-6 or q_unlim.max() > 1.0 + 1e-6
    lim = tadv.mono_limit(q_pad, phi_old, mu_new, fx, fy, fz, ru_pad, rv_pad, ww, dt,
                          grid, hx)
    q_lim = (phi_old + dt * tadv.flux_div(*lim, grid)).numpy()
    assert q_lim.min() > -1e-6
    assert q_lim.max() < 1.0 + 1e-5
    np.testing.assert_allclose(q_lim.sum(), q_unlim.sum(), rtol=1e-6)


# ---------------------------------------------------------------------------
# Diffusion: the 6th-order filter and the TKE closure
# ---------------------------------------------------------------------------

def _case(nx=24, ny=6, nz=16, **dyn):
    """The squall line in both packages with `dyn` set, the port's state
    carried over from the reference's."""
    cfgs = []
    for m in (jcfg, tcfg):
        c = m.Config(domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                           ztop=17000.0, p_top=8000.0),
                     time_control=m.TimeControl(dt=6.0))
        cfgs.append(c.replace(dynamics=dataclasses.replace(
            c.dynamics, **{k: type(getattr(c.dynamics, k))(v) for k, v in dyn.items()})))
    jc, tc = cfgs
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = {k: np.asarray(v) for k, v in js.items()}
    if "tke" in js:
        rng = np.random.default_rng(3)
        js["tke"] = rng.uniform(0.05, 2.0, js["tke"].shape).astype(np.float32)
    # a sheared, perturbed flow so that every term of the closures is live
    rng = np.random.default_rng(4)
    for k in ("u", "v"):
        js[k] = (js[k] + rng.normal(scale=2.0, size=js[k].shape)).astype(np.float32)
    return jc, tc, jg, jax_grid_to_port(jg), js, state_from_numpy(js, "cpu")


def test_filter6_matches_jax():
    """diffusion_tendencies with diff_6th_opt = 2 (treated as 1, as the
    reference's `_filter6` does) and the scalars stacked: 1e-6 of each
    tendency's magnitude, and the filter's own contribution alone too."""
    jc, tc, jg, tg, js, ts = _case(diff_6th_opt=2, diff_6th_factor=0.12, kvdif=30.0)
    names = tuple(jc.moist_species())
    jout = jdiff.diffusion_tendencies({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                      JHalo(), 6.0, names)
    tout = tdiff.diffusion_tendencies(ts, tg, tc, THalo(), 6.0, names)
    assert set(jout) == set(tout)
    for k in jout:
        assert _rel(jout[k], tout[k]) <= 1e-6, k
    q = THalo().pad(ts["qv"], 3)
    jq = JHalo().pad(jnp.asarray(js["qv"]), 3)
    assert _rel(jdiff._filter6(jq, jg, 0.12, 6.0), tdiff._filter6(q, 0.12, 6.0)) <= 1e-6


def test_torch_gradient_matches_jnp_gradient():
    """torch.gradient along z equals jnp.gradient bit for bit, edges included
    (central differences inside, one-sided at both ends)."""
    a = np.random.default_rng(9).normal(size=(7, 3, 5)).astype(np.float32)
    j = np.asarray(jnp.gradient(jnp.asarray(a), axis=0))
    t = torch.gradient(_t(a), dim=0)[0].numpy()
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t[0], a[1] - a[0])
    np.testing.assert_array_equal(t[-1], a[-1] - a[-2])


def test_tke_closure_matches_jax():
    """km_opt = tke: the exchange coefficient and the TKE tendency, and the
    whole diffusion_tendencies with tke among the scalars: 1e-5 of each
    field's magnitude (e**1.5 and sqrt round differently in the two
    libraries)."""
    jc, tc, jg, tg, js, ts = _case(km_opt="tke")
    ph = np.asarray(jg.phb) + js["ph"]
    dz = (ph[1:] - ph[:-1]) / 9.81
    jk, jt = jdiff.tke_exchange_and_tendency({k: jnp.asarray(v) for k, v in js.items()},
                                             jg, jc, jnp.asarray(dz))
    tk, tt = tdiff.tke_exchange_and_tendency(ts, tg, _t(dz.astype(np.float32)))
    assert _rel(jk, tk) <= 1e-5 and _rel(jt, tt) <= 1e-5
    names = tuple(jc.moist_species()) + ("tke",)
    jout = jdiff.diffusion_tendencies({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                      JHalo(), 6.0, names)
    tout = tdiff.diffusion_tendencies(ts, tg, tc, THalo(), 6.0, names)
    assert set(jout) == set(tout)
    for k in jout:
        assert _rel(jout[k], tout[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# One dycore step under each option
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dyn", [
    {"moist_adv_opt": "mono", "scan_tracer_min": 2},        # the stacked path
    {"moist_adv_opt": "mono"},                              # the per-scalar loop
    {"h_sca_adv_order": 7, "h_mom_adv_order": 7, "scan_tracer_min": 2},
], ids=["mono-stacked", "mono-loop", "weno5-stacked"])
def test_step_options_match_jax(dyn):
    """One `solve.step` of the squall line with the monotonic limiter (on a
    stack and in the per-scalar loop) and with WENO5 scalars and momentum,
    held to the reference's step within 1e-4 of each field's magnitude (w:
    1e-3, its float32 noise; see test_torch_slice.py)."""
    jc, tc, jg, tg, js, ts = _case(kvdif=30.0, **dyn)
    # a moist layer near saturation, so that qc and qr are non-trivial
    for k in ("qc", "qr"):
        js[k] = np.where(js["qv"] > 0.01, 1e-3, 0.0).astype(np.float32)
        ts[k] = _t(js[k])
    pt = {"qv": np.full(js["t"].shape, 1e-7, np.float32)}
    jout = jax.jit(lambda s: jsolve.step(s, jg, jc, JHalo(), 6.0,
                                         {k: jnp.asarray(v) for k, v in pt.items()}))(
        {k: jnp.asarray(v) for k, v in js.items()})
    tout = tsolve.step(ts, tg, tc, THalo(), 6.0, {k: _t(v) for k, v in pt.items()})
    for k in ("u", "v", "w", "t", "mu", "qv", "qc", "qr"):
        lim = 1e-3 if k == "w" else 1e-4
        assert _rel(jout[k], tout[k]) <= lim, (k, _rel(jout[k], tout[k]))
    for k in ("qv", "qc", "qr"):
        assert float(tout[k].min()) >= 0.0


# ---------------------------------------------------------------------------
# Stochastic patterns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,seed", [(0, 0), (5, 0), (123456, 1), (2 ** 32 - 1, 7)])
def test_white_noise_bitwise(step, seed):
    """The hash noise equals the reference's bit for bit."""
    j = np.asarray(jstoch.white_noise((12, 20), JHalo(), np.uint32(step), seed))
    t = tstoch.white_noise((12, 20), step, seed).numpy()
    np.testing.assert_array_equal(j, t)


def test_patterns_match_jax():
    """smooth, evolve_pattern (20 AR(1) steps), apply_sppt and
    skebs_increments: 1e-5 of the magnitude (float32 constants of exp and
    sqrt may round differently)."""
    jh, th = JHalo(), THalo()
    jp = jnp.zeros((16, 24), jnp.float32)
    tp = torch.zeros((16, 24))
    for s in range(20):
        jp = jstoch.evolve_pattern(jp, jh, 600.0, jnp.uint32(s), seed=1)
        tp = tstoch.evolve_pattern(tp, th, 600.0, s, seed=1)
    assert _rel(jp, tp) <= 1e-5
    jdu, jdv = jstoch.skebs_increments(jp, jh, 1e-5, 1000.0, 500.0)
    tdu, tdv = tstoch.skebs_increments(tp, th, 1e-5, 1000.0, 500.0)
    assert _rel(jdu, tdu) <= 1e-5 and _rel(jdv, tdv) <= 1e-5
    tend = {"th": np.ones((3, 16, 24), np.float32), "qc": np.ones((3, 16, 24), np.float32)}
    ja = jstoch.apply_sppt({k: jnp.asarray(v) for k, v in tend.items()}, jp, 0.5)
    ta = tstoch.apply_sppt({k: _t(v) for k, v in tend.items()}, tp, 0.5)
    assert _rel(ja["th"], ta["th"]) <= 1e-5
    assert torch.equal(ta["qc"], _t(tend["qc"]))          # only th, qv, u, v


def test_pattern_statistics_and_correlation():
    """The reference's statistics test, on the port: O(1) amplitude, strong
    temporal and spatial correlation, reproducible noise."""
    hx = THalo()
    r1 = tstoch.smooth(tstoch.white_noise((32, 48), 0), hx)
    for s in range(1, 30):
        r1 = tstoch.evolve_pattern(r1, hx, 600.0, s)
    r2 = tstoch.evolve_pattern(r1, hx, 60.0, 99)
    a1, a2 = r1.numpy(), r2.numpy()
    assert 0.2 < a1.std() < 3.0
    assert abs(a1.mean()) < 0.5
    assert np.corrcoef(a1.ravel(), a2.ravel())[0, 1] > 0.95
    assert np.corrcoef(a1[:, :-1].ravel(), a1[:, 1:].ravel())[0, 1] > 0.5
    assert torch.equal(tstoch.white_noise((8, 8), 5), tstoch.white_noise((8, 8), 5))


def test_skebs_increments_are_rotational():
    """The reference's SKEBS test, on the port: nondivergent increments."""
    hx = THalo()
    psi = tstoch.smooth(tstoch.white_noise((24, 24), 7), hx)
    du, dv = (a.numpy() for a in tstoch.skebs_increments(psi, hx, 1e-5, 1000.0, 1000.0))
    div = (np.roll(du, -1, 1) - np.roll(du, 1, 1)) / 2000.0 \
        + (np.roll(dv, -1, 0) - np.roll(dv, 1, 0)) / 2000.0
    scale = max(np.abs(du).max(), np.abs(dv).max()) / 1000.0
    assert np.abs(div[2:-2, 2:-2]).max() < 0.3 * scale + 1e-12
    assert np.abs(du).max() > 0.0


def test_sppt_paired_runs_diverge():
    """The reference's paired-run test, on the port: runs with and without
    SPPT differ, and the perturbed run stays stable."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim
    out = {}
    for name, amp in (("off", 0.0), ("on", 0.5)):
        cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=32, ny=4, nz=12, dx=1000.0, dy=1000.0,
                                                   ztop=12000.0, p_top=20000.0),
                          time_control=tcfg.TimeControl(dt=5.0),
                          dynamics=tcfg.DynamicsConfig(kvdif=20.0, sppt_amp=amp))
        grid, state = tideal.make_case(cfg, "warm_bubble", device="cpu", amplitude=2.0)
        sim = TSim(cfg, grid, state, device="cpu")
        sim.advance(40)
        out[name] = sim.state["w"].numpy()
    assert np.isfinite(out["on"]).all()
    d = np.abs(out["on"] - out["off"]).max()
    assert 1e-4 < d < 2.0 * np.abs(out["off"]).max() + 0.1, d
