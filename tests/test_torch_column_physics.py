"""The port's column physics against the JAX package, on the reference
tests' columns (tests/test_pbl.py, test_lsm.py, test_cu_wsm6.py) (CPU):
the surface layer with YSU over the slab surface and over Noah, the Noah
step alone, MYNN, BMJ, KF and Grell cumulus, WSM6 and the simple radiation;
then a few of the reference's property tests, run on the port.

Tolerance: these schemes pick branches (`where`, `argmax` of the PBL top,
trigger thresholds) on values that float32 noise can move, so both sides
run in float64 and agree to 1e-9 of each field's magnitude (exp, pow and
the order of a sum are the only differences left).  The radiation driver
with the simple scheme runs in float32, as the model runs it, to 1e-5.
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
from wrfchem_arc_interactions_tpu.dycore.diagnostics import diagnose as jdiagnose  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import cumulus as jbmj  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import cumulus_grell as jgrell  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import cumulus_kf as jkf  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import lsm as jlsm  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import pbl as jpbl  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import pbl_mynn as jmynn  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.microphysics import wsm6 as jwsm6  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.microphysics.kessler import _qvs as jqvs  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import driver as jrad  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import simple as jsimple  # noqa: E402
from wrfchem_arc_interactions_tpu.utils import constants as c  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose as tdiagnose  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import cumulus as tbmj  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import cumulus_grell as tgrell  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import cumulus_kf as tkf  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import lsm as tlsm  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import pbl as tpbl  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import pbl_mynn as tmynn  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.microphysics import wsm6 as twsm6  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import driver as trad  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import simple as tsimple  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_slice import _rel, jax_grid_to_port  # noqa: E402

TOL64 = 1e-9


def _both(jfn, tfn, *arrays, **kw):
    """jfn(*jax arrays) in float64 and tfn(*tensors) on the same numpy
    inputs (float64); returns both results as nested numpy."""
    with jax.enable_x64(True):
        jout = jfn(*(jnp.asarray(a, jnp.float64) for a in arrays), **kw)
        jout = jax.tree.map(np.asarray, jout)
    tout = tfn(*(torch.from_numpy(np.asarray(a, np.float64)) for a in arrays), **kw)
    return jout, tout


def _close(jout, tout, tol=TOL64, what=""):
    if isinstance(jout, dict):
        assert set(jout) <= set(tout), (what, set(jout) ^ set(tout))
        for k in jout:
            _close(jout[k], tout[k], tol, f"{what}.{k}")
    elif isinstance(jout, (tuple, list)):
        for i, (a, b) in enumerate(zip(jout, tout)):
            _close(a, b, tol, f"{what}[{i}]")
    else:
        b = tout.numpy() if isinstance(tout, torch.Tensor) else np.asarray(tout)
        assert np.isfinite(b).all(), what
        assert _rel(jout, b, float(np.abs(np.asarray(jout)).max())) <= tol, \
            (what, _rel(jout, b, float(np.abs(np.asarray(jout)).max())))


def _column_case(nx=8, ny=4, nz=16, **phys):
    """The reference tests' quiescent column set in both packages with
    `phys` (enum values by name) and RRTMG fields present, so that the
    slab and the Noah surface see radiation; float64 numpy state."""
    cfgs = []
    for m in (jcfg, tcfg):
        ph = m.PhysicsConfig(ra_sw_physics=m.namelist.RAScheme.RRTMG,
                             ra_lw_physics=m.namelist.RAScheme.RRTMG)
        ph = dataclasses.replace(ph, **{k: type(getattr(ph, k))(v) for k, v in phys.items()})
        cfgs.append(m.Config(domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=2000.0, dy=2000.0,
                                                   ztop=12000.0, p_top=20000.0),
                             physics=ph))
    jc, tc = cfgs
    jg, js = jideal.make_case(jc, "quiescent")
    rng = np.random.default_rng(17)
    js = {k: np.asarray(v, np.float64) for k, v in js.items()}
    js["tsk"] = js["tsk"] + 5.0 + rng.uniform(-2.0, 2.0, js["tsk"].shape)
    js["u"] = js["u"] + 3.0 + rng.normal(size=js["u"].shape)
    js["v"] = js["v"] + rng.normal(size=js["v"].shape)
    js["qv"] = np.full(js["t"].shape, 8e-3) * np.exp(-np.arange(nz) / 6.0)[:, None, None]
    js["swdown"] = np.full(js["tsk"].shape, 600.0)
    js["glw"] = np.full(js["tsk"].shape, 350.0)
    if "qke" in js:
        js["qke"] = rng.uniform(0.01, 1.0, js["qke"].shape)
    if "smois" in js:
        js["smois"] = rng.uniform(0.12, 0.4, js["smois"].shape)
        js["ivgtyp"] = rng.integers(0, 6, js["ivgtyp"].shape).astype(np.float64)
        js["rainnc"] = rng.uniform(0.0, 2.0, js["rainnc"].shape)
    return jc, tc, jg, jax_grid_to_port(jg), js


def _pbl_both(jfn, tfn, jc, tc, jg, tg, js, dt=10.0):
    with jax.enable_x64(True):
        jout = jfn({k: jnp.asarray(v) for k, v in js.items()}, jg, jc, dt)
        jout = jax.tree.map(np.asarray, jout)
    tout = tfn(state_from_numpy(js, "cpu"), tg, tc, dt)
    return jout, tout


@pytest.mark.parametrize("surface", ["slab", "noah"])
def test_ysu_matches_jax(surface):
    """surface_and_pbl (revised MM5 surface layer, YSU) over the slab
    surface and over Noah: the fluxes, the PBL height, the surface and soil
    fields and the four tendencies."""
    jc, tc, jg, tg, js = _column_case(bl_pbl_physics="ysu",
                                      sf_sfclay_physics="revised_mm5",
                                      sf_surface_physics=surface)
    (jst, jtend), (tst, ttend) = _pbl_both(jpbl.surface_and_pbl, tpbl.surface_and_pbl,
                                           jc, tc, jg, tg, js)
    _close(jtend, ttend, what="tend")
    names = ["hfx", "qfx", "ust", "pblh", "tsk"]
    if surface == "noah":
        names += ["tslb", "smois", "snow", "rain_prev"]
        assert float(np.abs(jst["smois"] - js["smois"]).max()) > 0.0
    _close({k: jst[k] for k in names}, tst, what="state")
    assert float(np.abs(jst["tsk"] - js["tsk"]).max()) > 0.0
    # the reference test's signs, on the port: heated ground, drag
    assert float(tst["hfx"].min()) > 0.0 and float(tst["ust"].min()) > 0.05
    assert float(ttend["th"][0].mean()) > 0.0 and float(ttend["u"][0].mean()) < 0.0


def test_mynn_matches_jax():
    """mynn_column over the slab surface: QKE, the fluxes and the
    tendencies; the stability functions at the reference test's G_h."""
    jc, tc, jg, tg, js = _column_case(bl_pbl_physics="mynn",
                                      sf_sfclay_physics="revised_mm5")
    (jst, jtend), (tst, ttend) = _pbl_both(jmynn.mynn_column, tmynn.mynn_column,
                                           jc, tc, jg, tg, js)
    _close(jtend, ttend, what="tend")
    _close({k: jst[k] for k in ("qke", "hfx", "qfx", "ust", "pblh", "tsk")}, tst,
           what="state")
    gh = np.array([-5.0, -0.2, 0.0, 0.02, 0.1])
    jsm, tsm = _both(jmynn.stability_functions, tmynn.stability_functions, gh)
    _close(jsm, tsm)
    sm = tsm[0].numpy()
    assert 0.2 < sm[2] < 0.5 and sm[1] < sm[2] < sm[3]      # stable mixes less


def _soil_state(tsk=300.0, sm=0.25, shp=(2, 3)):
    """The reference test's soil columns, with a snowpack and classes."""
    return {"tsk": np.full(shp, tsk), "tslb": np.full((4,) + shp, 285.0),
            "smois": np.full((4,) + shp, sm), "tmn": np.full(shp, 285.0),
            "snow": np.array([[0.0, 2.0, 20.0], [0.0, 0.5, 5.0]]),
            "ivgtyp": np.array([[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]])}


@pytest.mark.parametrize("tsk,precip", [(300.0, 0.0), (305.0, 2e-3), (268.0, 1e-3),
                                        (274.0, 0.0)])
def test_noah_step_matches_jax(tsk, precip):
    """noah_step alone, warm and cold skins with and without precipitation
    (snowfall, melt and sublimation all live in some column), five steps."""
    st = _soil_state(tsk=tsk)
    shp = (2, 3)
    args = (np.zeros(shp) + 20.0, np.full(shp, 1e-4), np.full(shp, 50.0), 1.2,
            np.full(shp, precip), np.full(shp, 600.0), np.full(shp, 330.0))
    jst = dict(st)
    tst = dict(st)
    for _ in range(5):
        with jax.enable_x64(True):
            ju = jlsm.noah_step({k: jnp.asarray(v) for k, v in jst.items()},
                                *(jnp.asarray(a) for a in args), 60.0,
                                t_air0=jnp.asarray(np.full(shp, tsk - 1.0)))
            ju = {k: np.asarray(v) for k, v in ju.items()}
        tu = tlsm.noah_step({k: torch.from_numpy(v) for k, v in tst.items()},
                            *(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                              else a for a in args), 60.0,
                            t_air0=torch.from_numpy(np.full(shp, tsk - 1.0)))
        _close(ju, tu)
        jst.update({k: ju[k] for k in ("tsk", "tslb", "smois", "snow")})
        tst.update({k: tu[k].numpy() for k in ("tsk", "tslb", "smois", "snow")})
    assert (tst["smois"] >= 0.02).all() and (tst["smois"] <= tlsm.SM_SAT).all()


def _unstable_sounding(nz=30, ny=2, nx=3):
    """The reference tests' conditionally unstable, moist column set, with
    a little horizontal variation (k = 0 at the surface)."""
    z = np.arange(nz) * 400.0
    t = 302.0 - 6.5e-3 * z
    p = 1.0e5 * np.exp(-z / 8000.0)
    qv = 0.016 * np.exp(-z / 2500.0)
    rho = p / (c.R_D * t)
    shp = (nz, ny, nx)
    jitter = 1.0 + 0.02 * np.random.default_rng(1).uniform(-1, 1, (1, ny, nx))

    def tile(a):
        return np.broadcast_to(a.reshape(-1, 1, 1), shp).copy()

    theta = t / (p / c.P0) ** c.RCP
    return tile(theta), tile(qv) * jitter, tile(p), tile(rho), tile(np.full(nz, 400.0))


def _stable_dry(theta, qv, p, rho, dz):
    return theta + np.arange(theta.shape[0]).reshape(-1, 1, 1) * 3.0, qv * 0.05, p, rho, dz


@pytest.mark.parametrize("scheme", ["bmj", "kf", "grell"])
@pytest.mark.parametrize("column", ["unstable", "stable_dry"])
def test_cumulus_matches_jax(scheme, column):
    """BMJ, KF and the Grell ensemble: tendencies and rain on the
    reference tests' unstable column (they convect) and its stable dry
    variant (they do not)."""
    fns = {"bmj": (jbmj.bmj_adjust, tbmj.bmj_adjust),
           "kf": (jkf.kf_mass_flux, tkf.kf_mass_flux),
           "grell": (jgrell.grell_ensemble, tgrell.grell_ensemble)}[scheme]
    cols = _unstable_sounding()
    if column == "stable_dry":
        cols = _stable_dry(*cols)
    jout, tout = _both(lambda *a: fns[0](*a, 10.0), lambda *a: fns[1](*a, 10.0), *cols)
    _close(jout, tout)
    rain = tout[1]
    if column == "unstable":
        assert float(rain.min()) > 0.0
    else:
        assert float(rain.abs().max()) == 0.0 and float(tout[0]["th"].abs().max()) == 0.0


def test_wsm6_matches_jax():
    """Three WSM6 calls on the reference test's supersaturated column set
    (warm rain below, ice and snow aloft, precipitation at the ground)."""
    cfgs = []
    for m in (jcfg, tcfg):
        cfgs.append(m.Config(domain=m.DomainConfig(nx=6, ny=4, nz=24, dx=2000.0, dy=2000.0,
                                                   ztop=14000.0, p_top=15000.0),
                             time_control=m.TimeControl(dt=10.0),
                             physics=m.PhysicsConfig(mp_physics=m.namelist.MPScheme.WSM6)))
    jc, tc = cfgs
    jg, js = jideal.make_case(jc, "quiescent")
    moist = jc.moist_species()
    with jax.enable_x64(True):
        js = {k: jnp.asarray(v, jnp.float64) for k, v in js.items()}
        for _ in range(4):
            d = jdiagnose(js, jg, moist)
            js["qv"] = 1.15 * jqvs(d.p_full, d.theta * (d.p_full / c.P0) ** c.RCP)
        js = {k: np.asarray(v) for k, v in js.items()}
    tg = jax_grid_to_port(jg)
    jst, tst = dict(js), state_from_numpy(js, "cpu")
    for _ in range(3):
        with jax.enable_x64(True):
            jj = {k: jnp.asarray(v) for k, v in jst.items()}
            jst = {k: np.asarray(v) for k, v in
                   jwsm6.wsm6(jj, jdiagnose(jj, jg, moist), jg, jc, 30.0).items()}
        tst = twsm6.wsm6(tst, tdiagnose(tst, tg, moist), tg, tc, 30.0)
    _close({k: jst[k] for k in moist + ("t", "rainnc")}, tst)
    assert float(tst["qr"].max()) > 1e-6 and float(tst["rainnc"].max()) > 0.0
    assert float((tst["qi"] + tst["qs"]).max()) > 1e-8
    assert all(float(tst[q].min()) >= 0.0 for q in moist)


def test_simple_radiation_matches_jax():
    """sw_simple and lw_simple on columns with cloud, by day and by night
    (float64), and the radiation driver with ra_*_physics = simple on the
    squall line at noon (float32, 1e-5)."""
    rng = np.random.default_rng(23)
    nz, ncol = 20, 12
    p = np.linspace(1.0e5, 2.0e4, nz)[:, None] * np.ones((1, ncol))
    t = np.linspace(295.0, 215.0, nz)[:, None] + rng.normal(size=(nz, ncol))
    dp = np.full((nz, ncol), 4000.0)
    qv = 0.012 * np.exp(-np.arange(nz) / 5.0)[:, None] * rng.uniform(0.5, 1.5, (nz, ncol))
    lwp = np.where(rng.uniform(size=(nz, ncol)) < 0.2, rng.uniform(0, 0.1, (nz, ncol)), 0.0)
    mu0 = np.linspace(-0.3, 1.0, ncol)
    alb = np.full(ncol, 0.2)
    _close(*_both(jsimple.sw_simple, tsimple.sw_simple, p, t, dp, qv, lwp, mu0, alb))
    _close(*_both(jsimple.lw_simple, tsimple.lw_simple, p, t, dp, qv, lwp, t[0] + 2.0))

    cfgs = []
    for m in (jcfg, tcfg):
        rs = m.namelist.RAScheme.SIMPLE
        cfgs.append(m.Config(domain=m.DomainConfig(nx=12, ny=4, nz=16, dx=1000.0, dy=1000.0,
                                                   ztop=17000.0, p_top=8000.0),
                             physics=m.PhysicsConfig(ra_sw_physics=rs, ra_lw_physics=rs)))
    jc, tc = cfgs
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = {k: np.asarray(v) for k, v in js.items()}
    js["qc"] = np.where(js["qv"] > 0.012, 2e-5, 0.0).astype(np.float32)
    jout = jrad.radiation_driver({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                 np.float32(43200.0))
    tout = trad.radiation_driver(state_from_numpy(js, "cpu"), jax_grid_to_port(jg), tc,
                                 np.float32(43200.0))
    for k in ("rthraten_sw", "rthraten_lw", "swdown", "swupt", "olr", "glw"):
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert b.dtype == np.float32 and _rel(a, b, float(np.abs(a).max())) <= 1e-5, k
    assert float(tout["swdown"].max()) > 100.0


def test_soil_heat_diffuses_downward():
    """The reference's Noah test, on the port: ~2 h of strong heating
    propagates into the soil with decreasing amplitude."""
    st = {"tsk": torch.full((2, 3), 305.0), "tslb": torch.full((4, 2, 3), 285.0),
          "smois": torch.full((4, 2, 3), 0.25), "tmn": torch.full((2, 3), 285.0)}
    z = torch.zeros((2, 3))
    for _ in range(200):
        upd = tlsm.noah_step(st, z, z, torch.full((2, 3), 50.0), 1.2, z,
                             torch.full((2, 3), 600.0), torch.full((2, 3), 350.0), 36.0)
        st.update({k: upd[k] for k in ("tsk", "tslb", "smois")})
    t = st["tslb"][:, 0, 0]
    assert bool(torch.isfinite(st["tslb"]).all())
    assert float(t[0]) > float(t[1]) > float(t[3]) and float(t[0]) > 286.0
    assert float(t[3]) < 290.0


def test_bmj_conserves_enthalpy():
    """The reference's BMJ test, on the port: the column's drying feeds the
    rain, and the cp-weighted warming balances the latent release."""
    theta, qv, p, rho, dz = (torch.from_numpy(a) for a in _unstable_sounding())
    tend, precip = tbmj.bmj_adjust(theta, qv, p, rho, dz, 10.0)
    assert float(precip.min()) > 0.0
    dm = rho * dz
    torch.testing.assert_close(-(dm * tend["qv"]).sum(0), precip, rtol=1e-4, atol=0.0)
    pii = (p / c.P0) ** c.RCP
    col_h = (dm * (c.CP * tend["th"] * pii + c.XLV * tend["qv"])).sum(0)
    assert bool((col_h.abs() < 0.02 * c.XLV * precip + 1e-6).all())
