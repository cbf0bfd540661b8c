"""The port's Morrison two-moment microphysics and Abdul-Razzak & Ghan
activation against the JAX package on identical seeded inputs (both on the
CPU): `mixactivate.activate_fractions`, the predicted-supersaturation
condensation, the sedimentation pass and `morrison` itself on a squall-line
column set loaded with random hydrometeors, with and without activation
(progn) and with the prognostic rime volume.  Every field is held to 1e-4
of its magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore.diagnostics import diagnose as jdiagnose  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.physics import mixactivate as jmix  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.microphysics import morrison as jmor  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose as tdiagnose  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics import mixactivate as tmix  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.microphysics import morrison as tmor  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_mosaic import make_chem  # noqa: E402
from test_torch_slice import jax_grid_to_port  # noqa: E402

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _cfg(m, progn):
    nl = m.namelist
    return m.Config(
        domain=m.DomainConfig(nx=12, ny=3, nz=16, dx=1000.0, dy=1000.0,
                              ztop=17000.0, p_top=8000.0),
        time_control=m.TimeControl(dt=6.0),
        dynamics=m.DynamicsConfig(kvdif=30.0),
        physics=m.PhysicsConfig(mp_physics=nl.MPScheme.MORRISON2, progn=progn))


def _loaded_state(seed):
    """A Morrison squall-line state with random hydrometeors of every class
    in a third of the cells, supersaturated and subsaturated vapour, and a
    temperature range that crosses every freezing / melting threshold."""
    jc = _cfg(jcfg, True)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    assert tuple(jc.moist_species()) == tuple(_cfg(tcfg, True).moist_species())
    assert len(jc.moist_species()) == 12
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    rng = np.random.default_rng(seed)
    shp = js["t"].shape
    on = lambda p: rng.uniform(size=shp) < p          # noqa: E731
    js["qv"] = js["qv"] * rng.uniform(0.6, 1.25, shp)
    js["t"] = js["t"] + rng.normal(size=shp) * 2.0
    for q, n, qmax, nmax in (("qc", "nc", 2e-3, 4e8), ("qr", "nr", 3e-3, 1e4),
                             ("qi", "ni", 5e-4, 1e6), ("qs", "ns", 2e-3, 1e5),
                             ("qg", "ng", 3e-3, 1e4)):
        m = on(0.35)
        js[q] = (m * qmax * rng.uniform(0.0, 1.0, shp)).astype(np.float32)
        js[n] = (m * nmax * rng.uniform(0.01, 1.0, shp)).astype(np.float32)
    js["qgv"] = (js["qg"] / rng.uniform(100.0, 800.0, shp)).astype(np.float32)
    js = {k: v.astype(np.float32) for k, v in js.items()}
    return jc, jg, js


def test_activate_fractions():
    chem, env = make_chem(3)
    rng = np.random.default_rng(3)
    shp = env["t_air"].shape
    p = rng.uniform(4e4, 1e5, shp).astype(np.float32)
    w = rng.normal(size=shp).astype(np.float32) * 2.0
    t_air = np.clip(env["t_air"], 250.0, 300.0)
    jn, jsm, jfr = jmix.activate_fractions(
        {k: jnp.asarray(v) for k, v in chem.items()}, jnp.asarray(t_air), jnp.asarray(p),
        jnp.asarray(env["rho"]), jnp.asarray(w), 4)
    tn, tsm, tfr = tmix.activate_fractions(
        {k: _t(v) for k, v in chem.items()}, _t(t_air), _t(p), _t(env["rho"]), _t(w), 4)
    assert float(tn.max()) > 1e6
    assert _rel(jn, tn.numpy()) <= TOL and _rel(jsm, tsm.numpy()) <= TOL
    for a, b in zip(jfr, tfr):
        assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= TOL
    tn2, tsm2 = tmix.activate({k: _t(v) for k, v in chem.items()}, _t(t_air), _t(p),
                              _t(env["rho"]), _t(w), 4)
    assert torch.equal(tn2, tn) and torch.equal(tsm2, tsm)


def test_supersat_condense_and_sedimentation():
    rng = np.random.default_rng(4)
    shp = (10, 3, 4)
    theta = rng.uniform(290.0, 320.0, shp).astype(np.float32)
    p = np.broadcast_to(np.linspace(9.5e4, 4e4, 10)[:, None, None], shp).astype(np.float32)
    pii = (p / 1e5) ** (287.0 / 1004.5)
    qvs = np.asarray(jmor._qvs(jnp.asarray(p), jnp.asarray(theta * pii)))
    qv = (qvs * rng.uniform(0.7, 1.05, shp)).astype(np.float32)
    qc = (1e-3 * rng.uniform(0, 1, shp) * (rng.uniform(size=shp) > 0.5)).astype(np.float32)
    nc = (5e8 * rng.uniform(0, 1, shp) * (qc > 0)).astype(np.float32)
    rho = rng.uniform(0.5, 1.2, shp).astype(np.float32)
    args = (theta, qv, qc, nc, p, pii.astype(np.float32), rho)
    jout = jmor._supersat_condense(*(jnp.asarray(a) for a in args), 6.0)
    tout = tmor._supersat_condense(*(_t(a) for a in args), 6.0)
    for a, b in zip(jout, tout):
        assert _rel(a, b.numpy()) <= TOL
    dz = rng.uniform(200.0, 500.0, shp).astype(np.float32)
    q = (2e-3 * rng.uniform(0, 1, shp)).astype(np.float32)
    n = (1e4 * rng.uniform(0, 1, shp)).astype(np.float32)
    vol = (q / 400.0).astype(np.float32)
    for kind, kw in (("r", {}), ("s", {}), ("i", {}), ("g", {"extra": vol, "rho_x": 400.0})):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        js_ = jmor._sediment_pair(jnp.asarray(q), jnp.asarray(n), kind, jnp.asarray(rho),
                                  jnp.asarray(dz), 6.0, 2, **jkw)
        ts_ = tmor._sediment_pair(_t(q), _t(n), kind, _t(rho), _t(dz), 6.0, 2, **tkw)
        assert len(js_) == len(ts_)
        for a, b in zip(js_, ts_):
            assert _rel(a, b.numpy()) <= TOL, kind


@pytest.mark.parametrize("progn,with_act,with_qgv", [
    (True, True, True), (True, True, False), (False, False, True), (True, False, False)])
def test_morrison_matches_jax(progn, with_act, with_qgv):
    jc, jg, js = _loaded_state(5)
    if not with_qgv:
        js.pop("qgv")
    jc, tc = _cfg(jcfg, progn), _cfg(tcfg, progn)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    moist = tuple(q for q in jc.moist_species() if q in js)
    jd, td = jdiagnose(jsj, jg, moist), tdiagnose(ts, tg, moist)
    n_act = None
    if with_act:
        n_act = (3e8 * np.random.default_rng(6).uniform(0, 1, js["t"].shape)).astype(np.float32)
    jout = jmor.morrison(jsj, jd, jg, jc, 6.0,
                         n_act=None if n_act is None else jnp.asarray(n_act))
    tout = tmor.morrison(ts, td, tg, tc, 6.0, n_act=None if n_act is None else _t(n_act))
    assert set(jout) == set(tout)
    worst = {}
    for k, a in jout.items():
        b = tout[k].numpy()
        assert np.isfinite(b).all(), k
        a = np.asarray(a)
        # theta is compared as the full potential temperature
        off = 300.0 if k == "t" else 0.0
        worst[k] = _rel(a + off, b + off)
    changed = [k for k in ("qc", "qr", "qi", "qs", "qg", "nc", "ni", "rainnc")
               if float(np.abs(np.asarray(jout[k]) - js[k]).max()) > 0]
    assert len(changed) >= 7, changed
    bad = {k: v for k, v in worst.items() if v > TOL}
    print("morrison worst:", max(worst.values()))
    assert not bad, bad
