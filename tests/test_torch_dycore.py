"""The port's dycore pieces against the JAX package on identical inputs
(CPU): the Thomas solve, halo padding, stage diagnostics, the large-step
terms, one RK stage's acoustic loop, diffusion and Kessler microphysics.

Inputs are the squall-line case of both packages (small grid) and seeded
numpy perturbations of it; the reference functions run eagerly on the CPU.
Tolerances are float32 ones: 1e-6 of the field's magnitude where the port
repeats the reference's arithmetic in the same order, 1e-5 where a
transcendental (pow, exp) or a reduction may round differently.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.config.namelist import BCKind as JBC  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import big_step as jbs  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import diagnostics as jdiag  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import diffusion as jdiff  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import solve as jsolve  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore.tridiag import thomas as jthomas  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.microphysics import kessler as jkessler  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind as TBC  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import big_step as tbs  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import diagnostics as tdiag  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import diffusion as tdiff  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore.small_step import acoustic_loop  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas as tthomas  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.microphysics import kessler as tkessler  # noqa: E402


def _rel(ref, out, scale=None):
    ref = np.asarray(ref, np.float64)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    s = np.abs(ref).max() if scale is None else scale
    return float(np.abs(ref - out.astype(np.float64)).max() / max(s, 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(nx=24, ny=6, nz=16):
    out = []
    for m in (jcfg, tcfg):
        out.append(m.Config(
            domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                  ztop=17000.0, p_top=8000.0),
            time_control=m.TimeControl(dt=6.0),
            dynamics=m.DynamicsConfig(kvdif=30.0)))
    return out


@pytest.fixture(scope="module")
def case():
    """Squall-line grid + state in both packages, with seeded wind and
    moisture perturbations so that every term is active."""
    jc, tc = _cfgs()
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    rng = np.random.default_rng(7)
    js = dict(js)
    for name, amp in (("u", 2.0), ("v", 2.0), ("w", 0.5)):
        js[name] = js[name] + jnp.asarray(
            (amp * rng.normal(size=js[name].shape)).astype(np.float32))
    gfields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    gfields = {k: (v if isinstance(v, (float, bool)) else np.asarray(v))
               for k, v in gfields.items()}
    tg = grid_from_numpy(gfields, "cpu")
    ts = {k: _t(v) for k, v in js.items()}
    return jc, tc, jg, js, tg, ts


def test_thomas_matches_jax():
    rng = np.random.default_rng(0)
    n, ny, nx = 21, 3, 5
    a = rng.uniform(-0.3, -0.1, (n, ny, nx)).astype(np.float32)
    cc = rng.uniform(-0.3, -0.1, (n, ny, nx)).astype(np.float32)
    b = (1.0 + np.abs(a) + np.abs(cc)).astype(np.float32)
    d = rng.normal(size=(n, ny, nx)).astype(np.float32)
    ref = jthomas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(cc), jnp.asarray(d))
    out = tthomas(_t(a), _t(b), _t(cc), _t(d))
    assert out.shape == (n, ny, nx)
    assert _rel(ref, out) <= 1e-6


_BCS = [("periodic", "periodic"), ("open", "open"), ("symmetric", "symmetric"),
        ("periodic", "symmetric"), ("open", "periodic")]


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("bcs", _BCS)
def test_halo_pad_exact(bcs, width):
    """HaloOps.pad equals the reference's jnp.pad bit for bit, corners
    included, for 3D and 2D fields."""
    bx, by = bcs
    jh = JHalo(bc_x=JBC(bx), bc_y=JBC(by))
    th = THalo(bc_x=TBC(bx), bc_y=TBC(by))
    rng = np.random.default_rng(width)
    for shape in ((4, 6, 7), (6, 7)):
        a = rng.normal(size=shape).astype(np.float32)
        ref = np.asarray(jh.pad(jnp.asarray(a), width))
        out = th.pad(_t(a), width).numpy()
        np.testing.assert_array_equal(ref, out)
    many = th.pad_many({"a": _t(a), "b": _t(2 * a)}, width)
    np.testing.assert_array_equal(many["b"].numpy(),
                                  np.asarray(jh.pad(jnp.asarray(2 * a), width)))


def test_diagnose(case):
    jc, tc, jg, js, tg, ts = case
    jd = jdiag.diagnose(js, jg, jc.moist_species())
    td = tdiag.diagnose(ts, tg, tc.moist_species())
    for f in dataclasses.fields(jd):
        assert _rel(getattr(jd, f.name), getattr(td, f.name)) <= 1e-5, f.name


def test_big_step_terms(case):
    """PGF, Coriolis (f-plane), buoyancy, omega diagnosis and R_phi."""
    jc, tc, jg, js, tg, ts = case
    jg = dataclasses.replace(jg, f=jnp.full_like(jg.f, 1e-4))
    tg = dataclasses.replace(tg, f=torch.full_like(tg.f, 1e-4))
    jh, th = JHalo(), THalo()
    jd = jdiag.diagnose(js, jg, jc.moist_species())
    td = tdiag.diagnose(ts, tg, tc.moist_species())

    def both(jarr, tarr):
        return jh.pad(jarr, 3), th.pad(tarr, 3)

    jp, tp = both(jd.p_pert, td.p_pert)
    jph, tph = both(js["ph"], ts["ph"])
    jal, tal = both(jd.alpha_d, td.alpha_d)
    jeps, teps = both(jd.eps_ratio, td.eps_ratio)
    jmu, tmu = both(jd.mu_full, td.mu_full)
    ju, tu = both(js["u"], ts["u"])
    jv, tv = both(js["v"], ts["v"])

    for a, b in zip(jbs.pgf_uv(jp, jph, jal, jeps, jmu, jg),
                    tbs.pgf_uv(tp, tph, tal, teps, tmu, tg)):
        assert _rel(a, b) <= 1e-5
    for a, b in zip(jbs.coriolis_uv(ju, jv, jmu, jg), tbs.coriolis_uv(tu, tv, tmu, tg)):
        assert _rel(a, b) <= 1e-6
    assert _rel(jbs.buoyancy_w(jd.p_pert, jd.eps_ratio, js["mu"], jg),
                tbs.buoyancy_w(td.p_pert, td.eps_ratio, ts["mu"], tg)) <= 1e-5
    jru = jsolve._mu_u(jmu)[None] * ju
    jrv = jsolve._mu_v(jmu)[None] * jv
    tru = tsolve._mu_u(tmu)[None] * tu
    trv = tsolve._mu_v(tmu)[None] * tv
    assert _rel(jru, tru) == 0.0 and _rel(jrv, trv) == 0.0
    jdm, jww = jbs.omega_diagnosis(jru, jrv, jg, jh)
    tdm, tww = tbs.omega_diagnosis(tru, trv, tg)
    assert _rel(jdm, tdm) <= 1e-5
    assert _rel(jww, tww) <= 1e-5
    w_cpl = jd.mu_full[None] * js["w"]
    jr = jbs.rphi_tendency(jru, jrv, jph, w_cpl, jww, jd.mu_full, jg)
    tr = tbs.rphi_tendency(tru, trv, tph, _t(w_cpl), _t(jww), td.mu_full, tg)
    assert _rel(jr, tr) <= 1e-5


def test_acoustic_loop_one_stage(case, monkeypatch):
    """The acoustic loop of the second RK stage (ns = 2 substeps) on the
    reference's own stage inputs, captured from a reference step: <= 1e-5
    of each output's magnitude."""
    jc, tc, jg, js, tg, ts = case
    calls = []
    real = jsolve.acoustic_loop

    def recording(pp, R, ac, ns, dtau, grid, cfg, hx):
        out = real(pp, R, ac, ns, dtau, grid, cfg, hx)
        calls.append((pp, R, ac, ns, dtau, out))
        return out

    monkeypatch.setattr(jsolve, "acoustic_loop", recording)
    jsolve.step(js, jg, jc, JHalo(), jc.time_control.dt)
    pp, R, ac, ns, dtau, (jout, javg) = calls[1]
    assert ns == 2
    conv = lambda d: {k: _t(v) for k, v in d.items()}  # noqa: E731
    tout, tavg = acoustic_loop(conv(pp), conv(R), conv(ac), ns, dtau, tg, tc, THalo())
    for k in jout:
        assert _rel(jout[k], tout[k]) <= 1e-5, k
    for k in javg:
        assert _rel(javg[k], tavg[k]) <= 1e-5, k


def test_diffusion_tendencies(case):
    jc, tc, jg, js, tg, ts = case
    names = jc.moist_species()
    ref = jdiff.diffusion_tendencies(js, jg, jc, JHalo(), jc.time_control.dt, names)
    out = tdiff.diffusion_tendencies(ts, tg, tc, THalo(), tc.time_control.dt, names)
    assert set(ref) == set(out)
    for k in ref:
        assert _rel(ref[k], out[k]) <= 1e-5, k


def test_kessler_all_processes(case):
    """Kessler on a supersaturated, cloudy, rainy state, so that
    sedimentation, autoconversion, accretion, evaporation and saturation
    adjustment all act: <= 1e-5 of each field's magnitude."""
    jc, tc, jg, js, tg, ts = case
    rng = np.random.default_rng(11)
    shape = js["qv"].shape
    moist = {
        "qv": np.asarray(js["qv"]) * rng.uniform(0.7, 1.3, shape),
        "qc": rng.uniform(0.0, 3e-3, shape),
        "qr": rng.uniform(0.0, 2e-3, shape),
    }
    js2 = dict(js, **{k: jnp.asarray(v.astype(np.float32)) for k, v in moist.items()})
    ts2 = dict(ts, **{k: _t(v.astype(np.float32)) for k, v in moist.items()})
    jd = jdiag.diagnose(js2, jg, jc.moist_species())
    td = tdiag.diagnose(ts2, tg, tc.moist_species())
    ref = jkessler.kessler(js2, jd, jg, 6.0)
    out = tkessler.kessler(ts2, td, tg, 6.0)
    assert float(np.asarray(ref["rainnc"]).max()) > 0.0
    for k in ("t", "qv", "qc", "qr", "rainnc"):
        assert _rel(ref[k], out[k]) <= 1e-5, k
