"""The port's terrain and map-factor dycore against the JAX package, on a
real-data grid (terrain and a Lambert projection) with seeded inputs: the
large-step terms (`pgf_uv` over terrain, Coriolis with the conformal
curvature, `omega_diagnosis` and `buoyancy_w` with m, `rphi_tendency`
with the base slope and m^2), the acoustic loop on inputs recorded from a
step, one `solve.step`, and the plain versions of the two dycore kernels
with the map factor (``m2``) against the reference's plain operators.
Then the reference's own properties on the port: a resting atmosphere over
a hill stays at rest, and dry mass on a periodic Lambert grid is
conserved.  Mirrors the reference's tests/test_terrain.py and
test_map_factors.py.

Tolerance: float64 on both sides, 1e-10 of each field's magnitude (the
precedent of test_torch_dyn_options.py: in float32 the limiters' branches
flip on rounding noise, and the step amplifies rounding).  The step runs
the kernels' plain versions (the wrappers take float32 only; on the CPU
they run the plain versions anyway).
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

from wrfchem_arc_interactions_tpu.dycore import advection as jadv  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import big_step as jbs  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import small_step as jss  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import solve as jsolve  # noqa: E402
from wrfchem_arc_interactions_tpu.grid import projection as jproj  # noqa: E402
from wrfchem_arc_interactions_tpu.models import real as jreal  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind as TBC  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import big_step as tbs  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import projection as tproj  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, tracers_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_real import real_cfgs  # noqa: E402
from test_torch_slice import _jgrid_numpy  # noqa: E402

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.fixture(scope="module")
def case64():
    """(jax cfg, port cfg, jax grid, port grid, jax state, port state) of a
    real case over 1,000 m terrain on a Lambert grid, in float64 on both
    sides (the JAX package's float32 grid and state cast, then carried
    over field by field)."""
    jc, tc = real_cfgs(nx=14, ny=10, nz=8)
    snaps = jreal.synthetic_analysis(jc, [0.0], terrain_amp=1000.0)
    jg, js, _ = jreal.real_init(jc, snaps, projection=jproj.Projection(kind="lambert",
                                                                        ref_lat=40.0))
    assert jg.has_terrain and jg.curvature
    with jax.enable_x64(True):
        jg = jax.tree.map(lambda a: a.astype(jnp.float64) if isinstance(a, jax.Array) else a,
                          jg)
        js = {k: np.asarray(v, np.float64) for k, v in js.items()}
    tg = grid_from_numpy(_jgrid_numpy(jg), "cpu")
    ts = state_from_numpy(js, "cpu")
    return jc, tc, jg, tg, js, ts


def _fields(ny, nx, nz, seed, names):
    """Seeded PAD-padded (or interior) float64 fields by name and shape."""
    rng = np.random.default_rng(seed)
    shapes = {"p": (nz, ny + 6, nx + 6), "ph": (nz + 1, ny + 6, nx + 6),
              "al": (nz, ny + 6, nx + 6), "eps": (nz, ny + 6, nx + 6),
              "mu": (ny + 6, nx + 6), "u": (nz, ny + 6, nx + 6), "v": (nz, ny + 6, nx + 6),
              "w": (nz + 1, ny, nx), "ww": (nz + 1, ny, nx), "mu_i": (ny, nx)}
    scale = {"p": (0.0, 200.0), "ph": (0.0, 50.0), "al": (0.9, 0.02), "eps": (0.99, 0.005),
             "mu": (9e4, 300.0), "u": (0.0, 1e6), "v": (0.0, 1e6), "w": (0.0, 1e4),
             "ww": (0.0, 50.0), "mu_i": (9e4, 300.0)}
    return {n: rng.normal(*scale[n], shapes[n]) for n in names}


def _j(a):
    return jnp.asarray(a, jnp.float64)


def _tt(a):
    return torch.from_numpy(np.array(a, np.float64))


def _base_pads(g, hx, to):
    return {k: to(np.asarray(hx.pad(jnp.asarray(getattr(g, k)), 3)))
            for k in ("phb", "mub", "alb")}


def test_pgf_and_coriolis_match_jax(case64):
    """pgf_uv over terrain (the base-state slope terms from the padded
    phb/mub/alb) and Coriolis with f_eff = f + u dm/dy on the Lambert grid."""
    _, _, jg, tg, _, _ = case64
    f = _fields(tg.ny, tg.nx, tg.nz, 1, ("p", "ph", "al", "eps", "mu", "u", "v"))
    hx = JHalo()
    with jax.enable_x64(True):
        jp, jc = jax.jit(lambda p, ph, al, eps, mu, u, v, bp: (
            jbs.pgf_uv(p, ph, al, eps, mu, jg, base_pads=bp),
            jbs.coriolis_uv(u, v, mu, jg)))(
                *(_j(f[k]) for k in ("p", "ph", "al", "eps", "mu", "u", "v")),
                _base_pads(jg, hx, _j))
        jp, jc = [np.asarray(a) for a in jp], [np.asarray(a) for a in jc]
    tp = tbs.pgf_uv(*(_tt(f[k]) for k in ("p", "ph", "al", "eps", "mu")), tg,
                    base_pads=_base_pads(jg, hx, _tt))
    tc = tbs.coriolis_uv(_tt(f["u"]), _tt(f["v"]), _tt(f["mu"]), tg)
    flat = tbs.pgf_uv(*(_tt(f[k]) for k in ("p", "ph", "al", "eps", "mu")), tg)
    assert _rel(tp[0], flat[0]) > 1e-3           # the terrain terms count
    for a, b in zip(jp + jc, list(tp) + list(tc)):
        assert b.dtype == torch.float64 and _rel(a, b) <= TOL


def test_omega_buoyancy_rphi_match_jax(case64):
    """omega_diagnosis and buoyancy_w with the map factor, and rphi_tendency
    with the base geopotential's slope and m^2."""
    _, _, jg, tg, _, _ = case64
    f = _fields(tg.ny, tg.nx, tg.nz, 2, ("u", "v", "ph", "w", "ww", "mu_i", "p", "eps"))
    hx = JHalo()
    phb_pad = np.asarray(hx.pad(jnp.asarray(np.asarray(jg.phb)), 3))
    eps_i = f["eps"][:, 3:-3, 3:-3]
    p_i = f["p"][:, 3:-3, 3:-3]
    mu_p = f["mu_i"] - 9e4
    with jax.enable_x64(True):
        jo, jb, jr = jax.jit(lambda u, v, ph, w, ww, mu, p, eps, mup, phb: (
            jbs.omega_diagnosis(u, v, jg, hx), jbs.buoyancy_w(p, eps, mup, jg),
            jbs.rphi_tendency(u, v, ph, w, ww, mu, jg, phb_pad=phb)))(
                *(_j(f[k]) for k in ("u", "v", "ph", "w", "ww", "mu_i")), _j(p_i), _j(eps_i),
                _j(mu_p), _j(phb_pad))
        jout = [np.asarray(a) for a in (*jo, jb, jr)]
    to = tbs.omega_diagnosis(_tt(f["u"]), _tt(f["v"]), tg)
    tb = tbs.buoyancy_w(_tt(p_i), _tt(eps_i), _tt(mu_p), tg)
    tr = tbs.rphi_tendency(_tt(f["u"]), _tt(f["v"]), _tt(f["ph"]), _tt(f["w"]), _tt(f["ww"]),
                           _tt(f["mu_i"]), tg, phb_pad=_tt(phb_pad))
    for a, b in zip(jout, (*to, tb, tr)):
        assert _rel(a, b) <= TOL


def test_kernels_plain_versions_with_map_factor_match_jax(case64):
    """The scalar kernel's plain version with m2 = msft^2 against the
    reference's advect_scalar on the projected grid, and the multi-tracer
    kernel's, with and without the limiter, against the reference's
    stacked update (fluxes, pd_limit, flux_div with m_h = m2, tendency,
    clip), on a specified boundary's halos."""
    _, _, jg, tg, _, _ = case64
    rng = np.random.default_rng(4)
    nz, ny, nx = tg.nz, tg.ny, tg.nx
    jhx, thx = JHalo(bc_x="specified", bc_y="specified"), THalo(TBC.SPECIFIED, TBC.SPECIFIED)
    q = rng.uniform(0.0, 2.0, (3, nz, ny, nx)) * (rng.uniform(size=(3, nz, ny, nx)) > 0.5)
    mub = np.asarray(jg.mub)
    mu0, mu_f, mu_n = (mub * rng.uniform(0.995, 1.005, mub.shape) for _ in range(3))
    ru, rv = (mu_f * rng.normal(0.0, 20.0, (nz, ny, nx)) for _ in range(2))
    ww = rng.normal(0.0, 100.0, (nz + 1, ny, nx))
    ww[0] = ww[-1] = 0.0
    pt = rng.normal(0.0, 1e-3, q.shape)
    m2 = tracers_kernel.map_factor_sq(tg)
    def reference(q, ru, rv, ww, phi, mu_f, mu_n, pt):
        """The reference's scalar tendency and its stacked update."""
        qp, rup, rvp = (jhx.pad(a, 3) for a in (q, ru, rv))
        out = [jadv.advect_scalar(qp[0], rup, rvp, ww, jg, 5, 3)]
        for pd in (False, True):
            fx, fy, fz = jadv.scalar_fluxes(qp, rup, rvp, ww, 5, 3)
            if pd:
                fx, fy, fz = jadv.pd_limit(qp, phi, fx, fy, fz, rup, rvp, ww, 6.0, jg, jhx)
            tend = jadv.flux_div(fx, fy, fz, jg, m_h=jg.msft * jg.msft) + mu_f * pt
            qn = (phi + 6.0 * tend) / mu_n
            out.append(jnp.maximum(qn, 0.0) if pd else qn)
        return out

    with jax.enable_x64(True):
        j1, *jst = (np.asarray(a) for a in jax.jit(reference)(
            *(_j(a) for a in (q, ru, rv, ww, mu0 * q, mu_f, mu_n, pt))))
    tqp, trup, trvp = (thx.pad(_tt(a), 3) for a in (q, ru, rv))
    t1 = adv_kernel.advect_scalar_5_3_reference(tqp[0], trup, trvp, _tt(ww), tg.rdnw, tg.rdx,
                                                tg.rdy, m2)
    assert _rel(j1, t1) <= TOL
    flat = adv_kernel.advect_scalar_5_3_reference(tqp[0], trup, trvp, _tt(ww), tg.rdnw,
                                                  tg.rdx, tg.rdy)
    assert _rel(t1, flat) > 1e-3
    for pd in (False, True):
        out = tracers_kernel.advect_tracers_reference(
            tqp, _tt(mu0 * q), trup, trvp, _tt(ww), _tt(mu_f), _tt(mu_n), tg, thx, 6.0,
            pt=_tt(pt), pd=pd, clip=pd)
        assert _rel(jst[int(pd)], out) <= TOL, pd


@pytest.fixture
def plain_kernels(monkeypatch):
    """solve.step with the kernels' plain versions (float64 on the CPU)."""
    monkeypatch.setattr(tsolve, "advect_scalar_5_3", adv_kernel.advect_scalar_5_3_reference)
    monkeypatch.setattr(tsolve, "advect_tracers", tracers_kernel.advect_tracers_reference)


def test_acoustic_loop_and_step_match_jax(case64, plain_kernels, monkeypatch):
    """One solve.step on the terrain + Lambert grid (specified halos) in
    both packages; and the acoustic loop of its last stage, run by the
    reference on the inputs the port recorded (the terrain's sloped
    coordinate and kinematic surface w, the map factors in the divergence,
    buoyancy and phi coupling)."""
    jc, tc, jg, tg, js, ts = case64
    calls = []
    inner = tsolve.acoustic_loop

    def recording(*args):
        out = inner(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(tsolve, "acoustic_loop", recording)
    t_hx = THalo(TBC.SPECIFIED, TBC.SPECIFIED)
    j_hx = JHalo(bc_x="specified", bc_y="specified")
    t_new = tsolve.step(ts, tg, tc, t_hx, 60.0)
    with jax.enable_x64(True):
        j_new = jax.jit(lambda s: jsolve.step(s, jg, jc, j_hx, 60.0))(
            {k: _j(v) for k, v in js.items()})
        j_new = {k: np.asarray(v) for k, v in j_new.items()}
        (pp, R, ac, ns, dtau, _, _, _), (t_out, t_avg) = calls[-1]
        conv = [{k: _j(v.numpy()) for k, v in d.items()} for d in (pp, R, ac)]
        j_out, j_avg = jss.acoustic_loop(*conv, ns, dtau, jg, jc, j_hx)
    assert len(calls) == 3 and {"c_ux4", "wsfc_const", "msft"} <= set(ac)
    for k in t_out:
        assert _rel(j_out[k], t_out[k]) <= TOL, k
    for k in t_avg:
        assert _rel(j_avg[k], t_avg[k]) <= TOL, k
    for k in ("u", "v", "w", "t", "mu", "ph", "qv"):
        assert _rel(j_new[k], t_new[k]) <= TOL, k
    assert float((t_new["w"]).abs().max()) > 1e-3


def test_rest_over_hill_stays_at_rest():
    """A quiescent atmosphere over a 300 m hill (hill2d_x with u0 = 0): the
    terrain pressure-gradient terms cancel discretely, spurious winds stay
    at the float32 noise floor (the reference's test, on the port)."""
    _, tc = real_cfgs(nx=32, ny=4, nz=12, specified=False)
    tc = tc.replace(domain=dataclasses.replace(tc.domain, dx=2000.0, dy=2000.0),
                    time_control=dataclasses.replace(tc.time_control, dt=6.0))
    grid, state = tideal.make_case(tc, "hill2d_x", device="cpu", hm=300.0, a_half=8000.0,
                                   u0=0.0)
    assert grid.has_terrain and float(grid.ht.max()) > 250.0
    hx = THalo(tc.dynamics.bc_x, tc.dynamics.bc_y)
    for _ in range(10):
        state = tsolve.step(state, grid, tc, hx, 6.0)
    assert float(state["u"].abs().max()) < 0.05
    assert float(state["w"].abs().max()) < 0.05


def test_lambert_dry_mass_is_conserved(plain_kernels):
    """Total dry mass sum((mub + mu) / m^2) on a periodic Lambert grid is
    conserved to float64 rounding by the m^2-scaled flux form (the
    reference's property, on the port): a warm bubble, 5 steps."""
    _, tc = real_cfgs(nx=16, ny=12, nz=8, specified=False)
    grid = tideal.make_grid(tc, tideal.soundings.constant_n2_theta(), "cpu",
                            projection=tproj.Projection(kind="lambert", ref_lat=30.0),
                            dtype=torch.float64)
    state = tideal.warm_bubble(tc, grid, amplitude=2.0, zc=1500.0, xr=40e3, zr=1200.0,
                               three_d=True)
    state = {k: v.double() for k, v in state.items()}
    assert float(grid.msft.max() - grid.msft.min()) > 1e-3
    inv_m2 = 1.0 / grid.msft ** 2

    def total(s):
        return float(((grid.mub + s["mu"]) * inv_m2).sum())

    m0 = total(state)
    hx = THalo()
    for _ in range(5):
        state = tsolve.step(state, grid, tc, hx, 60.0)
    assert abs(total(state) - m0) / m0 < 1e-12
    assert float(state["w"].abs().max()) > 1e-3
