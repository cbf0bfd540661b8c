"""The port's specified lateral boundaries (`models/lateral_bc.py`),
analysis nudging (`models/fdda.py`), polar filter (`dycore/polar_filter.py`)
and the hill2d_x case against the JAX package, then the reference's own
properties of each on the port.  Mirrors the reference's
tests/test_lateral_bc.py, test_fdda.py, test_polar_filter.py and the
hill2d_x part of test_terrain.py.

Tolerances: the zone masks are numpy in both packages and equal bit for
bit; the Davies operator and the nudging are elementwise and are held in
float64 to 1e-14 and in float32 to 1e-6 of the field's magnitude; the
polar filter runs its FFTs in float32 in both packages (two FFT libraries:
1e-6 of the field's magnitude); a step of hill2d_x in float64 to 1e-10.
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
from wrfchem_arc_interactions_tpu.dycore import polar_filter as jpf  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import solve as jsolve  # noqa: E402
from wrfchem_arc_interactions_tpu.models import fdda as jfdda  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models import lateral_bc as jlbc  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind as TBC  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import polar_filter as tpf  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import fdda as tfdda  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import lateral_bc as tlbc  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, tracers_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_slice import _jgrid_numpy  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _cfgs(nx=24, ny=8, nz=12, dx=2000.0, dt=10.0, **groups):
    """A small ideal configuration in both packages; `groups` gives
    {group: {field: value}} with enum values by name."""
    out = []
    for m in (jcfg, tcfg):
        cfg = m.Config(domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, ztop=12000.0,
                                             p_top=20000.0),
                       time_control=m.TimeControl(dt=dt),
                       dynamics=m.DynamicsConfig(kvdif=10.0))
        for group, fields in groups.items():
            sub = getattr(cfg, group)
            sub = dataclasses.replace(sub, **{k: type(getattr(sub, k))(v)
                                              for k, v in fields.items()})
            cfg = cfg.replace(**{group: sub})
        out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# Davies zones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zones,sides", [((1, 4), (True, True)), ((2, 3), (True, False)),
                                         ((1, 4), (False, True))])
def test_zone_masks_match_jax(zones, sides):
    x_on, y_on = sides
    a = jlbc.zone_masks(12, 20, *zones, x_sides=(x_on, x_on), y_sides=(y_on, y_on))
    b = tlbc.zone_masks(12, 20, *zones, x_sides=(x_on, x_on), y_sides=(y_on, y_on))
    for u, v in zip(a, b):
        assert v.dtype == np.float32 and np.array_equal(u, v)
    spec, w = b
    if x_on and y_on and zones == (1, 4):
        assert spec[0].all() and spec[:, -1].all() and spec[2:-2, 2:-2].sum() == 0
        assert w[1, 10] > w[2, 10] > w[3, 10] > w[4, 10] > 0 and w[5:-5, 5:-5].sum() == 0


def _boundary_pair(rng, dtype):
    shapes = {"t": (6, 12, 20), "u": (6, 12, 20), "mu": (12, 20), "ph": (7, 12, 20)}
    lo = {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}
    hi = {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}
    q = {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}
    return lo, hi, q


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_specified_bc_apply_matches_jax(dtype):
    """at_time (inside, and held at both ends) and the Davies operator:
    spec zone set, relax zone nudged with the deviation and its Laplacian,
    ph set only."""
    lo, hi, q = _boundary_pair(np.random.default_rng(5), dtype)
    spec, w = tlbc.zone_masks(12, 20)
    names = ("t", "u", "mu", "ph")
    tol = 1e-14 if dtype == np.float64 else 1e-6
    with jax.enable_x64(dtype == np.float64):
        jd = jnp.float64 if dtype == np.float64 else jnp.float32
        jb = jlbc.LateralBoundary(lo={k: jnp.asarray(v) for k, v in lo.items()},
                                  hi={k: jnp.asarray(v) for k, v in hi.items()},
                                  t_lo=jnp.asarray(600.0, jd), t_hi=jnp.asarray(4200.0, jd))
        jbc = jlbc.SpecifiedBC(jnp.asarray(spec), jnp.asarray(w), names, names[:-1])
        j_at = [jb.at_time(jnp.float32(t)) for t in (0.0, 1234.0, 9000.0)]
        j_out = jbc.apply({k: jnp.asarray(v) for k, v in q.items()}, jb, jnp.float32(1234.0),
                          60.0)
        j_at = [{k: np.asarray(v) for k, v in d.items()} for d in j_at]
        j_out = {k: np.asarray(v) for k, v in j_out.items()}
    tb = tlbc.LateralBoundary(lo={k: torch.from_numpy(v) for k, v in lo.items()},
                              hi={k: torch.from_numpy(v) for k, v in hi.items()},
                              t_lo=600.0, t_hi=4200.0)
    tbc = tlbc.SpecifiedBC(torch.from_numpy(spec), torch.from_numpy(w), names, names[:-1])
    for t, ja in zip((0.0, 1234.0, 9000.0), j_at):
        ta = tb.at_time(np.float32(t))
        for k in ja:
            assert _rel(ja[k], ta[k]) <= tol, (t, k)
    t_out = tbc.apply({k: torch.from_numpy(v) for k, v in q.items()}, tb, np.float32(1234.0),
                      60.0)
    for k in j_out:
        assert t_out[k].dtype == torch.from_numpy(q[k]).dtype and _rel(j_out[k], t_out[k]) <= tol
    # the spec ring is the target exactly
    tgt = tb.at_time(np.float32(1234.0))
    assert torch.equal(t_out["t"][:, 0], tgt["t"][:, 0])
    assert torch.equal(t_out["mu"][:, -1], tgt["mu"][:, -1])


def test_specified_bc_null_balance():
    """A quiescent domain forced with its own state as boundary data stays
    at rest (the reference's consistency test, on the port)."""
    _, tc = _cfgs(nx=32, ny=12, nz=12, dynamics={"bc_x": "specified", "bc_y": "specified"})
    grid, state = tideal.make_case(tc, "quiescent", device="cpu")
    bdy = tlbc.constant_boundary({k: state[k] for k in ("u", "v", "w", "t", "mu", "ph")})
    sim = TSim(tc, grid, state, boundary=bdy, device="cpu")
    sim.advance(10)
    assert float(sim.state["u"].abs().max()) < 1e-2
    assert float(sim.state["w"].abs().max()) < 1e-2


def test_specified_inflow_spins_up_interior():
    """A resting domain forced with a steady inflow of 5 m/s accelerates
    inward from its western boundary (the reference's test, on the port)."""
    _, tc = _cfgs(nx=48, ny=4, nz=16, dx=1000.0, dt=5.0, dynamics={"bc_x": "specified"})
    grid, state = tideal.make_case(tc, "quiescent", device="cpu")
    tgt = {k: state[k] for k in ("u", "v", "w", "t", "mu", "ph")}
    tgt["u"] = torch.full_like(state["u"], 5.0)
    sim = TSim(tc, grid, state, boundary=tlbc.constant_boundary(tgt), device="cpu")
    sim.advance(20)
    u = sim.state["u"]
    assert torch.isfinite(u).all() and torch.equal(u[:, :, 0], tgt["u"][:, :, 0])
    assert float(u[:, :, 5].mean()) > 1.0 and float(u.min()) > -1.0


# ---------------------------------------------------------------------------
# analysis nudging
# ---------------------------------------------------------------------------

def _window(mod, state, u_target, t_hi, to):
    lo = {k: to(state[k]) for k in ("u", "v", "t", "qv") if k in state}
    hi = dict(lo)
    hi["u"] = lo["u"] * 0.0 + u_target
    if mod is jlbc:
        # the times in the fields' type, as the reference's real_init makes them
        dt = np.asarray(state["u"]).dtype
        return jlbc.LateralBoundary(lo=lo, hi=hi, t_lo=jnp.asarray(0.0, dt),
                                    t_hi=jnp.asarray(t_hi, dt))
    return tlbc.LateralBoundary(lo=lo, hi=hi, t_lo=0.0, t_hi=t_hi)


@pytest.mark.parametrize("k_start", [0, 3])
def test_nudging_tendencies_match_jax(k_start):
    """grid_nudge_tendencies and apply_nudging (added to a held tendency and
    alone) in float64, with and without the k_start mask."""
    fd = {"grid_fdda": True, "guv": 2e-3, "gt": 1e-3, "gq": 2e-4, "k_start": k_start}
    jc, tc = _cfgs(fdda=fd)
    rng = np.random.default_rng(6)
    state = {k: rng.normal(size=(12, 8, 24)) for k in ("u", "v", "t", "qv")}
    held = {"th": rng.normal(size=(12, 8, 24))}
    with jax.enable_x64(True):
        jb = _window(jlbc, state, 6.0, 1800.0, jnp.asarray)
        jt = jfdda.apply_nudging({k: jnp.asarray(v) for k, v in held.items()},
                                 {k: jnp.asarray(v) for k, v in state.items()}, jb,
                                 jnp.float32(600.0), jc)
        jt = {k: np.asarray(v) for k, v in jt.items()}
    tb = _window(tlbc, state, 6.0, 1800.0, torch.from_numpy)
    tt = tfdda.apply_nudging({k: torch.from_numpy(v) for k, v in held.items()},
                             {k: torch.from_numpy(v) for k, v in state.items()}, tb,
                             np.float32(600.0), tc)
    assert set(jt) == set(tt) == {"u", "v", "th", "qv"}
    for k in jt:
        assert _rel(jt[k], tt[k]) <= 1e-14, k
    if k_start:
        assert float(tt["u"][:k_start].abs().max()) == 0.0


def test_grid_nudging_tracks_analysis_and_off_is_inert():
    """Nudging toward u = 6 m/s (the full target from the start, guv =
    2e-3/s) moves the quiescent wind to 6 (1 - exp(-0.6)) ~ 2.7 m/s in
    300 s; with grid_fdda off the same target changes nothing, bit for
    bit."""
    fd = {"grid_fdda": True, "guv": 2e-3, "gt": 2e-3, "gq": 2e-4}
    _, tc = _cfgs(fdda=fd)
    grid, state = tideal.make_case(tc, "quiescent", device="cpu")
    sim = TSim(tc, grid, state, fdda=_window(tlbc, state, 6.0, 1.0, lambda a: a),
               device="cpu")
    sim.advance(30)
    u = float(sim.state["u"].mean())
    assert 2.0 < u < 3.5 and float(sim.state["w"].abs().max()) < 2.0
    off = tc.replace(fdda=dataclasses.replace(tc.fdda, grid_fdda=False))
    a = TSim(off, grid, state, fdda=_window(tlbc, state, 6.0, 1.0, lambda a: a),
             device="cpu")
    b = TSim(off, grid, state, device="cpu")
    a.advance(3)
    b.advance(3)
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)


# ---------------------------------------------------------------------------
# polar filter
# ---------------------------------------------------------------------------

def test_polar_filter_matches_jax():
    """The masks (sharp and tapered) equal the reference's; the filtered
    fields of PolarFilter.momentum and .scalar agree to 1e-6 of the field's
    magnitude (float32 FFTs of two libraries)."""
    nx, ny, nz = 32, 9, 4
    lat_rows = np.linspace(0.0, 88.0, ny).astype(np.float32)
    for taper in (False, True):
        a = np.asarray(jpf.filter_mask(jnp.asarray(lat_rows), nx, 45.0, taper=taper))
        b = tpf.filter_mask(torch.from_numpy(lat_rows), nx, 45.0, taper=taper).numpy()
        assert np.array_equal(a, b), taper
    jc, _ = _cfgs(nx=nx, ny=ny, nz=nz)
    jg, js = jideal.make_case(jc, "warm_bubble", amplitude=2.0)
    jg = dataclasses.replace(jg, xlat=jnp.broadcast_to(jnp.asarray(lat_rows)[:, None],
                                                       (ny, nx)))
    tg = grid_from_numpy(_jgrid_numpy(jg), "cpu")
    rng = np.random.default_rng(9)
    fields = {k: np.asarray(v) + rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
              for k, v in js.items() if k in ("u", "v", "w", "t", "ph", "mu")}
    q = np.abs(rng.normal(0.0, 1e-3, (nz, ny, nx))).astype(np.float32)
    jfilt = jpf.PolarFilter(jg, 45.0, nx)
    tfilt = tpf.PolarFilter(tg, 45.0, nx)
    jm = jfilt.momentum({k: jnp.asarray(v) for k, v in fields.items()})
    tm = tfilt.momentum({k: torch.from_numpy(v) for k, v in fields.items()})
    for k in fields:
        assert _rel(np.asarray(jm[k]), tm[k]) <= 1e-6, k
    assert _rel(np.asarray(jfilt.scalar(jnp.asarray(q))),
                tfilt.scalar(torch.from_numpy(q))) <= 1e-6


def test_solve_step_with_polar_filter():
    """2 steps with fft_filter_lat = 45 on rows reaching 88N: finite, the
    poleward rows of theta carry nothing above their k_max, and an
    equatorward row keeps its spectrum (the reference's test, on the
    port)."""
    _, tc = _cfgs(nx=32, ny=16, nz=12, dx=1000.0, dt=6.0,
                  dynamics={"fft_filter_lat": 45.0})
    grid, state = tideal.make_case(tc, "warm_bubble", device="cpu", amplitude=2.0)
    lat_rows = torch.linspace(0.0, 88.0, 16)
    grid = dataclasses.replace(grid, xlat=lat_rows[:, None].expand(16, 32).contiguous())
    gen = torch.Generator().manual_seed(0)
    state["t"] = state["t"] + 0.1 * torch.randn(state["t"].shape, generator=gen)
    sim = TSim(tc, grid, state, check_nans=True, device="cpu")
    sim.advance(2)
    spec = np.abs(np.fft.rfft(sim.state["t"].numpy(), axis=-1)).max(axis=0)
    k = np.arange(spec.shape[1])
    for j, lat in enumerate(lat_rows.numpy()):
        if lat > 45.0:
            k_max = 16 * np.cos(np.deg2rad(lat)) / np.cos(np.deg2rad(45.0))
            assert spec[j, k > k_max + 0.5].max() < 1e-3, (j, lat)
    assert spec[0, k > 12].max() > 1e-3


# ---------------------------------------------------------------------------
# hill2d_x
# ---------------------------------------------------------------------------

def test_hill2d_x_matches_jax(monkeypatch):
    """The case's grid bit for bit and its state to float32 rounding; then
    one dycore step from the reference's state in float64 on both sides
    (open x boundaries), to 1e-10."""
    monkeypatch.setattr(tsolve, "advect_scalar_5_3", adv_kernel.advect_scalar_5_3_reference)
    monkeypatch.setattr(tsolve, "advect_tracers", tracers_kernel.advect_tracers_reference)
    jc, tc = _cfgs(nx=32, ny=4, nz=12, dx=2000.0, dt=6.0, dynamics={"bc_x": "open"})
    jg, js = jideal.make_case(jc, "hill2d_x", hm=300.0, a_half=8000.0, u0=8.0)
    tg, ts = tideal.make_case(tc, "hill2d_x", device="cpu", hm=300.0, a_half=8000.0, u0=8.0)
    assert tg.has_terrain and not tg.curvature
    for k, v in _jgrid_numpy(jg).items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, getattr(tg, k).numpy()), k
    for k in js:
        assert _rel(np.asarray(js[k]), ts[k]) <= 1e-6, k
    with jax.enable_x64(True):
        jg64 = jax.tree.map(lambda a: a.astype(jnp.float64) if isinstance(a, jax.Array) else a,
                            jg)
        js64 = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in js.items()}
        jhx = JHalo(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y)
        jn = jax.jit(lambda s: jsolve.step(s, jg64, jc, jhx, 6.0))(js64)
        jn = {k: np.asarray(v) for k, v in jn.items()}
    tg64 = grid_from_numpy(_jgrid_numpy(jg64), "cpu")
    tn = tsolve.step(state_from_numpy({k: np.asarray(v) for k, v in js64.items()}, "cpu"),
                     tg64, tc, THalo(TBC.OPEN, TBC.PERIODIC), 6.0)
    for k in ("u", "v", "w", "t", "mu", "ph"):
        assert _rel(jn[k], tn[k]) <= 1e-10, k
