"""The port's real-data path against the JAX package: map projections
(`grid/projection.py`), `make_grid` over terrain and a projection, the
real.exe analog (`models/real.py`: `real_init`, `boundary_stream`) and the
WPS intermediate files (`io/wps_intermediate.py`).

All of it is host-side numpy in both packages, so each piece is held bit
for bit: the projection fields, the float32 grid, the initial state and
the boundary segments; the files written by either package are
byte-identical, and each package reads the other's.  Mirrors the
reference's tests/test_projection.py, test_real_init.py and
test_wps_intermediate.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.config.namelist import BCKind as JBC  # noqa: E402
from wrfchem_arc_interactions_tpu.grid import grid as jgrid  # noqa: E402
from wrfchem_arc_interactions_tpu.grid import projection as jproj  # noqa: E402
from wrfchem_arc_interactions_tpu.io import wps_intermediate as jwps  # noqa: E402
from wrfchem_arc_interactions_tpu.models import real as jreal  # noqa: E402
from wrfchem_arc_interactions_tpu.models import soundings as jsnd  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind as TBC  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid as tgrid  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import projection as tproj  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import wps_intermediate as twps  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import real as treal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import soundings as tsnd  # noqa: E402

KINDS = ("lambert", "mercator", "polar", "lat-lon", "cartesian")


def real_cfgs(nx=16, ny=12, nz=10, specified=True, **dyn):
    """The slice's real-data domain (dx 12 km, dt 60 s, ztop 16 km, p_top
    100 hPa, kvdif 0, 6 acoustic substeps with epssm 0.3, specified
    boundaries) in both packages, cut to a small grid."""
    out = []
    for m, bc in ((jcfg, JBC), (tcfg, TBC)):
        b = {"bc_x": bc.SPECIFIED, "bc_y": bc.SPECIFIED} if specified else {}
        out.append(m.Config(
            domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=12e3, dy=12e3, ztop=16000.0,
                                  p_top=10000.0),
            time_control=m.TimeControl(dt=60.0),
            dynamics=m.DynamicsConfig(kvdif=0.0, time_step_sound=6, epssm=0.3, **b, **dyn)))
    return out


def grids_equal(jg, tg):
    """Every field and static entry of the two packages' grids, bit for bit."""
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, (bool, float)):
            assert a == b, f.name
        else:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), f.name


@pytest.mark.parametrize("kind", KINDS)
def test_projection_fields_match_jax(kind):
    """Every field of every projection kind, bit for bit (the port's module
    is a copy of the reference's numpy)."""
    for tl1, tl2, ref_lat in ((30.0, 60.0, 45.0), (45.0, 45.0, 40.0)):
        pj = jproj.Projection(kind=kind, ref_lat=ref_lat, truelat1=tl1, truelat2=tl2,
                              ref_lon=-100.0)
        pt = tproj.Projection(kind=kind, ref_lat=ref_lat, truelat1=tl1, truelat2=tl2,
                              ref_lon=-100.0)
        a = jproj.projection_fields(pj, 41, 7, 25e3, 25e3)
        b = tproj.projection_fields(pt, 41, 7, 25e3, 25e3)
        assert set(a) == set(b)
        for k in a:
            assert b[k].dtype == np.float32 and np.array_equal(a[k], b[k]), (kind, k)


def test_map_factors_unity_at_true_latitudes():
    """Conformal projections have m = 1 at their true latitudes (the
    reference's own property, on the port)."""
    for kind, tl in (("mercator", 20.0), ("polar", 70.0), ("lambert", 45.0)):
        proj = tproj.Projection(kind=kind, ref_lat=tl, truelat1=tl, truelat2=tl)
        pf = tproj.projection_fields(proj, 81, 5, 50e3, 50e3)
        assert abs(pf["msft"][40, 0] - 1.0) < 5e-3, kind
        assert abs(pf["xlat"][40, 0] - tl) < 0.3, kind


@pytest.mark.parametrize("terrain,kind", [(False, "lambert"), (True, "cartesian"),
                                          (True, "lambert"), (True, "lat-lon")])
def test_make_grid_matches_jax(terrain, kind):
    """make_grid over a Gaussian ridge and a projection: the float32 grid,
    has_terrain and curvature, bit for bit."""
    jc, tc = real_cfgs(nx=14, ny=10, nz=8)
    x = np.arange(14)
    ht = np.broadcast_to(800.0 * np.exp(-((x - 7.0) / 3.0) ** 2), (10, 14)) if terrain else None
    jg = jgrid.make_grid(jc, jsnd.weisman_klemp_theta(), terrain=ht,
                         projection=jproj.Projection(kind=kind, ref_lat=40.0))
    tg = tgrid.make_grid(tc, tsnd.weisman_klemp_theta(), "cpu", terrain=ht,
                         projection=tproj.Projection(kind=kind, ref_lat=40.0))
    assert tg.has_terrain == terrain and tg.curvature == (kind != "cartesian")
    grids_equal(jg, tg)


def test_interp_ln_p_equals_numpy_interp():
    """The vectorised column interpolation against numpy's np.interp column
    by column, bit for bit: targets below, above, between and on the
    analysis levels."""
    rng = np.random.default_rng(3)
    p_levels = np.linspace(1000e2, 150e2, 20)
    field = rng.normal(280.0, 20.0, (20, 5, 6))
    p_t = rng.uniform(50e2, 1100e2, (30, 5, 6))
    p_t[:4] = p_levels[[0, 5, 13, 19]][:, None, None]       # exactly on levels
    p_t[4] = 1.0                                            # at the clamp
    out = treal._interp_ln_p(p_t, p_levels, field)
    ln_src, f_src = np.log(p_levels)[::-1], field[::-1]
    ln_t = np.log(np.maximum(p_t, 1.0))
    for j in range(5):
        for i in range(6):
            np.testing.assert_array_equal(out[:, j, i],
                                          np.interp(ln_t[:, j, i], ln_src, f_src[:, j, i]))


@pytest.mark.parametrize("terrain_amp,kind", [(0.0, None), (1000.0, "lambert")])
def test_real_init_matches_jax(terrain_amp, kind):
    """real_init on the synthetic analysis (three snapshots): the grid, the
    initial state and both boundary segments, bit for bit; the segments'
    targets differ in time (the analysis evolves)."""
    jc, tc = real_cfgs()
    times = [0.0, 1800.0, 3600.0]
    js = jreal.synthetic_analysis(jc, times, terrain_amp=terrain_amp, advect_speed=40.0)
    ts = treal.synthetic_analysis(tc, times, terrain_amp=terrain_amp, advect_speed=40.0)
    for a, b in zip(js, ts):
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name
    jp = None if kind is None else jproj.Projection(kind=kind, ref_lat=40.0)
    tp = None if kind is None else tproj.Projection(kind=kind, ref_lat=40.0)
    jg, jst, jseg = jreal.real_init(jc, js, projection=jp)
    tg, tst, tseg = treal.real_init(tc, ts, projection=tp, device="cpu")
    grids_equal(jg, tg)
    assert tg.has_terrain == (terrain_amp > 0)
    assert set(jst) == set(tst)
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
    assert len(tseg) == len(jseg) == 2
    for a, b in zip(jseg, tseg):
        assert (float(a.t_lo), float(a.t_hi)) == (b.t_lo, b.t_hi)
        for side in ("lo", "hi"):
            for k, v in getattr(a, side).items():
                assert np.array_equal(np.asarray(v), getattr(b, side)[k].numpy()), (side, k)
    assert float((tseg[0].hi["t"] - tseg[0].lo["t"]).abs().max()) > 0.1
    # the rebalance reproduces the analysis surface pressure within the
    # vapour column's weight (mu is the dry column mass)
    p_sfc_dry = (tg.mub + tst["mu"]).numpy() + tg.p_top
    np.testing.assert_allclose(p_sfc_dry, ts[0].p_sfc, rtol=3e-3)


def test_boundary_stream_of_one_snapshot_is_constant():
    _, tc = real_cfgs(nx=8, ny=6, nz=6)
    snaps = treal.synthetic_analysis(tc, [0.0])
    _, _, segs = treal.real_init(tc, snaps, device="cpu")
    assert len(segs) == 1
    a, b = segs[0].at_time(0.0), segs[0].at_time(5000.0)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# WPS intermediate files
# ---------------------------------------------------------------------------

def _records(mod, hdate, ny=12, nx=20, seed=0, iproj=0):
    """A time's standard ungrib field set as records of module `mod`: TT,
    UU, VV and RH on three levels, PSFC and SOILHGT (the reference test's
    records)."""
    rng = np.random.default_rng(seed)
    proj = ({"startlat": 30.0, "startlon": -110.0, "deltalat": 0.5, "deltalon": 0.5,
             "earth_radius": 6367.47} if iproj == 0 else
            {"startlat": 30.0, "startlon": -110.0, "dx": 12.0, "dy": 12.0, "xlonc": -100.0,
             "truelat1": 30.0, "truelat2": 60.0, "earth_radius": 6367.47})

    def rec(field, xlvl, slab, units="K"):
        return mod.WPSRecord(hdate=hdate, xfcst=0.0, map_source="SYNTHETIC GFS",
                             field=field, units=units, desc=f"{field} test slab", xlvl=xlvl,
                             iproj=iproj, startloc="SWCORNER", proj=dict(proj),
                             wind_earth_rel=False, slab=np.asarray(slab, np.float32))

    out = []
    for p in (1000e2, 700e2, 300e2):
        out.append(rec("TT", p, 288.0 - 50.0 * np.log(1000e2 / p)
                       + rng.normal(0, 0.5, (ny, nx))))
        out.append(rec("UU", p, 10.0 + rng.normal(0, 1, (ny, nx)), "m s-1"))
        out.append(rec("VV", p, rng.normal(0, 1, (ny, nx)), "m s-1"))
        out.append(rec("RH", p, np.clip(70 + rng.normal(0, 10, (ny, nx)), 0, 100), "%"))
    out.append(rec("PSFC", mod.LVL_SURFACE, 101000.0 + rng.normal(0, 100, (ny, nx)), "Pa"))
    out.append(rec("SOILHGT", mod.LVL_SURFACE, np.abs(rng.normal(0, 50, (ny, nx))), "m"))
    return out


@pytest.mark.parametrize("iproj", [0, 3])
def test_wps_files_are_byte_identical_and_cross_read(tmp_path, iproj):
    """The same records written by each package give the same bytes, and
    each package's reader gives back the records of the other's file."""
    paths = {}
    for name, mod in (("jax", jwps), ("torch", twps)):
        paths[name] = str(tmp_path / f"FILE_{name}")
        mod.write_wps_intermediate(paths[name], _records(mod, "2019-07-01_00:00:00",
                                                         iproj=iproj))
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((twps, paths["jax"]), (jwps, paths["torch"])):
        back = reader.read_wps_intermediate(path)
        want = _records(twps, "2019-07-01_00:00:00", iproj=iproj)
        assert len(back) == len(want)
        for r, w in zip(back, want):
            assert (r.field, r.xlvl, r.iproj, r.hdate.strip(), r.units) == \
                (w.field, w.xlvl, w.iproj, w.hdate, w.units)
            assert np.array_equal(r.slab, w.slab)
            assert r.proj.keys() == w.proj.keys()


def test_snapshots_from_wps_match_jax(tmp_path):
    """Two times of files, read by each package into analysis snapshots
    (RH to mixing ratio), as they are and regridded bilinearly onto a
    Lambert model grid inside the source grid: bit for bit; and real_init
    from the snapshots gives the same state in both packages."""
    paths = []
    for n, hdate in enumerate(("2019-07-01_00:00:00", "2019-07-01_06:00:00")):
        paths.append(str(tmp_path / f"FILE:{hdate[:13]}"))
        twps.write_wps_intermediate(paths[-1], _records(twps, hdate, seed=n))
    jc, tc = real_cfgs(nx=10, ny=8, nz=6, specified=False)
    jg = jgrid.make_grid(jc, jsnd.weisman_klemp_theta(),
                         projection=jproj.Projection(kind="lambert", ref_lat=32.5,
                                                     ref_lon=-105.5))
    tg = tgrid.make_grid(tc, tsnd.weisman_klemp_theta(), "cpu",
                         projection=tproj.Projection(kind="lambert", ref_lat=32.5,
                                                     ref_lon=-105.5))
    for jgr, tgr in ((None, None), (jg, tg)):
        a = jwps.snapshots_from_wps(paths, grid=jgr)
        b = twps.snapshots_from_wps(paths, grid=tgr)
        assert [s.time_s for s in b] == [0.0, 21600.0]
        for sa, sb in zip(a, b):
            for f in dataclasses.fields(sa):
                assert np.array_equal(getattr(sa, f.name), getattr(sb, f.name)), f.name
    _, jst, _ = jreal.real_init(jc, a)
    _, tst, _ = treal.real_init(tc, b, device="cpu")
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
