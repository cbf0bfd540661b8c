"""The port's RRTMG radiation against the JAX package, on identical seeded
inputs (both on the CPU): band structure and k-tables (exact), the McICA
subcolumn mask (bit for bit, its uniforms included), gas optical depths
and the two-stream layer properties (1e-5 of each field's magnitude), the
SW and LW flux solvers with and without aerosol and cloud fraction, and
the radiation driver on a small config-3 state at noon (1e-4 of each
field's magnitude: the port sums the g-points and the (ln p, T)
interpolation in another order, and the heating rates are differences of
fluxes ~1e4 times larger than their float32 rounding).  Then the
reference's radiation anchors (tests/test_radiation_anchors.py) on the
port, with their inputs and envelopes: clear-sky OLR and surface SW, CO2
doubling, and the gray limits of the two-stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import bands as jbands  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import driver as jdrv  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import gas_optics as jgas  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import ktables as jkt  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import mcica as jmc  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import rrtmg_lw as jlw  # noqa: E402
from wrfchem_arc_interactions_tpu.physics.radiation import rrtmg_sw as jsw  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands as tbands  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import driver as tdrv  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import gas_optics as tgas  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import ktables as tkt  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import mcica as tmc  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import rrtmg_lw as tlw  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import rrtmg_sw as tsw  # noqa: E402

from test_torch_slice import _cfg3, jax_grid_to_port  # noqa: E402

NZ, NCOL = 10, 6


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _columns(seed=0, nz=NZ, ncol=NCOL):
    """Seeded atmospheric columns, surface first: p, t, dp, qv, lwp (nz,
    ncol) and t_sfc (ncol,), float32; lwp is zero in about half the
    cells."""
    rng = np.random.default_rng(seed)
    p_w = np.linspace(1.0e5, 8.0e3, nz + 1)[:, None] * rng.uniform(0.97, 1.0, ncol)
    p = 0.5 * (p_w[:-1] + p_w[1:])
    dp = -np.diff(p_w, axis=0)
    z = 16.0e3 * (1.0 - (p / 1.0e5) ** 0.29)
    t = np.maximum(300.0 - 6.5e-3 * z, 205.0) + rng.normal(0.0, 2.0, (nz, ncol))
    qv = 0.015 * (p / 1.0e5) ** 3 * rng.uniform(0.5, 1.0, (nz, ncol))
    lwp = np.where(rng.uniform(size=(nz, ncol)) > 0.5,
                   rng.uniform(0.0, 0.3, (nz, ncol)), 0.0)
    t_sfc = rng.uniform(290.0, 305.0, ncol)
    return tuple(a.astype(np.float32) for a in (p, t, dp, qv, lwp, t_sfc))


def test_bands_and_ktables_exact():
    for name in ("WAVENUM_LW", "NG_LW", "WAVENUM_SW", "NG_SW", "GPT_OFFSET_LW",
                 "GPT_OFFSET_SW", "BAND_OF_GPT_LW", "BAND_OF_GPT_SW"):
        np.testing.assert_array_equal(getattr(jbands, name), getattr(tbands, name))
    np.testing.assert_array_equal(jbands.band_centers_sw_um(), tbands.band_centers_sw_um())
    np.testing.assert_array_equal(jbands.band_centers_lw_um(), tbands.band_centers_lw_um())
    np.testing.assert_array_equal(jkt.LNP_REF, tkt.LNP_REF)
    a, b = jkt.load_tables(), tkt.load_tables()
    for kind in ("kmajor_lw", "kmajor_sw"):
        ja, tb = getattr(a, kind), getattr(b, kind)
        assert list(ja) == list(tb)
        for sp in ja:
            np.testing.assert_array_equal(ja[sp], tb[sp], err_msg=f"{kind} {sp}")
    for name in ("planck_frac_lw", "solar_src_sw", "rayleigh_sw"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("seed", [0, 7, 43200, 4294967295])
def test_mcica_mask_bit_exact(seed):
    """The uniforms and the max-random-overlap mask, bit for bit."""
    ju = np.asarray(jmc.uniform_gk(140, NZ, seed))
    tu = tmc.uniform_gk(140, NZ, seed).numpy()
    assert ju.dtype == tu.dtype == np.float32
    np.testing.assert_array_equal(ju, tu)
    rng = np.random.default_rng(seed % 1000)
    cf = rng.uniform(size=(NZ, NCOL))
    cf[rng.uniform(size=cf.shape) < 0.3] = 0.0
    cf[rng.uniform(size=cf.shape) < 0.1] = 1.0
    cf = cf.astype(np.float32)
    jm = np.asarray(jmc.mcica_mask(jnp.asarray(cf), 112, seed))
    tm = tmc.mcica_mask(_t(cf), 112, seed).numpy()
    assert 0.0 < tm.mean() < 1.0
    np.testing.assert_array_equal(jm, tm)


def test_cloud_fraction_and_zenith():
    p, t, _, qv, lwp, _ = _columns(seed=1)
    qc = (lwp * 1e-2).astype(np.float32)
    jcf = jmc.xu_randall_cldfra(*(jnp.asarray(a) for a in (p, t, qv, qc)))
    tcf = tmc.xu_randall_cldfra(*(_t(a) for a in (p, t, qv, qc)))
    assert float(np.asarray(jcf).max()) > 0.0
    assert _rel(jcf, tcf) <= 1e-5
    rng = np.random.default_rng(2)
    lat = rng.uniform(-60, 60, (3, 4)).astype(np.float32)
    lon = rng.uniform(-180, 180, (3, 4)).astype(np.float32)
    for ts, jd in ((43200.0, 172.0), (np.float32(50000.5), np.float32(100.25))):
        jm = jdrv.cos_zenith(jnp.float32(ts), jnp.asarray(lat), jnp.asarray(lon),
                             julian_day=jnp.float32(jd))
        tm = tdrv.cos_zenith(ts, _t(lat), _t(lon), julian_day=jd)
        assert _rel(jm, tm) <= 1e-5


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_gas_tau(kind):
    p, t, dp, qv, _, _ = _columns(seed=3)
    j = jgas.gas_tau(kind, *(jnp.asarray(a) for a in (p, t, dp, qv)))
    o = tgas.gas_tau(kind, *(_t(a) for a in (p, t, dp, qv)))
    assert j.shape == tuple(o.shape)
    assert _rel(j, o) <= 1e-5
    if kind == "sw":
        assert _rel(jgas.rayleigh_tau(jnp.asarray(dp), jnp.float32),
                    tgas.rayleigh_tau(_t(dp))) <= 1e-5


def test_two_stream():
    rng = np.random.default_rng(4)
    shp = (7, NZ, NCOL)
    tau = (10.0 ** rng.uniform(-4, 1.5, shp)).astype(np.float32)
    ssa = rng.uniform(0.0, 1.0, shp).astype(np.float32)
    asy = rng.uniform(0.0, 0.95, shp).astype(np.float32)
    mu0 = rng.uniform(0.05, 1.0, (1, 1, NCOL)).astype(np.float32)
    j = jsw.two_stream(*(jnp.asarray(a) for a in (tau, ssa, asy, mu0)))
    o = tsw.two_stream(*(_t(a) for a in (tau, ssa, asy, mu0)))
    for name, a, b in zip(("r_dif", "t_dif", "r_dir", "t_dir", "t0"), j, o):
        assert _rel(a, b) <= 1e-5, name


def test_two_stream_at_the_resonance():
    """Where k mu0 rounds to 1 exactly (a pure absorber has k = 1.75; mu0
    the float32 next to 4/7), the reference's guard pushes by sign(0) = 0
    and divides by zero: its direct-beam terms are not finite.  The port
    pushes that case out of the window, as the guard intends, and equals
    the reference on the neighbouring sun angles (a domain of varying sun
    angles meets the resonance; slice 9's real-data run did)."""
    mu0 = np.float32(4.0 / 7.0) + np.float32(2.0 ** -24) * np.arange(-3, 4, dtype=np.float32)
    hit = np.float32(1.75) * mu0 == np.float32(1.0)
    assert hit.any() and not hit.all()
    args = (np.full(7, 0.3, np.float32), np.zeros(7, np.float32), np.full(7, 0.5, np.float32),
            mu0.astype(np.float32))
    j = jsw.two_stream(*(jnp.asarray(a) for a in args))
    o = tsw.two_stream(*(_t(a) for a in args))
    assert not np.isfinite(np.asarray(j[2])[hit]).all()
    for name, a, b in zip(("r_dif", "t_dif", "r_dir", "t_dir", "t0"), j, o):
        assert torch.isfinite(b).all(), name
        np.testing.assert_array_equal(np.asarray(a)[~hit], b.numpy()[~hit], err_msg=name)


def _aerosol(nband, seed):
    rng = np.random.default_rng(seed)
    tau = rng.uniform(0.0, 0.2, (nband, NZ, NCOL)).astype(np.float32)
    ssa = rng.uniform(0.7, 1.0, (nband, NZ, NCOL)).astype(np.float32)
    asy = rng.uniform(0.5, 0.8, (nband, NZ, NCOL)).astype(np.float32)
    return tau, ssa, asy


def _cldfra(lwp):
    rng = np.random.default_rng(5)
    return np.where(lwp > 0, rng.uniform(0.1, 1.0, lwp.shape), 0.0).astype(np.float32)


@pytest.mark.parametrize("aerosol", [False, True])
@pytest.mark.parametrize("cloud", [False, True])
def test_sw_fluxes(aerosol, cloud):
    p, t, dp, qv, lwp, _ = _columns(seed=6)
    rng = np.random.default_rng(8)
    mu0 = rng.uniform(0.1, 1.0, NCOL).astype(np.float32)
    alb = np.full(NCOL, 0.2, np.float32)
    args = (p, t, dp, qv, lwp, mu0, alb)
    jkw, tkw = {}, {}
    if aerosol:
        for name, a in zip(("tau_aer_sw", "ssa_aer_sw", "asy_aer_sw"),
                           _aerosol(tbands.NBND_SW, 9)):
            jkw[name], tkw[name] = jnp.asarray(a), _t(a)
    if cloud:
        cf = _cldfra(lwp)
        jkw.update(cldfra=jnp.asarray(cf), mcica_seed=43200)
        tkw.update(cldfra=_t(cf), mcica_seed=43200)
    j = jsw.sw_fluxes(*(jnp.asarray(a) for a in args), **jkw)
    o = tsw.sw_fluxes(*(_t(a) for a in args), **tkw)
    assert float(np.asarray(j["swdown"]).min()) > 0.0
    for name in ("flux_dn", "flux_up", "heating", "swdown", "swup_toa"):
        assert _rel(j[name], o[name]) <= 1e-4, name


@pytest.mark.parametrize("aerosol", [False, True])
@pytest.mark.parametrize("cloud", [False, True])
def test_lw_fluxes(aerosol, cloud):
    p, t, dp, qv, lwp, t_sfc = _columns(seed=10)
    args = (p, t, dp, qv, lwp, t_sfc)
    jkw, tkw = {}, {}
    if aerosol:
        a = _aerosol(tbands.NBND_LW, 11)[0]
        jkw["tau_aer_lw"], tkw["tau_aer_lw"] = jnp.asarray(a), _t(a)
    if cloud:
        cf = _cldfra(lwp)
        jkw.update(cldfra=jnp.asarray(cf), mcica_seed=7)
        tkw.update(cldfra=_t(cf), mcica_seed=7)
    j = jlw.lw_fluxes(*(jnp.asarray(a) for a in args), **jkw)
    o = tlw.lw_fluxes(*(_t(a) for a in args), **tkw)
    for name in ("flux_up", "flux_dn", "heating", "olr", "glw"):
        assert _rel(j[name], o[name]) <= 1e-4, name


def _driver_inputs():
    """Config 3's squall-line state at 16x4x12 with seeded cloud water and
    aerosol optics, and the time of a noon call (the SW path does real
    work): (jc, tc, jg, tg, js, ts, t_utc, jd)."""
    jc, tc = _cfg3(jcfg), _cfg3(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = {k: np.asarray(v) for k, v in js.items()}
    rng = np.random.default_rng(12)
    shp = js["t"].shape
    js["qc"] = np.where(rng.uniform(size=shp) > 0.8,
                        rng.uniform(0, 2e-4, shp), 0.0).astype(np.float32)
    for name, a in zip(("tau_aer_sw", "ssa_aer_sw", "asy_aer_sw"),
                       (rng.uniform(0.0, 0.1, (14,) + shp), rng.uniform(0.8, 1.0, (14,) + shp),
                        rng.uniform(0.5, 0.8, (14,) + shp))):
        js[name] = a.astype(np.float32)
    js["tau_aer_lw"] = rng.uniform(0.0, 0.02, (16,) + shp).astype(np.float32)
    tg = jax_grid_to_port(jg)
    ts = {k: _t(v) for k, v in js.items()}
    t_utc, jd = np.float32(43200.0 + 60.0), np.float32(172.5 + 60.0 / 86400.0)
    return jc, tc, jg, tg, js, ts, t_utc, jd


RAD_OUT = ("rthraten_sw", "rthraten_lw", "swdown", "swupt", "olr", "glw", "cldfra")


def test_radiation_driver_config3():
    """The driver on the squall-line state with seeded cloud water and
    aerosol optics, at noon (so the SW path does real work)."""
    jc, tc, jg, tg, js, ts, t_utc, jd = _driver_inputs()
    jout = jdrv.radiation_driver({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                 jnp.float32(t_utc), julian_day=jnp.float32(jd))
    tout = tdrv.radiation_driver(ts, tg, tc, t_utc, julian_day=jd)
    assert float(np.asarray(jout["swdown"]).max()) > 100.0
    assert float(np.asarray(jout["cldfra"]).max()) > 0.0
    for name in RAD_OUT:
        assert _rel(jout[name], tout[name]) <= 1e-4, name


def test_radiation_driver_column_chunks(monkeypatch):
    """With the chunk patched below the 64 columns (six chunks of 10 and a
    shorter one of 4), the chunked driver equals the unchunked one bit for
    bit, and agrees with the reference driver chunked likewise (its chunks
    of 24 padded by edge replication) to 1e-4, as unchunked."""
    jc, tc, jg, tg, js, ts, t_utc, jd = _driver_inputs()
    whole = tdrv.radiation_driver(ts, tg, tc, t_utc, julian_day=jd)
    calls = []
    inner = tsw.sw_fluxes

    def counting(*args, **kw):
        calls.append(args[0].shape[-1])
        return inner(*args, **kw)

    monkeypatch.setattr(tdrv, "COL_CHUNK", 10)
    monkeypatch.setattr(tdrv, "sw_fluxes", counting)
    chunked = tdrv.radiation_driver(ts, tg, tc, t_utc, julian_day=jd)
    assert calls == [10] * 6 + [4]
    for name in RAD_OUT:
        assert torch.equal(whole[name], chunked[name]), name
    monkeypatch.setattr(jdrv, "COL_CHUNK", 24)
    jout = jdrv.radiation_driver({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                 jnp.float32(t_utc), julian_day=jnp.float32(jd))
    for name in RAD_OUT:
        assert _rel(jout[name], chunked[name]) <= 1e-4, name


# -- the reference's radiation anchors (tests/test_radiation_anchors.py) on the
# port: the same columns and the same physical envelopes


def standard_column(nz=40, ncol=2, qv0=0.012, lwp_cloud=0.0):
    """`tests/test_radiation.py::standard_column` in the port: an idealised
    tropical-ish column, surface first, float32."""
    p_w = np.linspace(1.0e5, 5.0e3, nz + 1)
    p_lay = 0.5 * (p_w[:-1] + p_w[1:])
    dp_lay = -(np.diff(p_w))
    z = 16.0e3 * (1.0 - (p_lay / 1.0e5) ** 0.29)
    t_lay = np.maximum(300.0 - 6.5e-3 * z, 210.0)
    qv = qv0 * (p_lay / 1.0e5) ** 3
    lwp = np.zeros(nz)
    if lwp_cloud > 0:
        lwp[nz // 3] = lwp_cloud

    def rep(a):
        return _t(np.repeat(a[:, None], ncol, 1))
    return (rep(p_lay), rep(t_lay), rep(dp_lay), rep(qv), rep(lwp),
            torch.full((ncol,), 300.0))


def test_tropical_clear_sky_olr_window():
    out = tlw.lw_fluxes(*standard_column(qv0=0.012))
    olr = float(out["olr"][0])
    assert 278.0 < olr < 302.0, f"tropical clear OLR {olr} outside window"


def test_dry_column_olr_above_tropical():
    """Less water vapor -> less trapping -> higher OLR, short of sigma T^4."""
    olr_trop = float(tlw.lw_fluxes(*standard_column(qv0=0.012))["olr"][0])
    olr_dry = float(tlw.lw_fluxes(*standard_column(qv0=0.002))["olr"][0])
    sig_ts4 = 5.670e-8 * 300.0 ** 4
    assert olr_trop + 15.0 < olr_dry < sig_ts4 - 80.0, (olr_trop, olr_dry)


def test_co2_doubling_reduces_olr_by_a_few_wm2():
    args = standard_column(qv0=0.012)
    base = tgas.CO2_VMR
    olr1 = float(tlw.lw_fluxes(*args)["olr"][0])
    try:
        tgas.CO2_VMR = 2.0 * base
        tkt.load_tables.cache_clear()
        olr2 = float(tlw.lw_fluxes(*args)["olr"][0])
    finally:
        tgas.CO2_VMR = base
        tkt.load_tables.cache_clear()
    d = olr2 - olr1
    # instantaneous 2xCO2 TOA forcing is ~-2.5 to -4 W/m2 in line-by-line
    # models: a generous envelope, the right sign and order of magnitude
    assert -12.0 < d < -1.0, f"2xCO2 dOLR {d}"


def test_surface_sw_overhead_sun_window():
    p, t, dp, qv, lwp, _ = standard_column(qv0=0.002)
    mu0 = torch.full((2,), 1.0)
    alb = torch.full((2,), 0.1)
    sfc = float(tsw.sw_fluxes(p, t, dp, qv, lwp, mu0, alb)["flux_dn"][0, 0])
    assert 995.0 < sfc < 1120.0, f"dry overhead-sun surface SW {sfc}"
    # the humid tropical column absorbs more: a lower surface total, still > 850
    sfc_t = float(tsw.sw_fluxes(*standard_column(qv0=0.012)[:5], mu0, alb)["flux_dn"][0, 0])
    assert 850.0 < sfc_t < sfc, (sfc_t, sfc)


def test_clear_sky_planetary_albedo_plausible():
    """TOA up / TOA down over a 0.1-albedo surface: clear-sky planetary
    albedo near 10-17% (Rayleigh + surface)."""
    p, t, dp, qv, lwp, _ = standard_column(qv0=0.008)
    out = tsw.sw_fluxes(p, t, dp, qv, lwp, torch.full((2,), 1.0), torch.full((2,), 0.1))
    a = float(out["flux_up"][-1, 0] / out["flux_dn"][-1, 0])
    assert 0.08 < a < 0.20, a


def test_gray_limit_direct_beam_is_beer_lambert():
    """Pure absorber (ssa = 0): the two-stream's direct transmission is
    exactly exp(-tau/mu0)."""
    for tau, mu0 in ((0.3, 1.0), (1.0, 0.5), (3.0, 0.8)):
        tt = torch.full((1, 1), tau)
        t0 = tsw.two_stream(tt, torch.zeros_like(tt), torch.zeros_like(tt),
                            torch.full((1,), mu0))[4]
        np.testing.assert_allclose(float(t0[0, 0]), np.exp(-tau / mu0), rtol=1e-5)


def test_gray_limit_conservative_scattering_reflects_everything():
    """ssa = 1, asy = 0, tau -> inf: a semi-infinite conservative scatterer
    reflects nearly all incident flux (R_dif -> 1)."""
    tt = torch.full((1, 1), 200.0)
    r_dif, t_dif, _, _, _ = tsw.two_stream(tt, torch.full((1, 1), 0.9999),
                                           torch.zeros((1, 1)), torch.full((1,), 1.0))
    assert float(r_dif[0, 0]) > 0.93
    assert float(t_dif[0, 0]) < 0.05
