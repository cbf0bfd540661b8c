"""The port's I/O modules (`io/netcdf.py`, `io/history.py`, `io/diags.py`,
`io/auxinput.py`) on the CPU, against the JAX package's on identical numpy
inputs: the native netCDF backend's round trip, cross-validated with
scipy's independent reader, and its quilt pool; files written by each
package read back bitwise in the other, in both containers; the
pressure-level diagnostics equal to the reference's (the same float64
numpy arithmetic); and the emission stream's snapshot selection.
"""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.io import auxinput as jaux  # noqa: E402
from wrfchem_arc_interactions_tpu.io import diags as jdiags  # noqa: E402
from wrfchem_arc_interactions_tpu.io import history as jhio  # noqa: E402
from wrfchem_arc_interactions_tpu.io import netcdf as jnc  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import auxinput as taux  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import diags as tdiags  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import history as thio  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import netcdf as tnc  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import build  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    history_names, restart_names, state_from_numpy,
)

from test_torch_slice import jax_grid_to_port  # noqa: E402


def _sample_fields():
    rng = np.random.default_rng(7)
    return {
        "t": rng.standard_normal((12, 8, 16)).astype(np.float32),
        "mu": rng.standard_normal((8, 16)).astype(np.float32),
        "znw": np.linspace(1.0, 0.0, 13),
        "counts": np.arange(9, dtype=np.int32),
    }


def _write(path, fields, async_write=False):
    w = tnc.NetCDFWriter()
    w.put_var("t", fields["t"], ["bottom_top", "south_north", "west_east"])
    w.put_var("mu", fields["mu"], ["south_north", "west_east"])
    w.put_var("znw", fields["znw"], ["bottom_top_stag"])
    w.put_var("counts", fields["counts"])
    w.put_att("_time_s", 360.0)
    w.put_att("title", "round-trip test")
    w.write(str(path), async_write=async_write)


def test_native_library_builds_into_the_port():
    """g++ builds the port's own wrfio into the port's build/, never next
    to the JAX package's source."""
    assert tnc.available(), tnc.unavailable_reason()
    assert tnc.lib_path().startswith(build.BUILD_DIR)
    assert glob.glob(f"{build.BUILD_DIR}/wrfio-*.so")


def test_round_trip_exact_and_scipy_reads_it(tmp_path):
    """Our reader gives back the exact arrays, and scipy's independent
    netCDF implementation reads the same file."""
    scipy_io = pytest.importorskip("scipy.io")
    fields = _sample_fields()
    p = tmp_path / "out.nc"
    _write(p, fields)
    got, attrs = tnc.read_netcdf(str(p))
    for k, v in fields.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert attrs["_time_s"] == 360.0
    f = scipy_io.netcdf_file(str(p), "r", mmap=False)
    for k, v in fields.items():
        np.testing.assert_array_equal(np.asarray(f.variables[k][:]), v, err_msg=k)
    assert f.variables["t"].dimensions == ("bottom_top", "south_north", "west_east")
    assert float(f._attributes["_time_s"]) == 360.0
    assert f._attributes["title"] == b"round-trip test"
    f.close()


def test_async_quilt_burst(tmp_path):
    """16 asynchronous writes through the C++ writer pool all land by drain."""
    for i in range(16):
        w = tnc.NetCDFWriter()
        w.put_var("x", np.full((64, 64), float(i), np.float32), ["south_north", "west_east"])
        w.write(str(tmp_path / f"q{i}.nc"), async_write=True)
    tnc.drain()
    for i in range(16):
        got, _ = tnc.read_netcdf(str(tmp_path / f"q{i}.nc"))
        assert (got["x"] == i).all(), i


def test_float64_bits_exact(tmp_path):
    v = np.array([np.pi, -0.0, 1e-308, 1e308, np.finfo(np.float64).tiny])
    w = tnc.NetCDFWriter()
    w.put_var("v", v, ["n"])
    w.write(str(tmp_path / "bits.nc"))
    got, _ = tnc.read_netcdf(str(tmp_path / "bits.nc"))
    assert got["v"].tobytes() == v.tobytes()


def _case(m, nx=16, ny=4, nz=12):
    """A moist squall-line state in package `m`'s config (both packages'
    Config take the same values)."""
    return m.Config(domain=m.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                          ztop=17000.0, p_top=8000.0),
                    time_control=m.TimeControl(dt=6.0))


def _states():
    """The reference's squall-line case, its state perturbed by a seeded
    noise so that no field is constant, on both sides."""
    jc, tc = _case(jcfg), _case(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    rng = np.random.default_rng(3)
    js = {k: (np.asarray(v) + 1e-3 * rng.standard_normal(np.shape(v))).astype(np.float32)
          for k, v in js.items()}
    js["qv"] = np.abs(js["qv"])
    tg, ts = jax_grid_to_port(jg), state_from_numpy(js, "cpu")
    return jc, tc, jg, {k: jnp.asarray(v) for k, v in js.items()}, tg, ts, js


def _emission_fields(ny, nx):
    rng = np.random.default_rng(5)
    return {k: rng.uniform(0.0, 1e-3, (ny, nx)).astype(np.float32)
            for k in ("so2", "no", "heat_mw")}


def _write_with(pkg, kind, path, case):
    jc, tc, jg, jsj, tg, ts, js = case
    t_s = 1234.5
    if kind == "history":
        if pkg == "jax":
            jhio.write_history(path, jc, jg, jsj, t_s, async_write=False)
        else:
            thio.write_history(path, tc, tg, ts, t_s, async_write=False)
    elif kind == "restart":
        (jhio if pkg == "jax" else thio).write_restart(
            path, jc if pkg == "jax" else tc, jsj if pkg == "jax" else ts, 7, t_s)
    elif kind == "auxdiag":
        if pkg == "jax":
            jdiags.write_diags(path, jc, jg, jsj, t_s)
        else:
            tdiags.write_diags(path, tc, tg, ts, t_s)
        (jhio if pkg == "jax" else thio).flush()
    else:
        (jaux if pkg == "jax" else taux).write_emissions(
            path, _emission_fields(*js["t"].shape[1:]), t_s)


def _read_with(pkg, kind, path, case):
    """(fields, time_s, step or None) as package `pkg` reads the file."""
    jc, tc, jg, jsj, tg, ts, js = case
    if kind == "restart":
        if pkg == "jax":
            st, step, t_s = jhio.read_restart(path, jc, jsj)
            return {k: np.asarray(v) for k, v in st.items()}, t_s, step
        st, step, t_s = thio.read_restart(path, tc, ts)
        assert all(v.device.type == "cpu" and v.dtype == ts[k].dtype for k, v in st.items())
        return {k: v.numpy() for k, v in st.items()}, t_s, step
    if kind == "emissions":
        f, t_s = (jaux if pkg == "jax" else taux).read_emissions(path)
        return f, t_s, None
    f, t_s = (jhio if pkg == "jax" else thio).read_history(path)
    return f, t_s, None


def _expected(kind, case):
    jc, tc, jg, jsj, tg, ts, js = case
    if kind == "history":
        out = {n: js[n] for n in history_names(jc)}
        out.update(znu=np.asarray(jg.znu), znw=np.asarray(jg.znw))
        return out
    if kind == "restart":
        return {n: js[n] for n in restart_names(jc)}
    if kind == "auxdiag":
        return jdiags.compute_diags(jsj, jg, jc)
    return _emission_fields(*js["t"].shape[1:])


@pytest.mark.parametrize("ext", [".nc", ".npz"])
@pytest.mark.parametrize("kind", ["history", "restart", "auxdiag", "emissions"])
def test_files_cross_read_bitwise(tmp_path, kind, ext):
    """A file of each stream written by either package reads back in both,
    bit for bit, with its time (and step); the two packages' netCDF files
    of one state are the same bytes."""
    assert jnc.available() and tnc.available()
    case = _states()
    assert history_names(case[0]) == tuple(history_names(case[1]))
    want = _expected(kind, case)
    paths = {}
    for writer in ("jax", "torch"):
        paths[writer] = str(tmp_path / f"{writer}_{kind}{ext}")
        _write_with(writer, kind, paths[writer], case)
        for reader in ("jax", "torch"):
            got, t_s, step = _read_with(reader, kind, paths[writer], case)
            assert t_s == 1234.5 and step in (None, 7), (writer, reader)
            for n, a in want.items():
                b = got[n]
                assert b.dtype == a.dtype and b.shape == a.shape, (writer, reader, n)
                np.testing.assert_array_equal(b, a, err_msg=f"{writer} -> {reader}: {n}")
    if ext == ".nc":
        with open(paths["jax"], "rb") as fj, open(paths["torch"], "rb") as ft:
            assert fj.read() == ft.read()


def test_diags_equal_reference():
    """compute_diags and sea_level_pressure on one moist state: the port's
    equal the reference's bit for bit (the same float64 numpy arithmetic
    on the same float32 inputs; the limit stated for them is 1e-6
    relative)."""
    jc, tc, jg, jsj, tg, ts, js = _states()
    jd, td = jdiags.compute_diags(jsj, jg, jc), tdiags.compute_diags(ts, tg, tc)
    assert set(jd) == set(td)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    np.testing.assert_array_equal(tdiags.sea_level_pressure(ts, tg, tc),
                                  jdiags.sea_level_pressure(jsj, jg, jc))
    assert np.isfinite(td["slp"]).all() and np.isfinite(td["z_pl"][0]).all()


def test_diags_physical_and_auxhist_alarm(tmp_path):
    """test_diags.py on the port: SLP and pressure-level heights of a
    quiescent sounding, interpolation exact at a model level, missing above
    the top; the auxhist alarm writes every 50 s."""
    cfg = tcfg.Config(
        domain=tcfg.DomainConfig(nx=16, ny=4, nz=20, dx=2000.0, dy=2000.0,
                                 ztop=16000.0, p_top=10000.0),
        time_control=tcfg.TimeControl(dt=10.0, history_interval_s=0.0,
                                      auxhist_interval_s=50.0))
    grid, state = tideal.make_case(cfg, "quiescent", device="cpu")
    out = tdiags.compute_diags(state, grid, cfg)
    assert 9.5e4 < out["slp"].mean() < 1.03e5
    assert 4500.0 < np.nanmean(out["z_pl"][2]) < 6500.0
    assert 1000.0 < np.nanmean(out["z_pl"][0]) < 2200.0
    t = out["t_pl"]
    assert np.nanmean(t[0]) > np.nanmean(t[2]) > np.nanmean(t[3])
    h = tdiags._host(state, grid)
    p, t_air, z, qv, mu = tdiags._column_fields(h, grid.p_top)
    got = tdiags._interp_p(p, t_air, [float(p[5, 0, 0])])[0, 0, 0]
    np.testing.assert_allclose(got, t_air[5, 0, 0], rtol=1e-6)
    assert np.isnan(tdiags._interp_p(p, t_air, [1.0])).all()
    sim = TSim(cfg, grid, state, device="cpu", output_dir=str(tmp_path))
    sim.advance(10)
    thio.flush()
    files = sorted(glob.glob(str(tmp_path / "auxdiag_*")))
    assert [f.rsplit("/", 1)[1] for f in files] == ["auxdiag_000005.nc", "auxdiag_000010.nc"]
    f, t_s = thio.read_history(files[0])
    assert "slp" in f and "z_pl" in f and t_s == 50.0


def test_emission_stream_selection(tmp_path):
    """from_files orders the snapshots; at_time gives the reference's
    snapshot before, on and between the file times and after the last."""
    ny, nx = 4, 6
    paths = []
    for i, t in enumerate((0.0, 3600.0, 7200.0)):
        p = str(tmp_path / f"emis_{i}.npz")
        taux.write_emissions(p, {"so2": np.full((ny, nx), float(i + 1), np.float32)}, t)
        paths.append(p)
    ts, js = taux.EmissionStream.from_files(paths[::-1]), jaux.EmissionStream.from_files(paths)
    assert ts.times == js.times == [0.0, 3600.0, 7200.0]
    for t in (-10.0, 0.0, 1800.0, 3599.999, 3600.0, 5000.0, 7200.0, 9e9):
        np.testing.assert_array_equal(ts.at_time(t)["so2"], js.at_time(t)["so2"], err_msg=str(t))
    assert [float(ts.at_time(t)["so2"][0, 0]) for t in (-10.0, 1800.0, 3600.0, 9e9)] == \
        [1.0, 1.0, 2.0, 3.0]
