"""Every ideal case this slice ports, built by the port's `make_case` against
the JAX package's (CPU): the grid bit for bit, every initial field to 1e-7
of its magnitude (both build the case in numpy float64 from the same
float32 grid and cast once); the Noah soil columns and the deep soil
temperature set by `init_balanced`; and two of the reference tests'
properties of the cases, on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402

from test_torch_slice import _rel  # noqa: E402

GRID_FIELDS = ("znw", "rdnw", "fnm", "fnp", "mub", "pb", "alb", "phb", "t_init",
               "f", "xlat", "xlong")

# (case, domain, physics, case keywords)
CASES = [
    ("squall2d_y", dict(nx=6, ny=24, nz=12, dx=1000.0, dy=1000.0, ztop=17000.0,
                        p_top=8000.0), {}, {}),
    ("grav2d_x", dict(nx=32, ny=4, nz=12, dx=400.0, dy=400.0, ztop=6400.0,
                      p_top=50000.0), {}, {}),
    ("seabreeze2d_x", dict(nx=24, ny=4, nz=12, dx=2000.0, dy=2000.0, ztop=8000.0,
                           p_top=35000.0),
     dict(bl_pbl_physics="ysu", sf_sfclay_physics="revised_mm5",
          sf_surface_physics="noah"), {}),
    ("quarter_ss", dict(nx=16, ny=16, nz=12, dx=2000.0, dy=2000.0, ztop=17000.0,
                        p_top=8000.0), {}, {}),
    ("b_wave", dict(nx=12, ny=20, nz=10, dx=100e3, dy=100e3, ztop=16000.0,
                    p_top=10000.0), {}, {}),
    ("les", dict(nx=12, ny=12, nz=16, dx=100.0, dy=100.0, ztop=2000.0,
                 p_top=80000.0), {}, {}),
    ("tropical_cyclone", dict(nx=16, ny=16, nz=12, dx=20000.0, dy=20000.0,
                              ztop=20000.0, p_top=5000.0),
     dict(bl_pbl_physics="ysu", sf_sfclay_physics="revised_mm5",
          sf_surface_physics="noah"), dict(v_max=20.0)),
    ("squall2d_x", dict(nx=16, ny=4, nz=12, dx=1000.0, dy=1000.0, ztop=17000.0,
                        p_top=8000.0),
     dict(bl_pbl_physics="ysu", sf_sfclay_physics="revised_mm5",
          sf_surface_physics="noah"), {}),
]


def _cfg(m, domain, phys):
    ph = m.PhysicsConfig()
    ph = dataclasses.replace(ph, **{k: type(getattr(ph, k))(v) for k, v in phys.items()})
    return m.Config(domain=m.DomainConfig(**domain), physics=ph)


@pytest.mark.parametrize("case,domain,phys,kw", CASES, ids=[c[0] + ("-noah" if c[2] else "")
                                                            for c in CASES])
def test_case_matches_jax(case, domain, phys, kw):
    jg, js = jideal.make_case(_cfg(jcfg, domain, phys), case, **kw)
    tg, ts = tideal.make_case(_cfg(tcfg, domain, phys), case, device="cpu", **kw)
    for name in GRID_FIELDS:
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(js) == set(ts)
    for name, a in js.items():
        a, b = np.asarray(a), ts[name].numpy()
        assert a.shape == b.shape and b.dtype == np.float32, name
        assert _rel(a, b, float(np.abs(a).max())) <= 1e-7, (name, _rel(a, b, np.abs(a).max()))
    if phys:
        # the Noah columns start isothermal at the skin, moist
        assert torch.equal(ts["tmn"], ts["tsk"])
        assert torch.equal(ts["tslb"], ts["tsk"][None].expand(4, -1, -1))
        assert float(ts["smois"].min()) == float(ts["smois"].max()) == 0.25


def test_squall_y_mirrors_squall_x():
    """squall2d_y is squall2d_x with x and y (and u and v) exchanged."""
    dom = dict(nx=20, ny=20, nz=12, dx=1000.0, dy=1000.0, ztop=17000.0, p_top=8000.0)
    _, sx = tideal.make_case(_cfg(tcfg, dom, {}), "squall2d_x", device="cpu")
    _, sy = tideal.make_case(_cfg(tcfg, dom, {}), "squall2d_y", device="cpu")
    for name in ("t", "qv", "mu", "ph"):
        assert torch.equal(sy[name], sx[name].transpose(-1, -2)), name
    assert torch.equal(sy["v"], sx["u"].transpose(-1, -2))


def test_tc_init_warm_core_and_gradient_wind():
    """The reference's tropical-cyclone test, on the port: a warm core, the
    wind maximum near v_max, cyclonic rotation, the warm SST."""
    dom = dict(nx=24, ny=24, nz=16, dx=20000.0, dy=20000.0, ztop=20000.0, p_top=5000.0)
    _, s = tideal.make_case(_cfg(tcfg, dom, {}), "tropical_cyclone", device="cpu",
                            v_max=20.0, r_max=80e3)
    th, u, v = (s[k].numpy() for k in ("t", "u", "v"))
    assert 15.0 < np.sqrt(u ** 2 + v ** 2).max() < 25.0
    k, c0 = 8, 12
    assert th[k, c0 - 2:c0 + 2, c0 - 2:c0 + 2].mean() - th[k, :4, :4].mean() > 0.3
    assert v[0, c0, c0 + 2] > 1.0 and v[0, c0, c0 - 3] < -1.0
    assert abs(float(s["tsk"][0, 0]) - 302.0) < 0.5
