"""The port's advection against the JAX package, on identical seeded inputs
(CPU): the plain version of the fused 5th/3rd-order kernel against
`advection.advect_scalar(..., 5, 3)` and against the Pallas kernel run in
interpret mode, the flux operators of every order, the PD limiter and the
momentum advection.  On the CUDA card, the kernel against its plain
version (skipped without one).
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
from wrfchem_arc_interactions_tpu.dycore import advection as jadv  # noqa: E402
from wrfchem_arc_interactions_tpu.grid import make_grid as jmake_grid  # noqa: E402
from wrfchem_arc_interactions_tpu.models import soundings  # noqa: E402
from wrfchem_arc_interactions_tpu.ops import pallas_adv  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.dycore import advection as tadv  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import grid_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402

NZ, NY, NX = 10, 16, 24     # the shapes of tests/test_overlap_pallas.py


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def grids():
    """The same flat grid in both packages (the port's built from the JAX
    one, so the metric arrays are bit-identical)."""
    cfg = jcfg.Config(domain=jcfg.DomainConfig(nx=NX, ny=NY, nz=NZ, dx=500.0,
                                               dy=400.0, ztop=17000.0,
                                               p_top=8000.0))
    jg = jmake_grid(cfg, soundings.weisman_klemp_theta())
    fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    fields = {k: (v if isinstance(v, (float, bool)) else np.asarray(v))
              for k, v in fields.items()}
    return jg, grid_from_numpy(fields, "cpu")


def _inputs(seed=0, ww_scale=1.0):
    """Seeded q_pad, ru_pad, rv_pad (NZ, NY+6, NX+6) and ww (NZ+1, NY, NX)
    with ww zero at the rigid boundaries."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(NZ, NY + 6, NX + 6)) + 3.0).astype(np.float32)
    ru = rng.normal(size=(NZ, NY + 6, NX + 6)).astype(np.float32)
    rv = rng.normal(size=(NZ, NY + 6, NX + 6)).astype(np.float32)
    ww = (ww_scale * rng.normal(size=(NZ + 1, NY, NX))).astype(np.float32)
    ww[0] = 0.0
    ww[-1] = 0.0
    return q, ru, rv, ww


def test_reference_matches_advect_scalar_and_pallas(grids):
    """Plain version vs the jnp path and vs the Pallas kernel (interpret
    mode): max |d| / max |ref| <= 1e-6 (float32, same operation order)."""
    jg, tg = grids
    q, ru, rv, ww = _inputs()
    jref = jadv.advect_scalar(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                              jnp.asarray(ww), jg, 5, 3)
    jpal = pallas_adv.advect_scalar_5_3(jnp.asarray(q), jnp.asarray(ru),
                                        jnp.asarray(rv), jnp.asarray(ww), jg.rdnw,
                                        jg.rdx, jg.rdy, interpret=True)
    out = adv_kernel.advect_scalar_5_3_reference(_t(q), _t(ru), _t(rv), _t(ww),
                                                 tg.rdnw, tg.rdx, tg.rdy)
    assert out.shape == (NZ, NY, NX) and out.dtype == torch.float32
    assert _rel(jref, out) <= 1e-6
    assert _rel(jpal, out) <= 1e-6
    # the wrapper takes the plain version for CPU tensors and counts nothing
    n0 = adv_kernel.advect_scalar_5_3.launches
    wrapped = adv_kernel.advect_scalar_5_3(_t(q), _t(ru), _t(rv), _t(ww),
                                           tg.rdnw, tg.rdx, tg.rdy)
    assert torch.equal(wrapped, out)
    assert adv_kernel.advect_scalar_5_3.launches == n0
    # and it equals the port's general path at (5, 3)
    gen = tadv.advect_scalar(_t(q), _t(ru), _t(rv), _t(ww), tg, 5, 3)
    assert torch.equal(gen, out)


@pytest.mark.parametrize("bad", ["dtype", "shape_ww", "shape_ru", "rdnw",
                                  "contiguous", "rank"])
def test_wrapper_rejects_bad_inputs(grids, bad):
    _, tg = grids
    q, ru, rv, ww = (_t(a) for a in _inputs())
    rdnw = tg.rdnw
    if bad == "dtype":
        q = q.double()
    elif bad == "shape_ww":
        ww = ww[:-1]
    elif bad == "shape_ru":
        ru = ru[:, 1:]
    elif bad == "rdnw":
        rdnw = rdnw[:-1]
    elif bad == "contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rank":
        q = q[0]
    with pytest.raises((TypeError, ValueError)):
        adv_kernel.advect_scalar_5_3(q, ru, rv, ww, rdnw, tg.rdx, tg.rdy)


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6])
def test_scalar_fluxes_and_flux_div(grids, order):
    """Face fluxes and divergence of every order: <= 1e-6 relative."""
    jg, tg = grids
    q, ru, rv, ww = _inputs(seed=order)
    jf = jadv.scalar_fluxes(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                            jnp.asarray(ww), order, 3)
    tf = tadv.scalar_fluxes(_t(q), _t(ru), _t(rv), _t(ww), order, 3)
    for a, b in zip(jf, tf):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= 1e-6
    jd = jadv.flux_div(*jf, jg)
    td = tadv.flux_div(*tf, tg)
    assert _rel(jd, td) <= 1e-6


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_vflux_updrafts_of_both_signs(order, sign):
    """vflux's -ww sign contract, for uniform updrafts and downdrafts."""
    rng = np.random.default_rng(10 + order)
    q = rng.normal(size=(NZ, 4, 5)).astype(np.float32)
    w = (sign * rng.uniform(0.5, 2.0, size=(NZ + 1, 4, 5))).astype(np.float32)
    a = jadv.vflux(jnp.asarray(w), jnp.asarray(q), order)
    b = tadv.vflux(_t(w), _t(q), order)
    assert _rel(a, b) <= 1e-6


def test_pd_limit(grids):
    """PD limiter on fluxes strong enough to need limiting: <= 1e-6."""
    jg, tg = grids
    q, ru, rv, ww = _inputs(seed=3, ww_scale=200.0)
    rng = np.random.default_rng(4)
    q = np.abs(q - 3.0).astype(np.float32) * (rng.uniform(size=q.shape) > 0.5)
    q = q.astype(np.float32)
    ru, rv = (30.0 * ru).astype(np.float32), (30.0 * rv).astype(np.float32)
    mu = rng.uniform(8e4, 9e4, size=(NY, NX)).astype(np.float32)
    phi_old = (mu[None] * q[:, 3:-3, 3:-3]).astype(np.float32)
    dt = 6.0
    jf = jadv.scalar_fluxes(jnp.asarray(q), jnp.asarray(ru), jnp.asarray(rv),
                            jnp.asarray(ww), 5, 3)
    jl = jadv.pd_limit(jnp.asarray(q), jnp.asarray(phi_old), *jf, jnp.asarray(ru),
                       jnp.asarray(rv), jnp.asarray(ww), dt, jg, JHalo())
    tf = tadv.scalar_fluxes(_t(q), _t(ru), _t(rv), _t(ww), 5, 3)
    tl = tadv.pd_limit(_t(q), _t(phi_old), *tf, _t(ru), _t(rv), _t(ww), dt, tg,
                       THalo())
    limited = any(_rel(a, b) > 0 for a, b in zip(jf, jl))
    assert limited, "inputs too weak to exercise the limiter"
    for a, b in zip(jl, tl):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("which", ["u", "v", "w"])
def test_momentum_advection(grids, which):
    jg, tg = grids
    rng = np.random.default_rng(20)
    ru, rv = (rng.normal(size=(2, NZ, NY + 6, NX + 6)) * 5e5).astype(np.float32)
    nzw = NZ + 1 if which == "w" else NZ
    fld = rng.normal(size=(nzw, NY + 6, NX + 6)).astype(np.float32)
    ww_pad = (rng.normal(size=(NZ + 1, NY + 6, NX + 6)) * 50.0).astype(np.float32)
    ww_pad[0] = 0.0
    ww_pad[-1] = 0.0
    if which == "w":
        ww = ww_pad[:, 3:-3, 3:-3]
        a = jadv.advect_w(jnp.asarray(fld), jnp.asarray(ru), jnp.asarray(rv),
                          jnp.asarray(ww), jg)
        b = tadv.advect_w(_t(fld), _t(ru), _t(rv), _t(ww), tg)
    else:
        jf = jadv.advect_u if which == "u" else jadv.advect_v
        tf = tadv.advect_u if which == "u" else tadv.advect_v
        a = jf(jnp.asarray(fld), jnp.asarray(ru), jnp.asarray(rv),
               jnp.asarray(ww_pad), jg)
        b = tf(_t(fld), _t(ru), _t(rv), _t(ww_pad), tg)
    assert a.shape == tuple(b.shape)
    assert _rel(a, b) <= 1e-6


@pytest.mark.cuda
def test_kernel_matches_reference_on_gpu(grids):
    """The CUDA kernel against its plain version on the card, at the
    slice's shape (50, 106, 106): the build uses --fmad=false, so the two
    round alike; the bound is 1e-5 of max |ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    nz, ny, nx = 50, 100, 100
    dev = torch.device("cuda")
    q, ru, rv = (torch.from_numpy(rng.normal(size=(nz, ny + 6, nx + 6))
                                  .astype(np.float32)).to(dev) for _ in range(3))
    ww = torch.from_numpy(rng.normal(size=(nz + 1, ny, nx)).astype(np.float32)).to(dev)
    ww[0] = 0.0
    ww[-1] = 0.0
    rdnw = torch.from_numpy(rng.uniform(-60, -40, nz).astype(np.float32)).to(dev)
    n0 = adv_kernel.advect_scalar_5_3.launches
    out = adv_kernel.advect_scalar_5_3(q, ru, rv, ww, rdnw, 1e-3, 1e-3)
    ref = adv_kernel.advect_scalar_5_3_reference(q, ru, rv, ww, rdnw, 1e-3, 1e-3)
    torch.cuda.synchronize()
    assert adv_kernel.advect_scalar_5_3.launches == n0 + 1
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
