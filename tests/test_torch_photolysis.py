"""The port's Fast-J-style photolysis against the JAX package on identical
seeded inputs (both on the CPU): the spectral tables and the clear-sky
anchor `_reference_actinic` (tables exact, the anchor to 1e-5), the actinic
flux with and without clouds and aerosol, the per-reaction J scales
(`j_scales`) and the gray `aux.photolysis_profile`, each to 1e-4 of the
field's magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu.chem import aux as jaux  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import photolysis as jphot  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import aux as taux  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import photolysis as tphot  # noqa: E402

TOL = 1e-4
NZ, NY, NX = 14, 3, 4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _inputs(seed, aerosol):
    rng = np.random.default_rng(seed)
    shp = (NZ, NY, NX)
    p_w = np.linspace(1.0e5, 8.0e3, NZ + 1)
    dp = np.broadcast_to((p_w[:-1] - p_w[1:])[:, None, None], shp) * rng.uniform(0.9, 1.1, shp)
    o3 = 4e-8 * rng.uniform(0.5, 2.0, shp) + 4e-6 * (np.arange(NZ) > NZ - 4)[:, None, None]
    lwp = 0.05 * rng.uniform(0, 1, shp) * (rng.uniform(size=shp) > 0.7)
    mu0 = rng.uniform(-0.2, 1.0, (NY, NX))
    mu0[0, 0] = 1.0
    mu0[1, 1] = -0.1                 # night
    out = {"mu0": mu0, "dp": dp, "o3": o3, "lwp": lwp}
    if aerosol:
        nb = len(jphot._SW_UM)
        out["tau"] = 0.05 * rng.uniform(0, 1, (nb,) + shp)
        out["ssa"] = rng.uniform(0.7, 1.0, (nb,) + shp)
        out["asy"] = rng.uniform(0.5, 0.8, (nb,) + shp)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _call(fn, d, conv):
    aer = [conv(d[k]) for k in ("tau", "ssa", "asy")] if "tau" in d else []
    return fn(conv(d["mu0"]), conv(d["dp"]), conv(d["o3"]), conv(d["lwp"]), *aer)


def test_tables_and_anchor():
    for name in ("WL_NM", "DWL_NM", "F_TOA", "SIGMA_RAY", "SIGMA_O3", "BAND_OF_WL"):
        np.testing.assert_array_equal(getattr(jphot, name), getattr(tphot, name))
    assert list(jphot.SPECTRAL_W) == list(tphot.SPECTRAL_W)
    for k, w in jphot.SPECTRAL_W.items():
        np.testing.assert_array_equal(w, tphot.SPECTRAL_W[k])
    assert jphot.MOLEC_PER_PA == tphot.MOLEC_PER_PA
    a, b = jphot._reference_actinic(), tphot._reference_actinic()
    assert a.shape == b.shape == (jphot.NW,)
    assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("seed,aerosol", [(0, False), (1, True)])
def test_actinic_flux_and_j_scales(seed, aerosol):
    d = _inputs(seed, aerosol)
    ja = _call(jphot.actinic_flux, d, jnp.asarray)
    ta = _call(tphot.actinic_flux, d, _t)
    assert ta.shape == (tphot.NW, NZ, NY, NX)
    assert _rel(ja, ta.numpy()) <= TOL
    night = d["mu0"] <= 0.0
    assert night.any() and float(ta[:, :, _t(night).bool()].abs().max()) == 0.0
    jj = _call(jphot.j_scales, d, jnp.asarray)
    tj = _call(tphot.j_scales, d, _t)
    assert list(jj) == list(tj)
    worst = max(_rel(jj[k], tj[k].numpy()) for k in jj)
    print("j_scales worst:", worst)
    assert worst <= TOL
    assert float(tj["no2"].max()) > 0.3


def test_overhead_clear_sky_is_anchor():
    """At the anchor's own column (overhead sun, standard atmosphere) every
    J scale is 1 at the surface, as in the reference's own test."""
    nz = 40
    p_w = np.linspace(101325.0, 1000.0, nz + 1)
    dp = (p_w[:-1] - p_w[1:]).reshape(nz, 1)
    z_mid = -7.5 * np.log(0.5 * (p_w[:-1] + p_w[1:]) / 101325.0)
    shape = np.exp(-0.5 * ((z_mid - 23.0) / 5.0) ** 2) + 0.02
    n_col = dp[:, 0] * tphot.MOLEC_PER_PA
    o3 = (shape / np.sum(shape * n_col) * 300.0 * 2.687e16).reshape(nz, 1)
    tj = tphot.j_scales(torch.ones(1), _t(dp), _t(o3), torch.zeros(nz, 1))
    for k, v in tj.items():
        assert abs(float(v[0, 0]) - 1.0) <= 1e-5, k


@pytest.mark.parametrize("with_aer", [False, True])
def test_photolysis_profile(with_aer):
    rng = np.random.default_rng(7)
    shp = (NZ, NY, NX)
    mu0 = rng.uniform(-0.2, 1.0, (NY, NX)).astype(np.float32)
    qc = (1e-3 * rng.uniform(0, 1, shp) * (rng.uniform(size=shp) > 0.6)).astype(np.float32)
    rho = rng.uniform(0.3, 1.2, shp).astype(np.float32)
    dz = rng.uniform(200.0, 600.0, shp).astype(np.float32)
    tau = (0.05 * rng.uniform(0, 1, shp)).astype(np.float32) if with_aer else None
    jp = jaux.photolysis_profile(jnp.asarray(mu0), jnp.asarray(qc), jnp.asarray(rho),
                                 jnp.asarray(dz), None if tau is None else jnp.asarray(tau))
    tp = taux.photolysis_profile(_t(mu0), _t(qc), _t(rho), _t(dz),
                                 None if tau is None else _t(tau))
    assert _rel(jp, tp.numpy()) <= TOL
