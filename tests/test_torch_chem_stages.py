"""Stages 2, 5 and 7 of the chem driver in the port against the JAX package,
both on the CPU, on the same seeded inputs: emissions with plume rise
(`plume_rise_profile`, `apply_emissions` with surface and ``elev_`` keys),
the cloud-borne phase (`cw_exchange`, `cloud_chemistry` with and without
the _cw fields) and wet scavenging (`wet_scavenging`), at 4 and 8 bins, in
cloudy, clear and raining cells; then `chem_driver` with each of the three
switches on alone and all on, for ``mosaic_4bin``, ``cbmz_mosaic_4bin``
and ``cbmz_mosaic_8bin``.

Tolerance: each stage function to 1e-5 of each field's magnitude (max |f|
over the field; float32, the same operations in the same order up to the
libraries' transcendental functions).  `chem_driver` as
`test_torch_slice4.py` holds config 4's chem call: 1e-4 of each field's
magnitude, or three times the reference's own one-ulp noise.  The
reference's own checks of these stages (`tests/test_cloudborne.py`,
`test_aqueous_wetscav.py`, `test_8bin.py`, `test_chem.py::
test_plume_rise_injects_aloft`) are mirrored on the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu.chem import aux as jaux  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import driver as jchem  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.chem import aux as taux  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import driver as tchem  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.gas import GAS_SPECIES  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as tbins  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic.thermo import (  # noqa: E402
    ppmv_to_ugkg, ugkg_to_ppmv,
)
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_slice import jax_grid_to_port  # noqa: E402
from test_torch_slice4 import _compare, _seeded_case  # noqa: E402

SHAPE = (6, 3, 4)        # (nz, ny, nx)
TOL = 1e-5
SPECIES = tuple(tbins.AER_SPECIES) + ("num",)


def _f32(a):
    return np.asarray(a, np.float32)


def _chem(nbin, seed, cw=True, gases=("so2", "h2o2", "o3", "hno3", "nh3", "h2so4",
                                      "hcl", "co")):
    """A chem dict as numpy: sparse interstitial and cloud-borne bins
    (masses 0-2 ug/kg, numbers 1e8-3e9 /kg, a third of the cells empty) and
    gases [ppmv] around polluted-air values."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in range(1, nbin + 1):
        for s in tbins.AER_SPECIES + ("water",):
            out[f"chem_{s}_a{b:02d}"] = rng.uniform(0, 2, SHAPE) * (rng.uniform(size=SHAPE) > 0.3)
        out[f"chem_num_a{b:02d}"] = rng.uniform(1e8, 3e9, SHAPE) * (rng.uniform(size=SHAPE) > 0.3)
    if cw:
        for b in range(1, nbin + 1):
            for s in tbins.AER_SPECIES:
                out[f"chem_{s}_cw{b:02d}"] = rng.uniform(0, 0.5, SHAPE) \
                    * (rng.uniform(size=SHAPE) > 0.5)
            out[f"chem_num_cw{b:02d}"] = rng.uniform(0, 5e8, SHAPE) \
                * (rng.uniform(size=SHAPE) > 0.5)
    base = {"so2": 2e-3, "h2o2": 1e-3, "o3": 0.05, "hno3": 1e-3, "nh3": 2e-3,
            "h2so4": 1e-5, "hcl": 1e-4, "co": 0.12}
    for g in gases:
        out[f"chem_{g}"] = base[g] * rng.uniform(0.2, 2.0, SHAPE)
    return {k: _f32(v) for k, v in out.items()}


def _met(seed):
    """Cloudy (qc 1e-4 to 1e-3) and clear cells, raining (qr up to 2e-3) and
    dry ones, with a cell of each kind guaranteed; t, p, rho, w."""
    rng = np.random.default_rng(seed)
    qc = rng.uniform(1e-4, 1e-3, SHAPE) * (rng.uniform(size=SHAPE) > 0.4)
    qr = rng.uniform(0, 2e-3, SHAPE) * (rng.uniform(size=SHAPE) > 0.5)
    qc[0, 0, 0], qc[0, 0, 1] = 5e-4, 0.0
    qr[0, 0, 0], qr[0, 0, 1] = 0.0, 1e-3
    return {"qc": qc, "qr": qr, "t": rng.uniform(260, 300, SHAPE),
            "p": rng.uniform(5e4, 1e5, SHAPE), "rho": rng.uniform(0.6, 1.2, SHAPE),
            "w": rng.uniform(-2.0, 3.0, SHAPE)}


def _j(d):
    return {k: jnp.asarray(_f32(v)) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(_f32(v).copy()) for k, v in d.items()}


def _assert_close(jout, tout, tol=TOL):
    assert set(jout) == set(tout)
    for k, a in jout.items():
        a = np.asarray(a, np.float64)
        b = tout[k].numpy().astype(np.float64)
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, (k, float(np.abs(a - b).max()), scale)


def test_plume_rise_profile():
    rng = np.random.default_rng(1)
    nz, ny, nx = 20, 3, 4
    dz = rng.uniform(100.0, 400.0, (nz, ny, nx))
    z_w = _f32(np.concatenate([np.zeros((1, ny, nx)), np.cumsum(dz, axis=0)]))
    heat = _f32(10.0 ** rng.uniform(-3, 3, (ny, nx)))
    heat[0, 0] = 0.01
    u = _f32(rng.uniform(0.0, 15.0, (ny, nx)))
    want = np.asarray(jaux.plume_rise_profile(jnp.asarray(heat), jnp.asarray(u),
                                              jnp.asarray(z_w)))
    got = taux.plume_rise_profile(torch.from_numpy(heat), torch.from_numpy(u),
                                  torch.from_numpy(z_w)).numpy()
    assert np.abs(want - got).max() <= TOL
    np.testing.assert_allclose(got.sum(axis=0), 1.0, rtol=1e-5)
    assert got[0, 0, 0] == 1.0                   # a negligible source stays at the surface


def test_plume_rise_injects_aloft():
    """The reference's check (test_chem.py), on the port."""
    nz = 20
    z_w = torch.broadcast_to(torch.arange(nz + 1, dtype=torch.float32).reshape(-1, 1, 1)
                             * 250.0, (nz + 1, 1, 2))
    w = taux.plume_rise_profile(torch.tensor([[500.0, 0.01]]), torch.tensor([[2.0, 2.0]]),
                                z_w).numpy()
    np.testing.assert_allclose(w.sum(axis=0), 1.0, rtol=1e-5)
    assert w[0, 0, 0] == 0.0
    assert w[:, 0, 0].argmax() > 1
    assert w[0, 0, 1] > 0.99


def _emissions(seed, ny, nx):
    """Surface fluxes of four gases and of oc/bc in bin 1, elevated so2 and
    no over a patch of columns with their heat, and a key no chem field
    takes."""
    rng = np.random.default_rng(seed)
    e = {k: rng.uniform(0.0, 1e-3, (ny, nx)) for k in ("so2", "no", "co", "nh3")}
    e["oc_a01"] = rng.uniform(0.0, 0.5, (ny, nx))
    e["bc_a01"] = rng.uniform(0.0, 0.2, (ny, nx))
    patch = rng.uniform(size=(ny, nx)) > 0.5
    e["elev_so2"] = 5e-3 * patch
    e["elev_no"] = 2e-3 * patch
    e["heat_mw"] = np.where(patch, rng.uniform(10.0, 500.0, (ny, nx)), 0.0)
    e["not_a_field"] = np.ones((ny, nx))
    return {k: _f32(v) for k, v in e.items()}


@pytest.mark.parametrize("nbin", [4, 8])
def test_apply_emissions(nbin):
    chem = _chem(nbin, 2, cw=False, gases=("so2", "co", "nh3"))
    m = _met(3)
    nz, ny, nx = SHAPE
    emis = _emissions(4, ny, nx)
    dz = _f32(np.random.default_rng(5).uniform(50.0, 500.0, SHAPE))
    z_w = _f32(np.concatenate([np.zeros((1, ny, nx)), np.cumsum(dz, axis=0)]))
    u0 = _f32(np.random.default_rng(6).uniform(0, 10, (ny, nx)))
    jw = jaux.plume_rise_profile(jnp.asarray(emis["heat_mw"]), jnp.asarray(u0),
                                 jnp.asarray(z_w))
    tw = taux.plume_rise_profile(torch.from_numpy(emis["heat_mw"]), torch.from_numpy(u0),
                                 torch.from_numpy(z_w))
    rho = _f32(m["rho"])
    jout = jaux.apply_emissions(_j(chem), _j(emis), jnp.asarray(rho[0]), jnp.asarray(dz[0]),
                                60.0, plume_w=jw, rho=jnp.asarray(rho), dz=jnp.asarray(dz))
    tchem_in = _t(chem)
    before = {k: v.clone() for k, v in tchem_in.items()}
    tout = taux.apply_emissions(tchem_in, _t(emis), torch.from_numpy(rho[0]),
                                torch.from_numpy(dz[0]), 60.0, plume_w=tw,
                                rho=torch.from_numpy(rho), dz=torch.from_numpy(dz))
    _assert_close(jout, tout)
    for k, v in before.items():                  # the caller's tensors are not touched
        assert torch.equal(tchem_in[k], v), k
    # surface keys raise the lowest layer only, elevated ones the plume's layers
    assert float((tout["chem_co"] - before["chem_co"])[1:].abs().max()) == 0.0
    assert float((tout["chem_oc_a01"] - before["chem_oc_a01"])[0].min()) >= 0.0
    aloft = (tout["chem_so2"] - before["chem_so2"])[1:]
    assert float(aloft.max()) > 0.0


@pytest.mark.parametrize("nbin", [4, 8])
def test_wet_scavenging(nbin):
    chem = _chem(nbin, 7)
    m = _met(8)
    jout = jaux.wet_scavenging(_j(chem), jnp.asarray(_f32(m["qr"])), 60.0, GAS_SPECIES,
                               nbin=nbin)
    tout = taux.wet_scavenging(_t(chem), torch.from_numpy(_f32(m["qr"])), 60.0, GAS_SPECIES,
                               nbin=nbin)
    _assert_close(jout, tout)
    dry = m["qr"] == 0.0
    for k in ("chem_so4_cw01", f"chem_num_a{nbin:02d}", "chem_hno3"):
        assert np.array_equal(tout[k].numpy()[dry], chem[k][dry]), k
    assert float(tout["chem_co"].sub(torch.from_numpy(chem["chem_co"])).abs().max()) == 0.0
    rain = (m["qr"] > 0) & (chem["chem_hno3"] > 0)
    assert (tout["chem_hno3"].numpy()[rain] < chem["chem_hno3"][rain]).all()


def _cw_args(m):
    return tuple(_f32(m[k]) for k in ("qc", "t", "p", "rho", "w"))


@pytest.mark.parametrize("nbin", [4, 8])
def test_cw_exchange(nbin):
    chem = _chem(nbin, 9)
    m = _met(10)
    args = _cw_args(m)
    jout = jaux.cw_exchange(_j(chem), *(jnp.asarray(a) for a in args), nbin)
    tout = taux.cw_exchange(_t(chem), *(torch.from_numpy(a) for a in args), nbin)
    _assert_close(jout, tout)
    clear = m["qc"] <= taux.QC_CLOUD
    for b in range(1, nbin + 1):
        for s in SPECIES:
            ki, kc = f"chem_{s}_a{b:02d}", f"chem_{s}_cw{b:02d}"
            tot0 = chem[ki].astype(np.float64) + chem[kc]
            tot1 = tout[ki].double() + tout[kc].double()
            np.testing.assert_allclose(tot1.numpy(), tot0, rtol=1e-6, atol=0)
            assert float(tout[kc].numpy()[clear].max()) == 0.0    # resuspended


@pytest.mark.parametrize("cw", [True, False])
@pytest.mark.parametrize("nbin", [4, 8])
def test_cloud_chemistry(nbin, cw):
    chem = _chem(nbin, 11, cw=cw)
    m = _met(12)
    qc, t = _f32(m["qc"]), _f32(m["t"])
    jout = jaux.cloud_chemistry(_j(chem), jnp.asarray(qc), jnp.asarray(t), nbin, 60.0)
    tout = taux.cloud_chemistry(_t(chem), torch.from_numpy(qc), torch.from_numpy(t), nbin,
                                60.0)
    _assert_close(jout, tout)
    clear = qc <= 1e-6
    assert np.array_equal(tout["chem_so2"].numpy()[clear], chem["chem_so2"][clear])
    assert float((torch.from_numpy(chem["chem_so2"]) - tout["chem_so2"]).max()) > 0.0
    # an aerosol-only package has no S(IV) to oxidise
    no_gas = {k: v for k, v in chem.items() if k not in ("chem_so2", "chem_h2o2", "chem_o3")}
    assert taux.cloud_chemistry(_t(no_gas), torch.from_numpy(qc), torch.from_numpy(t),
                                nbin, 60.0).keys() == no_gas.keys()


# ---- the reference's checks of these stages, on the port -------------------

def _uniform_state(nbin, shape=(4, 2, 2), **over):
    base = {"chem_so2": 2e-3, "chem_h2o2": 2e-3, "chem_o3": 0.05}
    for b in range(1, nbin + 1):
        for s in SPECIES:
            base[f"chem_{s}_a{b:02d}"] = 0.0
            base[f"chem_{s}_cw{b:02d}"] = 0.0
    base.update({"chem_so4_a01": 2.0, "chem_so4_a02": 1.0, "chem_nh4_a01": 0.5,
                 "chem_oc_a02": 1.0, "chem_num_a01": 2e9, "chem_num_a02": 5e8})
    base.update(over)
    return {k: torch.full(shape, v, dtype=torch.float32) for k, v in base.items()}


def _uniform_met(cloudy=True, shape=(4, 2, 2)):
    return (torch.full(shape, 5e-4 if cloudy else 0.0), torch.full(shape, 280.0),
            torch.full(shape, 8e4), torch.full(shape, 1.0), torch.full(shape, 1.0))


@pytest.mark.parametrize("nbin", [4, 8])
def test_cloud_cycle_conserves_and_ratchets(nbin):
    """test_cloudborne.py on the port: activation moves mass and conserves
    each (bin, species) total; a weaker updraft does not deactivate;
    aqueous sulfate goes to the cloud-borne bins and total sulfur closes
    over activate -> oxidise -> evaporate, leaving the aerosol grown; rain
    drains only the cloud-borne phase."""
    chem = _uniform_state(nbin)
    qc, t, p, rho, w = _uniform_met()
    act = taux.cw_exchange(chem, qc, t, p, rho, w, nbin)
    assert sum(float(act[f"chem_num_cw{b:02d}"].sum()) for b in range(1, nbin + 1)) > 0.0
    for b in range(1, nbin + 1):
        for s in SPECIES:
            ki, kc = f"chem_{s}_a{b:02d}", f"chem_{s}_cw{b:02d}"
            assert torch.equal(chem[ki] + chem[kc], act[ki] + act[kc])
    assert float(act["chem_so4_cw01"].min()) > 0.0
    again = taux.cw_exchange(act, qc, t, p, rho, 0.0 * w + 0.05, nbin)
    for b in range(1, nbin + 1):
        assert bool((again[f"chem_num_cw{b:02d}"] >= act[f"chem_num_cw{b:02d}"] - 1e-6).all())

    def s_total(c):
        s = c["chem_so2"].double().clone()
        for b in range(1, nbin + 1):
            for ph in ("a", "cw"):
                s += ugkg_to_ppmv(c[f"chem_so4_{ph}{b:02d}"].double(), tbins.MW["so4"])
        return float(s.sum())

    s0 = s_total(chem)
    oxi = taux.cloud_chemistry(act, qc, t, nbin, dt=600.0)
    assert float((act["chem_so2"] - oxi["chem_so2"]).sum()) > 1e-5
    d_cw = sum(float((oxi[f"chem_so4_cw{b:02d}"] - act[f"chem_so4_cw{b:02d}"]).sum())
               for b in range(1, nbin + 1))
    d_int = sum(float((oxi[f"chem_so4_a{b:02d}"] - act[f"chem_so4_a{b:02d}"]).sum())
                for b in range(1, nbin + 1))
    assert d_cw > 0.0 and abs(d_int) < 1e-10
    np.testing.assert_allclose(s_total(oxi), s0, rtol=1e-4)
    clear = taux.cw_exchange(oxi, torch.zeros_like(qc), t, p, rho, w, nbin)
    np.testing.assert_allclose(s_total(clear), s0, rtol=1e-4)
    for b in range(1, nbin + 1):
        for s in SPECIES:
            assert float(clear[f"chem_{s}_cw{b:02d}"].max()) == 0.0
    grown = sum(float(clear[f"chem_so4_a{b:02d}"].sum()) for b in range(1, nbin + 1))
    assert grown > sum(float(chem[f"chem_so4_a{b:02d}"].sum()) for b in range(1, nbin + 1))
    no_rain = taux.wet_scavenging(act, torch.zeros_like(qc), 60.0, (), nbin=nbin)
    rain = taux.wet_scavenging(act, torch.full_like(qc, 1e-3), 60.0, (), nbin=nbin)
    cw0 = sum(float(act[f"chem_so4_cw{b:02d}"].sum()) for b in range(1, nbin + 1))
    cw1 = sum(float(rain[f"chem_so4_cw{b:02d}"].sum()) for b in range(1, nbin + 1))
    for b in range(1, nbin + 1):
        assert torch.equal(no_rain[f"chem_so4_cw{b:02d}"], act[f"chem_so4_cw{b:02d}"])
    assert cw1 < cw0 * 0.95


@pytest.mark.parametrize("nbin", [4, 8])
def test_aqueous_budget_and_scavenging_order(nbin):
    """test_aqueous_wetscav.py on the port: consumed SO2 appears as sulfate
    in the largest bin without a cloud-borne phase, nothing outside cloud,
    the O3 path is pH-limited, below-cloud collection has its Greenfield gap
    and gases are scavenged by solubility."""
    shape = (4, 2, 2)
    top = f"{nbin:02d}"

    def chem(**over):
        base = {"chem_so2": 2e-3, "chem_h2o2": 1e-3, "chem_o3": 0.05,
                f"chem_so4_a{top}": 0.5, f"chem_no3_a{top}": 0.0, f"chem_nh4_a{top}": 0.0}
        base.update(over)
        return {k: torch.full(shape, v, dtype=torch.float32) for k, v in base.items()}

    qc, t = torch.full(shape, 5e-4), torch.full(shape, 280.0)
    c0 = chem()
    out = taux.cloud_chemistry(c0, qc, t, nbin, dt=600.0)
    d_so2 = float(c0["chem_so2"][0, 0, 0] - out["chem_so2"][0, 0, 0])
    assert d_so2 > 1e-5
    d_so4 = float(out[f"chem_so4_a{top}"][0, 0, 0] - c0[f"chem_so4_a{top}"][0, 0, 0])
    np.testing.assert_allclose(d_so4, float(ppmv_to_ugkg(torch.tensor(d_so2),
                                                         tbins.MW["so4"])), rtol=1e-4)
    assert all(float(v.min()) >= 0.0 for v in out.values())
    still = taux.cloud_chemistry(c0, torch.zeros(shape), t, nbin, 600.0)
    assert torch.equal(still["chem_so2"], c0["chem_so2"])
    acid = chem(chem_h2o2=0.0, **{f"chem_so4_a{top}": 20.0})
    neut = chem(chem_h2o2=0.0, **{f"chem_so4_a{top}": 0.05, f"chem_nh4_a{top}": 5.0})
    d_acid = float((acid["chem_so2"] - taux.cloud_chemistry(acid, qc, t, nbin, 600.0)
                    ["chem_so2"])[0, 0, 0])
    d_neut = float((neut["chem_so2"] - taux.cloud_chemistry(neut, qc, t, nbin, 600.0)
                    ["chem_so2"])[0, 0, 0])
    assert d_neut > 5.0 * max(d_acid, 1e-12)

    effs = [taux._collection_efficiency(d) for d in tbins.make_bins(nbin).d_center]
    i_min = int(np.argmin(effs))
    assert 0 < i_min < nbin - 1
    aer = {f"chem_so4_a{b:02d}": torch.ones(shape) for b in range(1, nbin + 1)}
    rem = taux.wet_scavenging(aer, torch.full(shape, 1e-3), 600.0, (), nbin=nbin)
    rem = [float(rem[f"chem_so4_a{b:02d}"][0, 0, 0]) for b in range(1, nbin + 1)]
    assert rem[i_min] == max(rem) and rem[-1] < rem[i_min]
    assert all(0.0 <= r <= 1.0 for r in rem)
    gas = {k: torch.ones(shape) for k in ("chem_hno3", "chem_so2", "chem_co")}
    g = taux.wet_scavenging(gas, torch.full(shape, 1e-3), 600.0, ("hno3", "so2", "co"),
                            nbin=nbin)
    assert float(g["chem_hno3"][0, 0, 0]) < float(g["chem_so2"][0, 0, 0]) \
        < float(g["chem_co"][0, 0, 0]) == 1.0


# ---- the chem driver with each new switch ----------------------------------

SWITCHES = {"emiss": ("emiss_opt",), "cldchem": ("cldchem_onoff",),
            "wetscav": ("wetscav_onoff",),
            "all": ("emiss_opt", "cldchem_onoff", "wetscav_onoff")}


def _driver_case(package, switch):
    """Config 4 at 16x4x12 (test_torch_slice4.py's seeded case) with
    `package` and the switches on; seeded cloud water, rain, cloud-borne
    fields and aerosol optics; the emissions of `_emissions`."""
    jc, tc, jg, js = _seeded_case()
    over = {"chem_opt": package, **{k: True for k in SWITCHES[switch]}}
    jc = jc.replace(chem=dataclasses.replace(jc.chem, **{
        k: (type(jc.chem.chem_opt)(v) if k == "chem_opt" else v) for k, v in over.items()}))
    tc = tc.replace(chem=dataclasses.replace(tc.chem, **{
        k: (type(tc.chem.chem_opt)(v) if k == "chem_opt" else v) for k, v in over.items()}))
    from wrfchem_arc_interactions_tpu.registry.fields import chem_species
    names = {f"chem_{n}" for n in chem_species(jc.chem)}
    nbin = 8 if "8bin" in package else 4
    rng = np.random.default_rng(13)
    shp = js["t"].shape
    js = {k: v for k, v in js.items() if not k.startswith("chem_") or k in names}
    for k in names - set(js):
        js[k] = np.zeros(shp, np.float32)
    for b in range(1, nbin + 1):
        if f"chem_num_cw{b:02d}" in names:
            js[f"chem_so4_cw{b:02d}"] = _f32(rng.uniform(0, 0.5, shp))
            js[f"chem_num_cw{b:02d}"] = _f32(rng.uniform(0, 5e8, shp))
    js["qc"] = _f32(1e-3 * rng.uniform(0, 1, shp) * (rng.uniform(size=shp) > 0.6))
    js["qr"] = _f32(1e-3 * rng.uniform(0, 1, shp) * (rng.uniform(size=shp) > 0.6))
    js["w"] = _f32(rng.uniform(-1.0, 2.0, js["w"].shape))
    js["tau_aer_sw"] = _f32(0.02 * rng.uniform(0, 1, js["tau_aer_sw"].shape))
    js["ssa_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.9)
    js["asy_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.65)
    emis = _emissions(14, shp[1], shp[2])
    return jc, tc, jg, js, emis


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("package", ["mosaic_4bin", "cbmz_mosaic_4bin", "cbmz_mosaic_8bin"])
def test_chem_driver_new_stages(package, switch):
    jc, tc, jg, js, emis = _driver_case(package, switch)
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    te = state_from_numpy(emis, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    je = {k: jnp.asarray(v) for k, v in emis.items()}
    hx = JHalo(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y)
    t_s, jd = np.float32(43200.0), np.float32(172.5)
    jout = jchem.chem_driver(jsj, jg, jc, hx, 60.0, time_s=t_s, emissions=je, julian_day=jd)
    jout_ulp = jchem.chem_driver(dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23)),
                                 jg, jc, hx, 60.0, time_s=t_s, emissions=je, julian_day=jd)
    tout = tchem.chem_driver(ts, tg, tc, 60.0, time_s=t_s, emissions=te, julian_day=jd)
    assert set(jout) == set(tout)
    _compare(jout, jout_ulp, tout, float(np.abs(np.asarray(jg.phb)).max()))
    moved = {k for k in tout if k.startswith("chem_")
             and not torch.equal(tout[k], ts[k])}
    if "emiss_opt" in SWITCHES[switch]:
        assert "chem_nh3" in moved and "chem_oc_a01" in moved
    if "cldchem_onoff" in SWITCHES[switch]:
        assert "chem_num_cw01" in moved
    for k in te:                                   # the caller's emissions stay
        assert torch.equal(te[k], torch.from_numpy(emis[k]))
