"""The port's MOSAIC aerosol dynamics against the JAX package on identical
seeded inputs (both on the CPU): the coagulation pair tables (exact), the
electrolyte ladder, the mutual deliquescence RH, the phase state, water
uptake, the uptake coefficients, `thermo.partition` (with the ASTEM
sub-steps), `nucleation.nucleate`, `coag.coagulate` and `movesect.remap`.
Every field is held to 1e-4 of its magnitude; the phase flags (0 or 1)
must be equal.  Then the reference's MESA electrolyte tests
(tests/test_mesa_electrolytes.py) on the port, with their inputs and
assertions: the ladder's ion conservation and precedence, the mutual DRH,
and the phase transitions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu.chem.mosaic import bins as jbins  # noqa: E402
from wrfchem_arc_interactions_tpu.chem.mosaic import coag as jcoag  # noqa: E402
from wrfchem_arc_interactions_tpu.chem.mosaic import movesect as jmove  # noqa: E402
from wrfchem_arc_interactions_tpu.chem.mosaic import nucleation as jnuc  # noqa: E402
from wrfchem_arc_interactions_tpu.chem.mosaic import thermo as jthermo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as tbins  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import coag as tcoag  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import movesect as tmove  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import nucleation as tnuc  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import thermo as tthermo  # noqa: E402

SHP = (5, 3, 7)
NBIN = 4
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def make_chem(seed, shp=SHP, gases=("h2so4", "hno3", "nh3", "hcl")):
    """A polluted, sea-salt-bearing 4-bin aerosol with random loadings (some
    bins empty, some grown past their section) and the condensable gases."""
    rng = np.random.default_rng(seed)
    chem = {}
    for b in range(1, NBIN + 1):
        scale = [1.0, 0.5, 0.05, 0.005][b - 1]
        for s in jbins.AER_SPECIES:
            chem[f"chem_{s}_a{b:02d}"] = 0.5 * scale * rng.uniform(0.0, 2.0, shp)
        chem[f"chem_so4_a{b:02d}"] = 2.0 * scale * rng.uniform(0.2, 3.0, shp)
        chem[f"chem_water_a{b:02d}"] = scale * rng.uniform(0.0, 1.0, shp) \
            * (rng.uniform(size=shp) > 0.4)
        num = 2e9 * scale * rng.uniform(0.05, 4.0, shp)
        num[rng.uniform(size=shp) < 0.05] = 0.0          # empty bins
        chem[f"chem_num_a{b:02d}"] = num
    for g, v in zip(gases, (2e-5, 2e-3, 3e-3, 5e-4)):
        chem[f"chem_{g}"] = v * rng.uniform(0.0, 2.0, shp)
    env = {"t_air": rng.uniform(255.0, 305.0, shp), "rho": rng.uniform(0.4, 1.2, shp),
           "rh": rng.uniform(0.05, 1.0, shp)}
    return ({k: v.astype(np.float32) for k, v in chem.items()},
            {k: v.astype(np.float32) for k, v in env.items()})


def _compare(jout, tout, keys=None):
    worst = {}
    for k in (keys or jout):
        assert np.isfinite(tout[k].numpy()).all(), k
        worst[k] = _rel(jout[k], tout[k].numpy())
    bad = {k: v for k, v in worst.items() if v > TOL}
    assert not bad, bad
    return max(worst.values())


def test_tables_exact():
    assert jbins.AER_SPECIES == tbins.AER_SPECIES
    jk, jt = jcoag._pair_tables(jbins.make_bins(NBIN))
    tk, tt = tcoag._pair_tables(tbins.make_bins(NBIN))
    np.testing.assert_array_equal(jk, tk)
    np.testing.assert_array_equal(jt, tt)
    assert jthermo.ELECTROLYTE_DRH == tthermo.ELECTROLYTE_DRH
    assert jthermo.ASTEM_SUBSTEPS == tthermo.ASTEM_SUBSTEPS


@pytest.mark.parametrize("seed", [0, 1])
def test_electrolytes_phase_and_water(seed):
    chem, env = make_chem(seed)
    jc, tc = _both(chem)
    for b in (1, 3):
        je = jthermo.electrolyte_ladder(jthermo.bin_ions(jc, b))
        te = tthermo.electrolyte_ladder(tthermo.bin_ions(tc, b))
        assert list(je) == list(te)
        _compare(je, te)
        assert _rel(jthermo.mutual_drh(jc, b), tthermo.mutual_drh(tc, b).numpy()) <= TOL
    jl = jthermo.phase_state(jc, jnp.asarray(env["rh"]), NBIN)
    tl = tthermo.phase_state(tc, _t(env["rh"]), NBIN)
    for a, b in zip(jl, tl):
        # a flag may flip only where rh sits within rounding of a threshold
        assert float(np.mean(np.asarray(a) != b.numpy())) <= 0.02
    jw = jthermo.water_uptake(jc, jnp.asarray(env["rh"]), NBIN)
    tw = tthermo.water_uptake(tc, _t(env["rh"]), NBIN)
    same = all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jl, tl))
    if same:
        _compare(jw, tw)
    jk, jd = jthermo.uptake_coeffs(jc, jnp.asarray(env["rho"]), NBIN, with_diameters=True)
    tk, td = tthermo.uptake_coeffs(tc, _t(env["rho"]), NBIN, with_diameters=True)
    for a, b in zip(jk + jd, tk + td):
        assert _rel(a, b.numpy()) <= TOL


@pytest.mark.parametrize("seed,dt", [(0, 60.0), (1, 600.0)])
def test_partition(seed, dt):
    chem, env = make_chem(seed)
    jc, tc = _both(chem)
    jout = jthermo.partition(jc, jnp.asarray(env["t_air"]), jnp.asarray(env["rho"]),
                             jnp.asarray(env["rh"]), NBIN, dt)
    tout = tthermo.partition(tc, _t(env["t_air"]), _t(env["rho"]), _t(env["rh"]), NBIN, dt)
    assert set(jout) == set(tout)
    jl = jthermo.phase_state(jc, jnp.asarray(env["rh"]), NBIN)
    tl = tthermo.phase_state(tc, _t(env["rh"]), NBIN)
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jl, tl))
    print("partition worst:", _compare(jout, tout))


@pytest.mark.parametrize("seed", [0, 1])
def test_nucleate_coagulate_remap(seed):
    chem, env = make_chem(seed)
    jc, tc = _both(chem)
    rho_j, rho_t = jnp.asarray(env["rho"]), _t(env["rho"])
    jn = jnuc.nucleate(jc, rho_j, jnp.asarray(env["rh"]), NBIN, 60.0)
    tn = tnuc.nucleate(tc, rho_t, _t(env["rh"]), NBIN, 60.0)
    _compare(jn, tn)
    assert float(tn["chem_num_a01"].sum()) > float(tc["chem_num_a01"].sum())
    jco = jcoag.coagulate(jc, rho_j, NBIN, 600.0)
    tco = tcoag.coagulate(tc, rho_t, NBIN, 600.0)
    _compare(jco, tco)
    jr = jmove.remap(jc, NBIN)
    tr = tmove.remap(tc, NBIN)
    moved = sum(float(np.abs(np.asarray(jr[k]) - np.asarray(jc[k])).max() > 0)
                for k in jr if "num_a" in k)
    assert moved > 0                      # some sections do change bins
    _compare(jr, tr)
    # number and so4 mass are conserved by the remap
    for s in ("num", "so4"):
        a = sum(tc[f"chem_{s}_a{b:02d}"].double().sum() for b in range(1, NBIN + 1))
        b_ = sum(tr[f"chem_{s}_a{b:02d}"].double().sum() for b in range(1, NBIN + 1))
        assert abs(float(a - b_)) <= 1e-6 * float(a)


def test_aerosol_dynamics_chain():
    """The chem driver's stage 6 in its order: nucleate -> partition ->
    coagulate -> remap."""
    chem, env = make_chem(2)
    jc, tc = _both(chem)
    j = {k: jnp.asarray(v) for k, v in env.items()}
    t = {k: _t(v) for k, v in env.items()}
    jc = jnuc.nucleate(jc, j["rho"], j["rh"], NBIN, 60.0)
    jc = jthermo.partition(jc, j["t_air"], j["rho"], j["rh"], NBIN, 60.0)
    jc = jcoag.coagulate(jc, j["rho"], NBIN, 60.0)
    jc = jmove.remap(jc, NBIN)
    tc = tnuc.nucleate(tc, t["rho"], t["rh"], NBIN, 60.0)
    tc = tthermo.partition(tc, t["t_air"], t["rho"], t["rh"], NBIN, 60.0)
    tc = tcoag.coagulate(tc, t["rho"], NBIN, 60.0)
    tc = tmove.remap(tc, NBIN)
    print("stage 6 worst:", _compare(jc, tc))


# -- the reference's MESA electrolyte tests (tests/test_mesa_electrolytes.py) on
# the port: the same inputs and assertions

# electrolyte -> ion stoichiometry, for the conservation check
STOICH = {
    "caso4": {"ca": 1, "so4": 1}, "caco3": {"ca": 1, "co3": 1},
    "na2so4": {"na": 2, "so4": 1}, "nh42so4": {"nh4": 2, "so4": 1},
    "nh4hso4": {"nh4": 1, "so4": 1}, "h2so4": {"so4": 1},
    "cano32": {"ca": 1, "no3": 2}, "nano3": {"na": 1, "no3": 1},
    "nacl": {"na": 1, "cl": 1}, "nh4no3": {"nh4": 1, "no3": 1},
    "nh4cl": {"nh4": 1, "cl": 1},
    "_residual_na": {"na": 1}, "_residual_co3": {"co3": 1},
    "_residual_nh4": {"nh4": 1}, "_residual_no3": {"no3": 1},
    "_residual_cl": {"cl": 1}, "_residual_ca": {"ca": 1},
}
IONS = ("so4", "no3", "nh4", "na", "cl", "ca", "co3")


def test_ladder_conserves_every_ion():
    rng = np.random.default_rng(3)
    ions = {k: _t(rng.uniform(0.0, 2.0, 64)) for k in IONS}
    e = tthermo.electrolyte_ladder(ions)
    for ion in ions:
        back = sum(st[ion] * e[name].numpy() for name, st in STOICH.items() if ion in st)
        np.testing.assert_allclose(back, ions[ion].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=ion)
    for name, v in e.items():
        assert (v.numpy() >= -1e-9).all(), name


def _ladder(**amounts):
    return tthermo.electrolyte_ladder({k: torch.full((1,), float(amounts.get(k, 0.0)))
                                       for k in IONS})


def test_ladder_precedence():
    """Ca binds sulfate before Na; Na binds sulfate before nitrate; the
    sulfate-rich regime makes bisulfate, then free acid."""
    # sea salt and sulfate: Na2SO4 forms first, the leftover Na takes Cl
    e = _ladder(so4=1, na=4, cl=2)
    assert float(e["na2so4"][0]) == 1.0
    assert float(e["nacl"][0]) == 2.0
    # sulfate-rich, ammonium-poor: bisulfate and free sulfuric acid
    e = _ladder(so4=3, nh4=1)
    assert float(e["nh42so4"][0]) == 0.5
    assert float(e["nh4hso4"][0]) == 0.0
    assert float(e["h2so4"][0]) == 2.5
    # dust: CaSO4 before CaCO3 before Ca(NO3)2
    e = _ladder(so4=0.5, no3=2, ca=2, co3=1)
    assert float(e["caso4"][0]) == 0.5
    assert float(e["caco3"][0]) == 1.0
    assert float(e["cano32"][0]) == 0.5


def _bin_chem(comp, shp=(8,)):
    return {f"chem_{s}_a01": torch.full(shp, float(comp.get(s, 0.0)))
            for s in list(tbins.AER_SPECIES) + ["water"]}


def test_mutual_drh_mixture_below_pure():
    """The eutonic behaviour: an AS+AN mixed bin deliquesces below both
    pure salts' DRH; pure bins keep the laboratory values."""
    d_as = float(tthermo.mutual_drh(_bin_chem({"so4": 96.0, "nh4": 36.0}), 1)[0])
    d_an = float(tthermo.mutual_drh(_bin_chem({"no3": 62.0, "nh4": 18.0}), 1)[0])
    d_mix = float(tthermo.mutual_drh(_bin_chem({"so4": 48.0, "no3": 31.0, "nh4": 27.0}),
                                     1)[0])
    assert 0.76 < d_as < 0.84, d_as
    assert 0.58 < d_an < 0.66, d_an
    assert d_mix < min(d_as, d_an), (d_mix, d_as, d_an)
    assert d_mix > 0.4


def test_insoluble_bin_never_deliquesces():
    dust = _bin_chem({"bc": 5.0})
    assert float(tthermo.mutual_drh(dust, 1)[0]) > 1.0
    flags = tthermo.phase_state(dust, torch.full((8,), 0.99), 1)
    assert float(flags[0].max()) == 0.0


def test_seasalt_sulfate_bin_phase_transition():
    """A sea-salt bin with sulfate: solid at RH 0.3, liquid at RH 0.9, and
    between them the hysteresis branch its history picks."""
    chem = _bin_chem({"na": 23.0, "cl": 35.45, "so4": 9.6})
    lo = tthermo.phase_state(chem, torch.full((8,), 0.30), 1)[0]
    hi = tthermo.phase_state(chem, torch.full((8,), 0.90), 1)[0]
    assert float(lo.max()) == 0.0
    assert float(hi.min()) == 1.0
    # mid-range: a dry history stays solid, a wet one stays liquid
    mid_dry = tthermo.phase_state(chem, torch.full((8,), 0.55), 1)[0]
    chem_wet = dict(chem, chem_water_a01=torch.full((8,), 10.0))
    mid_wet = tthermo.phase_state(chem_wet, torch.full((8,), 0.55), 1)[0]
    assert float(mid_dry.max()) == 0.0
    assert float(mid_wet.min()) == 1.0
