"""The port's MOSAIC aerosol dynamics against the JAX package on identical
seeded inputs (both on the CPU): the coagulation pair tables (exact), the
electrolyte ladder, the mutual deliquescence RH, the phase state, water
uptake, the uptake coefficients, `thermo.partition` (with the ASTEM
sub-steps), `nucleation.nucleate`, `coag.coagulate` and `movesect.remap`.
Every field is held to 1e-4 of its magnitude; the phase flags (0 or 1)
must be equal.
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
