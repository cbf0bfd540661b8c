"""The port's aerosol optics and config-3 chemistry against the JAX
package, on identical seeded inputs (both on the CPU): the Mie tables,
species arrays and bins (exact), the plain version of the Mie kernel
against the reference's band scan (|d ln Q|, |d g| <= 1e-4) and against
the Pallas kernel run in interpret mode (<= 3.2e-4, the bound of
artifacts/PALLAS_MIE_AB.json), `aerosol_optics` (tau to 1e-4 of its
magnitude, ssa and asy to 1e-4 absolute), dry deposition on both of its
paths (1e-6 relative) and the chem driver on config 3's switches.  On the
CUDA card, the Mie kernel against its plain version (skipped without one).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import aux as jaux  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import driver as jchem  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import gas as jgas  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import mie as jmie  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import optics as jopt  # noqa: E402
from wrfchem_arc_interactions_tpu.chem.mosaic import bins as jbins  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.ops.pallas_mie import cheb_eval_pallas  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import aux as taux  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import driver as tchem  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import mie as tmie  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import optics as topt  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem.mosaic import bins as tbins  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import mie_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.physics.radiation import bands as tbands  # noqa: E402

from test_torch_slice import _cfg3, jax_grid_to_port, seed_chem  # noqa: E402

SHP = (4, 3, 5)


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _abs(ref, out):
    return float(np.abs(np.asarray(ref, np.float64) - np.asarray(out, np.float64)).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _mie_inputs(seed, nband=7, n=200):
    """Seeded normalised inputs with the edges of both axes included:
    nr_n and u at exactly 0 and 1 (the top node), t at -1 and 1."""
    rng = np.random.default_rng(seed)
    nr_n = rng.uniform(0, 1, (nband, n))
    u = rng.uniform(0, 1, (nband, n))
    t = rng.uniform(-1, 1, (nband, n))
    edges = np.array([0.0, 1.0])
    nr_n[:, :4] = np.repeat(edges, 2)
    u[:, :4] = np.tile(edges, 2)
    t[:, :2] = (-1.0, 1.0)
    u[:, 4:20] = 0.0            # ni clipped at 1e-9: common on the main path
    return tuple(a.astype(np.float32) for a in (nr_n, u, t))


def test_tables_bins_and_species_exact():
    np.testing.assert_array_equal(jmie.build_grid_matrix(), tmie.build_grid_matrix())
    assert tmie.build_grid_matrix().shape == (90, 80)
    # the kernel reads the matrix row-major
    G = mie_kernel.grid_matrix(torch.device("cpu"))
    assert G.is_contiguous() and torch.equal(G, torch.from_numpy(tmie.build_grid_matrix()))
    ja, tb = jmie.build_cheb_tables(), tmie.build_cheb_tables()
    for name in ("coef_qext", "coef_qsca", "coef_g"):
        np.testing.assert_array_equal(getattr(ja, name), getattr(tb, name))
    assert (ja.lnx_min, ja.lnx_max) == (tb.lnx_min, tb.lnx_max)
    np.testing.assert_array_equal(jmie.NR_GRID, tmie.NR_GRID)
    np.testing.assert_array_equal(jmie.NI_GRID, tmie.NI_GRID)
    all_um = np.concatenate([tbands.band_centers_sw_um(), tbands.band_centers_lw_um()])
    js, ts = jbins.species_arrays(all_um), tbins.species_arrays(all_um)
    assert js["names"] == ts["names"]
    for name in ("density", "kappa", "nr", "ni"):
        np.testing.assert_array_equal(js[name], ts[name], err_msg=name)
    for nbin in (4, 8):
        jb, tb_ = jbins.make_bins(nbin), tbins.make_bins(nbin)
        for name in ("d_lo", "d_hi", "d_center"):
            np.testing.assert_array_equal(getattr(jb, name), getattr(tb_, name))
    assert jbins.AER_SPECIES == tbins.AER_SPECIES and jbins.DENSITY == tbins.DENSITY
    assert jgas.GAS_SPECIES == taux.GAS_SPECIES


def test_mie_plain_matches_band_scan():
    nr_n, u, t = _mie_inputs(1)
    G = jmie.build_grid_matrix()
    want = jopt._cheb_eval_bands(G, jnp.asarray(nr_n), jnp.asarray(u), jnp.asarray(t))
    got = topt._cheb_eval_bands(G, _t(nr_n), _t(u), _t(t))
    for name, w, g in zip(("ln_qext", "ln_qsca", "g"), want, got):
        assert _abs(w, g) <= 1e-4, (name, _abs(w, g))
    # the wrapper takes the plain version for CPU tensors and counts nothing
    n0 = mie_kernel.cheb_eval.launches
    wrapped = mie_kernel.cheb_eval(_t(nr_n), _t(u), _t(t))
    assert mie_kernel.cheb_eval.launches == n0
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


def test_mie_plain_matches_pallas_interpret():
    """Against the TPU kernel itself (interpret mode, 2 tiles)."""
    nr_n, u, t = _mie_inputs(2, nband=5, n=2000)
    want = cheb_eval_pallas(jnp.asarray(nr_n), jnp.asarray(u), jnp.asarray(t),
                            interpret=True)
    got = mie_kernel.cheb_eval_reference(_t(nr_n), _t(u), _t(t))
    for name, w, g in zip(("ln_qext", "ln_qsca", "g"), want, got):
        assert _abs(w, g) <= 3.2e-4, (name, _abs(w, g))


def test_mie_packed_table_layout():
    """The kernel's packed corner table: for floor cell (ja, jb) and row r,
    entry [9 ja + jb, r] is G's four corner columns in the order of the
    weights w00, w01, w10, w11, and each cell is padded with zeros to the
    count of float4s asked for (the kernel library's, which
    test_torch_emulated checks); fewer than G's 90 rows are refused."""
    G = tmie.build_grid_matrix()
    for stride in (90, 91, 95):
        table = mie_kernel.packed_table(torch.device("cpu"), stride).numpy()
        assert table.shape == (63, stride, 4) and table.dtype == np.float32
        for ja in range(7):
            for jb in range(9):
                c = 10 * ja + jb
                np.testing.assert_array_equal(table[9 * ja + jb, :90],
                                              G[:, [c, c + 1, c + 10, c + 11]])
        assert not table[:, 90:].any()
    with pytest.raises(ValueError, match="cell_stride"):
        mie_kernel.packed_table(torch.device("cpu"), 89)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "rank", "type"])
def test_mie_wrapper_rejects_bad_inputs(bad):
    nr_n, u, t = (_t(a) for a in _mie_inputs(3, nband=3, n=8))
    if bad == "dtype":
        u = u.double()
    elif bad == "shape":
        u = u[:, 1:].contiguous()
    elif bad == "contiguous":
        nr_n = nr_n.t().contiguous().t()
    elif bad == "rank":
        nr_n, u, t = nr_n[0, 0], u[0, 0], t[0, 0]
    elif bad == "type":
        t = t.numpy()
    with pytest.raises((TypeError, ValueError)):
        mie_kernel.cheb_eval(nr_n, u, t)


def _chem_fields(seed, nbin=4):
    """Seeded MOSAIC bin contents (ug/kg masses, #/kg numbers); bin 4 is
    empty, as in an unseeded run."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in range(1, nbin + 1):
        scale = 0.0 if b == nbin else 1.0
        for s in tbins.AER_SPECIES + ("water",):
            out[f"chem_{s}_a{b:02d}"] = scale * rng.uniform(0.0, 3.0, SHP)
        out[f"chem_num_a{b:02d}"] = scale * 10.0 ** rng.uniform(7.0, 10.0, SHP)
    for g in ("h2so4", "hno3", "nh3", "hcl", "o3"):
        out[f"chem_{g}"] = rng.uniform(0.0, 1e-3, SHP)
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_aerosol_optics():
    chem = _chem_fields(4)
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.4, 1.2, SHP).astype(np.float32)
    dz = rng.uniform(200.0, 600.0, SHP).astype(np.float32)
    j = jopt.aerosol_optics({k: jnp.asarray(v) for k, v in chem.items()},
                            jnp.asarray(rho), jnp.asarray(dz), 4)
    o = topt.aerosol_optics({k: _t(v) for k, v in chem.items()}, _t(rho), _t(dz), 4)
    assert set(j) == set(o)
    assert float(np.asarray(j["tau_aer_sw"]).min()) > 0.0
    assert _rel(j["tau_aer_sw"], o["tau_aer_sw"]) <= 1e-4
    assert _rel(j["tau_aer_lw"], o["tau_aer_lw"]) <= 1e-4
    for name in ("ssa_aer_sw", "asy_aer_sw"):
        assert _abs(j[name], o[name]) <= 1e-4, name


@pytest.mark.parametrize("with_ust", [False, True])
def test_dry_deposition(with_ust):
    chem = _chem_fields(6)
    rng = np.random.default_rng(7)
    dz0 = rng.uniform(0.5, 80.0, SHP[1:]).astype(np.float32)
    ust = rng.uniform(0.0, 0.8, SHP[1:]).astype(np.float32) if with_ust else None
    j = jaux.dry_deposition({k: jnp.asarray(v) for k, v in chem.items()},
                            jnp.asarray(dz0), 600.0, jgas.GAS_SPECIES,
                            ust=None if ust is None else jnp.asarray(ust))
    o = taux.dry_deposition({k: _t(v) for k, v in chem.items()}, _t(dz0), 600.0,
                            taux.GAS_SPECIES, ust=None if ust is None else _t(ust))
    assert set(j) == set(o)
    for name in j:
        assert _rel(j[name], o[name]) <= 1e-6, name
    assert float(np.asarray(j["chem_so4_a01"])[0].max()) < float(chem["chem_so4_a01"][0].max())


def test_chem_driver_config3():
    """One chem call on the seeded squall-line state of config 3."""
    jc, tc = _cfg3(jcfg), _cfg3(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    js = {k: np.asarray(v) for k, v in js.items()}
    js["chem_water_a01"] = np.full(js["t"].shape, 0.5, np.float32)
    jout = jchem.chem_driver({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                             JHalo(), 600.0)
    tout = tchem.chem_driver({k: _t(v) for k, v in js.items()}, jax_grid_to_port(jg),
                             tc, 600.0)
    assert set(jout) == set(tout)
    for name in jout:
        if name in ("ssa_aer_sw", "asy_aer_sw"):
            assert _abs(jout[name], tout[name]) <= 1e-4, name
        else:
            assert _rel(jout[name], tout[name]) <= 1e-4, name
    assert float(np.asarray(jout["tau_aer_sw"]).max()) > 0.0


@pytest.mark.cuda
def test_mie_kernel_matches_plain_on_gpu():
    """The CUDA kernel against its plain version on the card, edges
    included; |d ln Q|, |d g| <= 3.2e-4 (the coefficient sums differ from
    the plain matrix product in order, and the kernel fuses multiply-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    nr_n, u, t = (_t(a).to(dev) for a in _mie_inputs(8, nband=30, n=5000))
    n0 = mie_kernel.cheb_eval.launches
    got = mie_kernel.cheb_eval(nr_n, u, t)
    want = mie_kernel.cheb_eval_reference(nr_n, u, t)
    torch.cuda.synchronize()
    assert mie_kernel.cheb_eval.launches == n0 + 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 3.2e-4
