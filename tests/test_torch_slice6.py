"""Slice 6's path of the port against the JAX package, both on the CPU:
`Simulation` on bench.py's ``--config4-8bin`` values (`_cfg4` with
``cbmz_mosaic_8bin``) with the three stages this slice brings switched on
(emissions with plume rise, the cloud-borne phase with aqueous chemistry,
wet scavenging), at 16x4x12 with bench.py's aerosol and gas seed and
seeded constant emissions, from noon UTC, chem and rad alarms every 2
steps, 4 steps.

Tolerance as `test_torch_slice4.py` holds config 4: every field to 1e-4 of
its magnitude, or three times the reference's own float32 noise (the
reference run again from theta changed by one ulp) where that is larger.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    advected_names, state_from_numpy,
)

from test_torch_slice import jax_grid_to_port, seed_chem  # noqa: E402
from test_torch_slice4 import GAS_SEED, _cfg4, _compare  # noqa: E402


def _cfg6(m):
    """bench.py's --config4-8bin at 16x4x12 from noon with emissions, the
    cloud-borne phase and wet scavenging on."""
    c = _cfg4(m)
    return c.replace(chem=dataclasses.replace(
        c.chem, chem_opt=m.namelist.ChemOpt.CBMZ_MOSAIC_8BIN, emiss_opt=True,
        cldchem_onoff=True, wetscav_onoff=True))


def emissions(ny, nx, seed=21):
    """Constant emissions of a regional air-quality run: surface fluxes of
    so2, no, co and nh3 [ppmv/s * m] and of oc and bc in bin 1 [ug/m2/s];
    elevated so2 and no with the heat of a large fire [MW] over a patch of
    columns, which plume rise lifts above the lowest layer."""
    rng = np.random.default_rng(seed)
    e = {"so2": 2e-4, "no": 5e-4, "co": 2e-3, "nh3": 3e-4, "oc_a01": 0.05,
         "bc_a01": 0.02}
    out = {k: v * rng.uniform(0.5, 1.5, (ny, nx)) for k, v in e.items()}
    patch = np.zeros((ny, nx), bool)
    patch[ny // 4: ny // 4 + max(1, ny // 4), nx // 4: nx // 4 + max(1, nx // 8)] = True
    out["elev_so2"] = np.where(patch, 5e-3, 0.0)
    out["elev_no"] = np.where(patch, 2e-3, 0.0)
    out["heat_mw"] = np.where(patch, 2000.0, 0.0)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _case():
    jc, tc = _cfg6(jcfg), _cfg6(tcfg)
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    for s, v in GAS_SEED:
        js[f"chem_{s}"] = np.full(js["t"].shape, v, np.float32)
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    return jc, tc, jg, js, emissions(*js["t"].shape[1:])


def test_slice6_tables():
    jc, tc, jg, js, _ = _case()
    names = advected_names(tc)
    # 12 moist + 80 interstitial + 72 cloud-borne + 55 gases
    assert len(names) == 219 and len(set(names)) == 219
    assert [k for k in js if k in names] == list(names)      # the reference's table order
    assert len([k for k in names if "_cw" in k]) == 72


def test_slice6_simulation_matches_jax():
    jc, tc, jg, js, emis = _case()
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy(js, "cpu")
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    je = {k: jnp.asarray(v) for k, v in emis.items()}
    js_ulp = dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23))
    jsim, jsim_ulp = JSim(jc, jg, jsj, emissions=je), JSim(jc, jg, js_ulp, emissions=je)
    tsim = TSim(tc, tg, ts, device="cpu", emissions=state_from_numpy(emis, "cpu"))
    assert tsim.chem_every == tsim.rad_every == 2
    for sim in (jsim, jsim_ulp, tsim):
        sim.advance(4)
    assert set(jsim.state) == set(tsim.state)
    _compare(jsim.state, jsim_ulp.state, tsim.state, float(np.abs(np.asarray(jg.phb)).max()))
    s = tsim.state
    assert float(s["swdown"].min()) > 100.0
    assert all(float(v.min()) >= 0.0 for k, v in s.items() if k.startswith("chem_"))
    assert float(s["chem_nh3"].max()) > 0.0                    # emitted, not seeded
    assert float(s["tau_aer_sw"].max()) > 0.0

