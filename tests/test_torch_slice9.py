"""Slice 9's path on the CPU: a real-data case — the synthetic analysis
through `real_init` on a Lambert grid over a 1,000 m ridge, specified
lateral boundaries from the boundary segments, a segment swap — the port
against the JAX package; then config 4's physics and chemistry (Morrison
with progn, RRTMG, cbmz_mosaic_4bin with aer_ra_feedback, bench.py's seed)
on a small real case from noon, on the port.

The comparison holds each field to 1e-4 of its magnitude (phi at that of
phb), or three times the run's own float32 noise where that is larger, as
tests/test_torch_slice.py does; the noise is measured on the port (its run
again from the full theta changed by one ulp).  The spec-zone ring after a
step is the boundary target at the step's start bit for bit, as
`SpecifiedBC.apply` sets it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu.grid import projection as jproj  # noqa: E402
from wrfchem_arc_interactions_tpu.models import real as jreal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.config import namelist as tnl  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import projection as tproj  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import real as treal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.lateral_bc import LateralBoundary  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402

from test_torch_real import real_cfgs  # noqa: E402
from test_torch_slice import jax_grid_to_port  # noqa: E402
from test_torch_slice4 import GAS_SEED  # noqa: E402

FORCED = ("u", "v", "w", "t", "mu", "ph", "qv")


def _port_segment(seg):
    return LateralBoundary(lo={k: torch.from_numpy(np.array(v)) for k, v in seg.lo.items()},
                           hi={k: torch.from_numpy(np.array(v)) for k, v in seg.hi.items()},
                           t_lo=float(seg.t_lo), t_hi=float(seg.t_hi))


def _ring_is_target(sim, seg):
    """After a step, each forced field's outer ring equals the segment's
    target at the step's start."""
    tgt = seg.at_time(np.float32(sim.time_s - sim.dt))
    for k in FORCED:
        a, b = sim.state[k], tgt[k]
        for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
            assert torch.equal(a[sl], b[sl]), k


def test_real_case_through_segment_swap_matches_jax():
    """32x24x16 at dx 12 km, dt 60 s, Lambert at 40N over a 1,000 m ridge,
    p_top 100 hPa: analyses at 0, 180 and 360 s give two segments; three
    steps on the first, the swap, two on the second."""
    jc, tc = real_cfgs(nx=32, ny=24, nz=16)
    times = [0.0, 180.0, 360.0]
    snaps = jreal.synthetic_analysis(jc, times, terrain_amp=1000.0, advect_speed=40.0)
    jg, js, jsegs = jreal.real_init(jc, snaps, projection=jproj.Projection(kind="lambert",
                                                                            ref_lat=40.0))
    tg = jax_grid_to_port(jg)
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.items()}, "cpu")
    tsegs = [_port_segment(s) for s in jsegs]
    assert tg.has_terrain and tg.curvature and len(tsegs) == 2
    ts_ulp = dict(ts, t=(ts["t"] + 300.0) * (1.0 + 2.0 ** -23) - 300.0)
    jsim = JSim(jc, jg, js, boundary=jsegs[0])
    tsims = [TSim(tc, tg, s, boundary=tsegs[0], device="cpu") for s in (ts, ts_ulp)]
    for sim in (jsim, *tsims):
        sim.advance(3)
    _ring_is_target(tsims[0], tsegs[0])
    jsim.boundary = jsegs[1]
    for sim in tsims:
        sim.boundary = tsegs[1]
    for sim in (jsim, *tsims):
        sim.advance(2)
    _ring_is_target(tsims[0], tsegs[1])
    phb = float(np.abs(np.asarray(jg.phb)).max())
    for k, a in jsim.state.items():
        a = np.asarray(a, np.float64)
        b = tsims[0].state[k]
        assert torch.isfinite(b).all(), k
        scale = phb if k == "ph" else max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(b.numpy() - a).max()) / scale
        noise = float((tsims[1].state[k] - b).abs().max()) / scale
        assert err <= max(1e-4, 3.0 * noise), (k, err, noise)
    assert float(tsims[0].state["w"].abs().max()) > 1e-2


def _cfg9(nx=16, ny=16, nz=10):
    """Slice 9's configuration at a small size: config 4's physics and
    chemistry on the real-data domain, from noon, both alarms every step."""
    _, tc = real_cfgs(nx=nx, ny=ny, nz=nz)
    return tc.replace(
        time_control=dataclasses.replace(tc.time_control, start_date="2000-06-20_12:00:00"),
        physics=dataclasses.replace(tc.physics, mp_physics=tnl.MPScheme.MORRISON2, progn=True,
                                    ra_sw_physics=tnl.RAScheme.RRTMG,
                                    ra_lw_physics=tnl.RAScheme.RRTMG, radt_s=60.0),
        chem=dataclasses.replace(tc.chem, chem_opt=tnl.ChemOpt.CBMZ_MOSAIC_4BIN,
                                 chemdt_s=60.0, aer_ra_feedback=True))


def test_config4_physics_on_real_case_runs():
    """Three steps of config 4's physics and chemistry on a 16x16x10 real
    case (Lambert, 1,000 m ridge, specified boundaries): finite fields, no
    negative moist or chem field, sunlight and aerosol optics on the
    projection's latitudes, the spec ring at the target."""
    cfg = _cfg9()
    snaps = treal.synthetic_analysis(cfg, [0.0, 3600.0], terrain_amp=1000.0)
    grid, state, segs = treal.real_init(cfg, snaps, device="cpu",
                                        projection=tproj.Projection(kind="lambert",
                                                                    ref_lat=40.0))
    for b in (1, 2):
        state[f"chem_so4_a{b:02d}"] = torch.full_like(state["t"], 2.0)
        state[f"chem_oc_a{b:02d}"] = torch.full_like(state["t"], 1.0)
        state[f"chem_num_a{b:02d}"] = torch.full_like(state["t"], 2e9)
    for s, v in GAS_SEED:
        state[f"chem_{s}"] = torch.full_like(state["t"], v)
    sim = TSim(cfg, grid, state, boundary=segs[0], device="cpu")
    assert sim.rad_every == sim.chem_every == 1
    sim.advance(3)
    s = sim.state
    for k, v in s.items():
        assert torch.isfinite(v).all(), k
    neg = [k for k in (*cfg.moist_species(), *(k for k in s if k.startswith("chem_")))
           if float(s[k].min()) < 0.0]
    assert not neg, neg
    assert float(s["swdown"].max()) > 100.0 and float(s["tau_aer_sw"].min()) > 0.0
    assert float(grid.xlat.max() - grid.xlat.min()) > 1.0
    _ring_is_target(sim, segs[0])
    assert float(s["w"].abs().max()) < 5.0
