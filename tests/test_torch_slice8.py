"""Slice 8's path, the run infrastructure of `Simulation`, on the CPU:
restart bit-exactness (2N steps against N + `write_restart` /
`read_restart` + N, the reference's core regression invariant) in both
containers on the reference's warm bubble and on a small config 4; the
output alarms, the history files and the tslist series against the JAX
package's on the same inputs; the hourly emission stream against the
constant-emissions path; the NaN and CFL guards; and the registry's
restart/history sets.

Tolerance of the port against the reference, as `test_torch_slice.py`
holds the dycore: every history field and ts column to 1e-4 of its
magnitude (phi at the magnitude of phb), or three times the reference's
own float32 noise (the reference run again from the full theta changed by
one ulp, as the perturbation theta of the bubble is zero outside it) where
that is larger.  Restart and the stream path are held bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.io import history as jhio  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.models.driver import Simulation as JSim  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402
from wrfchem_arc_interactions_tpu.registry import state as jreg  # noqa: E402
from wrfchem_arc_interactions_tpu.utils import checks as jchecks  # noqa: E402
from wrfchem_arc_interactions_tpu.utils import clock as jclock  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import auxinput as taux  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.io import history as thio  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation as TSim  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry import state as treg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import state_from_numpy  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.utils import checks as tchecks  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.utils import clock as tclock  # noqa: E402

from test_torch_slice import _rel, jax_grid_to_port, seed_chem  # noqa: E402
from test_torch_slice4 import GAS_SEED, _cfg4  # noqa: E402

TS_POINTS = (("mid", 2, 12), ("west", 2, 2))


def _bubble_cfg(m, **tc):
    """test_io_restart.py's warm bubble (24x4x12, dt 5 s), with the output
    alarms every 25 s (5 steps) and two tslist points."""
    return m.Config(
        domain=m.DomainConfig(nx=24, ny=4, nz=12, dx=1000.0, dy=1000.0,
                              ztop=12000.0, p_top=20000.0),
        time_control=m.TimeControl(dt=5.0, history_interval_s=25.0,
                                   restart_interval_s=25.0, auxhist_interval_s=25.0,
                                   ts_points=TS_POINTS, **tc))


def _bubble():
    jc, tc = _bubble_cfg(jcfg), _bubble_cfg(tcfg)
    jg, js = jideal.make_case(jc, "warm_bubble", amplitude=2.0)
    js = {k: np.asarray(v) for k, v in js.items()}
    return jc, tc, jg, js


def _assert_states_equal(a, b, names):
    differ = [n for n in names if not torch.equal(a[n], b[n])]
    assert not differ, f"restart drift in {differ}"


def _restart_2n(cfg, grid, state, n, ext, tmp_path, **kw):
    """(unbroken run of 2n steps, run of n + restart from an `ext` file + n)."""
    sim_a = TSim(cfg, grid, state, device="cpu", **kw)
    sim_a.advance(2 * n)
    sim_b = TSim(cfg, grid, state, device="cpu", **kw)
    sim_b.advance(n)
    path = str(tmp_path / f"restart_{n:06d}{ext}")
    thio.write_restart(path, cfg, sim_b.state, sim_b.step_idx, sim_b.time_s)
    restored, step, t_s = thio.read_restart(path, cfg, state)
    assert step == n and t_s == sim_b.time_s
    sim_c = TSim(cfg, grid, restored, device="cpu", **kw)
    sim_c.step_idx, sim_c.time_s = step, t_s
    sim_c.advance(n)
    assert sim_c.time_s == sim_a.time_s
    return sim_a, sim_b, sim_c


@pytest.mark.parametrize("ext", [".nc", ".npz"])
def test_restart_bit_exact_warm_bubble(tmp_path, ext):
    jc, tc, jg, js = _bubble()
    grid, state = jax_grid_to_port(jg), state_from_numpy(js, "cpu")
    a, _, c = _restart_2n(tc, grid, state, 5, ext, tmp_path)
    names = treg.restart_names(tc)
    assert len(names) == len(state)
    _assert_states_equal(a.state, c.state, names)


def _cfg4_out(m, **tc):
    """Config 4 at 16x4x12 from noon (`test_torch_slice4._cfg4`, chem and
    rad every 2 steps) with the output alarms every 3 steps, so that a
    restart falls between two chem calls."""
    c = _cfg4(m)
    return c.replace(time_control=dataclasses.replace(
        c.time_control, history_interval_s=18.0, restart_interval_s=18.0,
        auxhist_interval_s=18.0, **tc))


def _cfg4_case(emiss_opt=False):
    tc = _cfg4_out(tcfg)
    if emiss_opt:
        tc = tc.replace(chem=dataclasses.replace(tc.chem, emiss_opt=True))
    grid, state = tideal.make_case(tc, "squall2d_x", device="cpu", bubble_amp=3.0)
    state = seed_chem(state, torch.full_like)
    for s, v in GAS_SEED:
        state[f"chem_{s}"] = torch.full_like(state["t"], v)
    return tc, grid, state


@pytest.mark.parametrize("ext", [".nc", ".npz"])
def test_restart_bit_exact_config4(tmp_path, ext):
    """Config 4 (126 restart fields): 6 steps against 3 + restart + 3, the
    restart between the chem calls of steps 2 and 4; the unbroken run
    writes its own restart files on the alarm, and the step-3 file holds
    the state the restarted run started from."""
    tc, grid, state = _cfg4_case()
    names = treg.restart_names(tc)
    assert len(names) == 126
    a, b, c = _restart_2n(tc, grid, state, 3, ext, tmp_path / "split",
                          output_dir=str(tmp_path / "alarm"))
    _assert_states_equal(a.state, c.state, names)
    thio.flush()
    assert sorted(os.listdir(tmp_path / "alarm")) == [
        f"{kind}_{n:06d}.nc" for kind in ("auxdiag", "hist", "restart") for n in (3, 6)]
    on_alarm, step, t_s = thio.read_restart(str(tmp_path / "alarm" / "restart_000003.nc"),
                                            tc, state)
    assert (step, t_s) == (3, 18.0)
    _assert_states_equal(on_alarm, b.state, names)


@pytest.fixture(scope="module")
def bubble_runs(tmp_path_factory):
    """The warm bubble run 10 steps by the reference (from its state and
    from theta changed by one ulp) and by the port, each with the output
    alarms, the tslist points and the NaN check on; what each wrote.  The
    port brings its pending tslist values to the host every 4 steps here
    (as it does every `_TS_PENDING_MAX` in a long run)."""
    from wrfchem_arc_interactions_tpu_torch.models import driver
    jc, tc, jg, js = _bubble()
    out = {}
    # the bubble's perturbation theta is zero outside the bubble, so the
    # noise probe changes the full theta by one ulp
    t_ulp = (js["t"] + np.float32(300.0)) * np.float32(1.0 + 2.0 ** -23) - np.float32(300.0)
    runs = (("jax", js), ("ulp", dict(js, t=t_ulp)), ("torch", js))
    for key, s0 in runs:
        d = str(tmp_path_factory.mktemp(key))
        if key == "torch":
            sim = TSim(tc, jax_grid_to_port(jg), state_from_numpy(s0, "cpu"), device="cpu",
                       output_dir=d, check_nans=True)
        else:
            sim = JSim(jc, jg, {k: jnp.asarray(v) for k, v in s0.items()}, output_dir=d,
                       check_nans=True)
        keep, driver._TS_PENDING_MAX = driver._TS_PENDING_MAX, 4
        try:
            sim.advance(10, phase_timing=True)
        finally:
            driver._TS_PENDING_MAX = keep
        (thio if key == "torch" else jhio).flush()
        files = sorted(os.listdir(d))
        ts_files = sim.write_tslist(os.path.join(d, "ts"))
        out[key] = {"dir": d, "files": files, "sim": sim, "ts_files": ts_files,
                    "ts_series": {k: [dict(r) for r in v] for k, v in sim.ts_series.items()},
                    "steps": sim.step_idx,
                    "phase_times": dict(sim.phase_times)}
    out["phb_scale"] = float(np.abs(np.asarray(jg.phb)).max())
    return out


def _limit(ref, ulp, scale):
    return max(1e-4, 3.0 * _rel(ref, ulp, scale))


def test_output_alarms_and_history_match_reference(bubble_runs):
    """Both packages write the same files at the same steps; each history
    file's fields and time agree within the slice tolerance."""
    r = bubble_runs
    assert r["torch"]["files"] == r["jax"]["files"] == [
        f"{kind}_{n:06d}.nc" for kind in ("auxdiag", "hist", "restart") for n in (5, 10)]
    for name in [f for f in r["jax"]["files"] if f.startswith("hist_")]:
        ref, t_ref = jhio.read_history(os.path.join(r["jax"]["dir"], name))
        ulp, _ = jhio.read_history(os.path.join(r["ulp"]["dir"], name))
        got, t_got = thio.read_history(os.path.join(r["torch"]["dir"], name))
        assert t_got == t_ref and set(got) == set(ref)
        for k, a in ref.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            scale = r["phb_scale"] if k == "ph" else float(np.abs(a).max())
            err = _rel(a, got[k], scale)
            assert err <= _limit(a, ulp[k], scale), (name, k, err)
    t = r["torch"]
    assert t["steps"] == 10
    assert set(t["phase_times"]) == {"chem", "rad", "main"} and t["phase_times"]["main"] > 0.0


def test_tslist_matches_reference(bubble_runs):
    """The ts_series rows (keys, times and values) and the .TS files."""
    r = bubble_runs
    ref, ulp, got = (r[k]["ts_series"] for k in ("jax", "ulp", "torch"))
    assert list(got) == list(ref) == [label for label, _, _ in TS_POINTS]
    for label in ref:
        assert len(got[label]) == len(ref[label]) == 10
        assert [list(row) for row in got[label]] == [list(row) for row in ref[label]]
        assert [row["time_s"] for row in got[label]] == [row["time_s"] for row in ref[label]]
        for col in ref[label][0]:
            a = np.array([row[col] for row in ref[label]])
            b = np.array([row[col] for row in got[label]])
            u = np.array([row[col] for row in ulp[label]])
            scale = max(float(np.abs(a).max()), 1e-30)
            assert _rel(a, b, scale) <= _limit(a, u, scale), (label, col)
    mid, west = got["mid"][-1]["w_max"], got["west"][-1]["w_max"]
    assert mid > 2.0 * west                   # the bubble sits mid-domain
    for pj, pt, pu in zip(r["jax"]["ts_files"], r["torch"]["ts_files"], r["ulp"]["ts_files"]):
        assert os.path.basename(pj) == os.path.basename(pt)
        lj, lt = open(pj).read().splitlines(), open(pt).read().splitlines()
        assert len(lt) == len(lj) == 11 and lt[0] == lj[0]
        a, b, u = (np.loadtxt(p, skiprows=1) for p in (pj, pt, pu))
        for col in range(a.shape[1]):
            scale = max(float(np.abs(a[:, col]).max()), 1e-30)
            # the files round to 6 significant digits
            lim = max(_limit(a[:, col], u[:, col], scale), 1e-5)
            assert _rel(a[:, col], b[:, col], scale) <= lim, (pt, lj[0].split()[col])


def test_check_nans_raises_as_reference(bubble_runs):
    """A NaN in theta stops the next step with the reference's message (on
    the fixture's simulations, which no other test steps again)."""
    msgs = []
    for key in ("jax", "torch"):
        sim = bubble_runs[key]["sim"]
        t = sim.state["t"]
        if key == "jax":
            sim.state = dict(sim.state, t=t.at[3, 1, 7].set(jnp.nan))
        else:
            t = t.clone()
            t[3, 1, 7] = float("nan")
            sim.state = dict(sim.state, t=t)
        with pytest.raises(FloatingPointError) as e:
            sim.advance(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "NaN in theta at step 11 (t=55.0s)"


@pytest.mark.parametrize("fault", ["nan", "w", "cfl_x", "none"])
def test_guard_raises_with_location_as_reference(fault):
    """`guard` on the same faulty state: the port raises the reference's
    message, with the first non-finite theta or the largest |w| located
    at (k, j, i); a healthy state passes both."""
    jc, tc, jg, js = _bubble()
    js = dict(js)
    if fault == "nan":
        js["t"] = js["t"].copy()
        js["t"][4, 2, 9] = np.nan
        js["t"][6, 1, 3] = np.inf
    elif fault == "w":
        js["w"] = js["w"].copy()
        js["w"][5, 3, 17] = -75.0
    elif fault == "cfl_x":
        js["u"] = js["u"] + np.float32(450.0)
    jh, th = JHalo(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y), THalo(
        bc_x=tc.dynamics.bc_x, bc_y=tc.dynamics.bc_y)
    jstate = {k: jnp.asarray(v) for k, v in js.items()}
    tstate, tgrid = state_from_numpy(js, "cpu"), jax_grid_to_port(jg)
    jd = jchecks.stability_diagnostics(jstate, jg, 5.0, jh)
    td = tchecks.stability_diagnostics(tstate, tgrid, 5.0, th)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    msgs = []
    for guard, state, grid, hx in ((jchecks.guard, jstate, jg, jh),
                                   (tchecks.guard, tstate, tgrid, th)):
        if fault == "none":
            guard(state, grid, 5.0, hx, 7)
            continue
        with pytest.raises(FloatingPointError) as e:
            guard(state, grid, 5.0, hx, 7)
        msgs.append(str(e.value))
    if fault != "none":
        assert msgs[0] == msgs[1], msgs
        assert "step 7" in msgs[1]
        if fault in ("nan", "w"):
            assert ("(k,j,i)=" in msgs[1]) and (("4" in msgs[1]) if fault == "nan"
                                                 else ("17" in msgs[1]))


def test_emission_stream_matches_constant_path(tmp_path):
    """A two-snapshot EmissionStream (0 s and 12 s) on config 4 with
    emiss_opt, chem every 2 steps: the switch falls at the step-2 chem call.
    4 steps equal, bit for bit, 2 steps of the constant-emissions path on
    the first snapshot, a restart file at the switch, and 2 steps of the
    constant path on the second (the path test_torch_slice6.py holds to the
    reference)."""
    from test_torch_slice6 import emissions
    tc, grid, state = _cfg4_case(emiss_opt=True)
    ny, nx = state["mu"].shape
    snaps = [emissions(ny, nx, seed=31), emissions(ny, nx, seed=32)]
    paths = []
    for i, (t_s, snap) in enumerate(zip((0.0, 12.0), snaps)):
        paths.append(str(tmp_path / f"wrfchemi_{i}.nc"))
        taux.write_emissions(paths[-1], snap, t_s)
    stream = taux.EmissionStream.from_files(paths[::-1])
    assert stream.times == [0.0, 12.0]
    sim = TSim(tc, grid, state, device="cpu", emissions=stream)
    assert sim.chem_every == 2
    sim.advance(4)

    first = TSim(tc, grid, state, device="cpu", emissions=state_from_numpy(snaps[0], "cpu"))
    first.advance(2)
    path = str(tmp_path / "restart_000002.nc")
    thio.write_restart(path, tc, first.state, first.step_idx, first.time_s)
    restored, step, t_s = thio.read_restart(path, tc, state)
    second = TSim(tc, grid, restored, device="cpu",
                  emissions=state_from_numpy(snaps[1], "cpu"))
    second.step_idx, second.time_s = step, t_s
    second.advance(2)
    _assert_states_equal(sim.state, second.state, list(state))
    # the second snapshot mattered: the first one alone gives another state
    only_first = TSim(tc, grid, state, device="cpu",
                      emissions=state_from_numpy(snaps[0], "cpu"))
    only_first.advance(4)
    assert not torch.equal(only_first.state["chem_so2"], sim.state["chem_so2"])
    with pytest.raises(TypeError, match="EmissionStream"):
        TSim(tc, grid, state, device="cpu", emissions=[snaps[0]])


def test_registry_sets_and_clock_match_reference():
    """restart_names, history_names, halo_width and validate_state of config
    4 as the reference's; the clock's timestamps and alarms."""
    jc, tc = _cfg4(jcfg), _cfg4(tcfg)
    assert treg.restart_names(tc) == jreg.restart_names(jc)
    assert treg.history_names(tc) == jreg.history_names(jc)
    assert treg.halo_width(tc) == jreg.halo_width(jc)
    assert {k: dataclasses.asdict(v) for k, v in treg.spec_index(tc).items()} == \
        {k: dataclasses.asdict(v) for k, v in jreg.spec_index(jc).items()}
    grid, state = tideal.make_case(tc, "squall2d_x", device="cpu", bubble_amp=3.0)
    treg.validate_state(tc, state)
    with pytest.raises(ValueError, match="registry expects"):
        treg.validate_state(tc, dict(state, t=state["t"][:, :, :-1]))
    for start, t_s in (("2014-07-03_06:30:00", 3930.0), ("2014-06-30_23:00:00", 7200.0)):
        assert tclock.ModelClock(start).timestamp(t_s) == jclock.ModelClock(start).timestamp(t_s)
    assert tclock.format_wrf_time(tclock.parse_wrf_time("2014-07-03_06:30:00")) == \
        "2014-07-03_06:30:00"
    for interval in (600.0, 0.0, 250.0):
        ta, ja = tclock.Alarm(interval_s=interval), jclock.Alarm(interval_s=interval)
        times = np.arange(0.0, 1900.0, 100.0)
        assert [t for t in times if ta.is_ringing(t)] == [t for t in times if ja.is_ringing(t)]
