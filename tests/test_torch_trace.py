"""The port's span recorder (`utils.trace`): off it is one shared no-op;
on, spans nest into paths with parents, step numbers, counts and self
times; `flush` empties it; a traced run is the untraced run bit for bit;
`phase_timing` reads the executables' spans.  On the card (`-m cuda`): the
main step's sub-spans fit inside it, and a traced run synchronises no more
often than an untraced one until `flush`."""

import time
import warnings

import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config import namelist as nl  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.utils import logging as tlog  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.utils import trace  # noqa: E402

SEED = (("chem_so4_a01", 2.0), ("chem_oc_a01", 1.0), ("chem_num_a01", 2e9),
        ("chem_so4_a02", 2.0), ("chem_oc_a02", 1.0), ("chem_num_a02", 2e9),
        ("chem_o3", 0.04), ("chem_no2", 2e-3), ("chem_no", 1e-3), ("chem_co", 0.12),
        ("chem_so2", 2e-3), ("chem_h2o2", 1e-3))


@pytest.fixture
def tracing_off():
    """Leave tracing off after the test, whatever it did."""
    trace.stop()
    yield
    trace.stop()


def _cfg(nx, ny, nz):
    """bench.py's config 4 package from noon, chem and rad every 2 steps."""
    return tcfg.Config(
        domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                 ztop=17000.0, p_top=8000.0),
        time_control=tcfg.TimeControl(dt=6.0, start_date="2000-06-20_12:00:00"),
        dynamics=tcfg.DynamicsConfig(kvdif=30.0),
        physics=tcfg.PhysicsConfig(mp_physics=nl.MPScheme.MORRISON2, progn=True,
                                   ra_sw_physics=nl.RAScheme.RRTMG,
                                   ra_lw_physics=nl.RAScheme.RRTMG, radt_s=12.0),
        chem=tcfg.ChemConfig(chem_opt=nl.ChemOpt.CBMZ_MOSAIC_4BIN, chemdt_s=12.0,
                             aer_ra_feedback=True))


def _sim(device, nx=16, ny=4, nz=12):
    cfg = _cfg(nx, ny, nz)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=device, bubble_amp=3.0)
    state = dict(state)
    for k, v in SEED:
        state[k] = torch.full_like(state["t"], v)
    return Simulation(cfg, grid, state, device=device)


def test_off_span_is_one_shared_noop(tracing_off, monkeypatch):
    """Off, `span` hands back the shared no-op, also under the profiler,
    and calls no `record_function`; what ran meanwhile is not recorded."""
    calls = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: calls.append(a))
    assert not trace.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("main") as sp, trace.span("dycore", step=3):
            pass
    assert sp is trace.NO_SPAN and trace.span("x") is trace.span("y") is trace.NO_SPAN
    assert calls == []
    trace.start("cpu")
    assert trace.flush() == {}


def test_on_span_enters_record_function_under_the_profiler(tracing_off):
    from torch.profiler import ProfilerActivity, profile
    trace.start("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step", step=0), trace.span("main"), trace.span("dycore"):
            torch.ones(4).add_(1.0)
    with trace.span("main"):        # no profiler: no annotation
        pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"step", "main", "main/dycore"} <= names
    assert trace.flush()["main"]["count"] == 2


def test_paths_parents_steps_and_counts(tracing_off):
    rec = trace.start("cpu")
    for n in (7, 8):
        with trace.span("step", step=n):
            with trace.span("main"):
                with trace.span("dycore"):
                    for _ in range(3):
                        with trace.span("stage"):
                            with trace.span("acoustic"):
                                pass
            with trace.span("output"):
                pass
    with trace.span("alone"):
        with trace.span("inner"):
            pass
    by_path = {}
    for sp in rec.done:
        by_path.setdefault(sp.path, []).append(sp)
    assert set(by_path) == {"step", "main", "main/dycore", "main/dycore/stage",
                            "main/dycore/stage/acoustic", "output", "alone", "alone/inner"}
    stage = by_path["main/dycore/stage"][0]
    assert stage.parent.path == "main/dycore" and stage.parent.parent.path == "main"
    assert stage.parent.parent.parent.path == "step"
    assert by_path["step"][0].parent is None and by_path["alone/inner"][0].parent.path == "alone"
    assert [sp.step for sp in by_path["main/dycore/stage/acoustic"]] == [7] * 3 + [8] * 3
    assert by_path["alone"][0].step is None
    out = trace.flush()
    assert {p: s["count"] for p, s in out.items()} == {
        "step": 2, "main": 2, "main/dycore": 2, "main/dycore/stage": 6,
        "main/dycore/stage/acoustic": 6, "output": 2, "alone": 1, "alone/inner": 1}
    assert out["main/dycore/stage"]["steps"] == 2 and out["alone"]["steps"] == 1
    assert all(s["lead_min_ms"] == s["lead_median_ms"] == 0.0 for s in out.values())


def test_self_time_is_the_span_less_its_children(tracing_off):
    trace.start("cpu")
    with trace.span("main"):
        time.sleep(0.004)
        with trace.span("a"):
            time.sleep(0.002)
            with trace.span("deep"):
                time.sleep(0.002)
        with trace.span("b"):
            time.sleep(0.002)
    out = trace.flush()
    m, a, b, deep = (out[p] for p in ("main", "main/a", "main/b", "main/a/deep"))
    assert m["self_ms"] == pytest.approx(m["device_ms"] - a["device_ms"] - b["device_ms"])
    assert a["self_ms"] == pytest.approx(a["device_ms"] - deep["device_ms"])
    assert deep["self_ms"] == deep["device_ms"] >= 2.0
    assert m["self_ms"] >= 4.0 and m["device_ms"] == pytest.approx(m["host_ms"])


def test_flush_clears(tracing_off):
    trace.start("cpu")
    with trace.span("main"):
        pass
    assert set(trace.flush()) == {"main"}
    assert trace.flush() == {}
    with trace.span("chem"):
        pass
    assert set(trace.flush()) == {"chem"}
    with trace.span("rad"):
        pass
    trace._active.discard()         # dropped unread
    assert trace.flush() == {}
    trace.stop()
    with pytest.raises(RuntimeError):
        trace.flush()


def test_traced_run_is_the_untraced_run_bitwise(tracing_off, capsys):
    """4 steps of config 4 at 16x4x12 (chem and rad at steps 0 and 2):
    every field bitwise with and without tracing; the executables, their
    layers, the chem stages, the rad chunks and the diffusion's passes as
    spans; WRF's timing line of each step at `flush`."""
    plain = _sim("cpu")
    plain.advance(4)
    traced = _sim("cpu")
    trace.start("cpu")
    traced.advance(4)
    keep = tlog._LEVEL
    tlog.set_level(2)
    try:
        out = trace.flush()
    finally:
        tlog.set_level(keep)
    assert set(plain.state) == set(traced.state)
    for k, v in plain.state.items():
        assert torch.equal(v, traced.state[k]), k
    count = {p: s["count"] for p, s in out.items()}
    assert count["step"] == count["main"] == 4 and count["chem"] == count["rad"] == 2
    assert count["main/dycore/stage"] == count["main/dycore/stage/acoustic"] == 12
    assert count["main/pre_physics/diffusion/pass"] == 4
    assert count["main/post_physics/activation"] == count["main/post_physics/microphysics"] == 4
    assert {"chem/row_block/drydep", "chem/row_block/photolysis", "chem/row_block/gas",
            "chem/row_block/aerosol", "chem/row_block/optics"} <= set(out)
    assert count["rad/lw/chunk"] == count["rad/sw/chunk"] == 2
    assert all(s["steps"] == 4 for p, s in out.items() if p.startswith("main"))
    main = out["main"]
    parts = sum(out[p]["device_ms"] for p in ("main/pre_physics", "main/dycore",
                                              "main/post_physics"))
    assert parts <= main["device_ms"]
    assert sum(out[p]["device_ms"] for p in ("chem", "rad", "main")) <= out["step"]["device_ms"]
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("Timing for main")]
    assert len(lines) == 4 and lines[0].startswith("Timing for main: time 2000-06-20_12:00:06")
    assert lines[-1].endswith("elapsed seconds")


def test_phase_times_from_the_executables_spans(tracing_off):
    """`phase_timing` with tracing off: the keys and positive times as
    before, tracing off again after the call; with tracing on, the same
    spans stay in the recorder's next flush."""
    sim = _sim("cpu")
    sim.advance(3, phase_timing=True)
    assert not trace.enabled()
    assert set(sim.phase_times) == {"chem", "rad", "main"}
    assert all(v > 0.0 for v in sim.phase_times.values())
    before = dict(sim.phase_times)
    trace.start("cpu")
    sim.advance(1, phase_timing=True)
    out = trace.flush()
    assert sim.phase_times["main"] - before["main"] == pytest.approx(out["main"]["host_ms"] * 1e-3)
    assert sim.phase_times["chem"] == before["chem"] and "chem" not in out


@pytest.mark.cuda
def test_spans_on_the_card(tracing_off):
    """On the card at 64x48x20: the main step's three layers come to no
    more than its span, and the recorder adds no synchronisation before
    `flush` (`set_sync_debug_mode` warns as often with tracing as
    without)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    def warnings_of(sim, traced):
        torch.cuda.synchronize()
        if traced:
            trace.start("cuda")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                sim.advance(4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return [str(w.message) for w in seen]

    plain, traced = _sim("cuda", 64, 48, 20), _sim("cuda", 64, 48, 20)
    for sim in (plain, traced):      # compile and warm every path first
        sim.advance(2)
    untraced_warnings = warnings_of(plain, False)
    traced_warnings = warnings_of(traced, True)
    out = trace.flush()
    assert len(traced_warnings) == len(untraced_warnings), (traced_warnings,
                                                            untraced_warnings)
    main = out["main"]["device_ms"]
    parts = sum(out[p]["device_ms"] for p in ("main/pre_physics", "main/dycore",
                                              "main/post_physics"))
    assert 0.0 < parts <= main
    assert out["step"]["count"] == 4 and out["main/dycore/stage"]["count"] == 12
    for k, v in plain.state.items():
        assert torch.equal(v, traced.state[k]), k
