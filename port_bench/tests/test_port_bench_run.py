"""Whole runs of the harness on the CPU at a small shape: the result line,
the check on sound runs, the control and the faults it has to catch.  The
measuring path (`port_bench.run`) refuses the CPU; these tests call the
harness beneath it."""

import json
import time

import pytest
import torch

from port_bench import harness, spec

torch.set_num_threads(1)

SHAPE = {"nx": 16, "ny": 8, "nz": 12}


def _cell(tmp_path, name):
    """The cell with its configuration cut to SHAPE, from copies of its files."""
    bench = spec.benchmark()
    cell = spec.workload(bench, name)
    cell["config_spec"]["namelist"]["domain"].update(SHAPE)
    return bench, cell


def _run(tmp_path, name, trace=False, seed=2**31 + 7, precisions=()):
    bench, cell = _cell(tmp_path, name)
    return harness.run(cell, bench, seed, 0.0, trace, "cpu", time.perf_counter(),
                       precisions=precisions)


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_sound_run_is_correct_and_its_line_has_the_keys(tmp_path, seed):
    name = "arc_block.main"
    res = _run(tmp_path, name, seed=seed)
    assert res["correct"] is True
    assert res["numbers"]["state_err"] == 0.0 and res["numbers"]["start_err"] == 0.0
    line = {k: v for k, v in res.items() if k not in ("records", "numbers")}
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] == 10 and line["failed"] == 0
    assert set(line["metrics"]) == {"gridpoints_per_s", "setup_s"}   # no card: no peak
    limits = spec.workload(spec.benchmark(), name)["limits"]
    assert set(line["checks"]) == set(limits)
    json.dumps(line)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of arc_block.main at SHAPE."""
    return _run(tmp_path_factory.mktemp("traced"), "arc_block.main", trace=True)


def test_traced_run_line(traced):
    res = traced
    assert res["correct"] is True
    line = {k: v for k, v in res.items() if k not in ("records", "numbers")}
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"main_step_ms", "chem_call_ms", "main_span_ms", "dycore_span_ms",
            "physics_span_ms", "chem_span_ms"} <= set(line["metrics"])
    # no device on the CPU: nothing for the device's metrics to read (the
    # launches are the host's calls into the CUDA runtime)
    for name in ("idle_pct", "advect_tracers_roofline", "diffuse_scalars_roofline",
                 "main_launches_per_step", "chem_launches_per_call"):
        assert name not in line["metrics"]
    # the profiled and the phase-timed period, then the spans' two blocks
    assert line["attempted"] == 40
    # the check follows the phase-timed period's last steps, as without the spans
    assert res["records"]["phases"]["steps"] == 10


def test_traced_run_records_the_spans(traced):
    """``records["spans"]``: a block's steps and calls, and per span path
    its device seconds, calls, steps, host lead, launches and idle
    seconds, from which the span metrics read; no mesh on one card."""
    records, m = traced["records"], traced["metrics"]
    sp = records["spans"]
    assert (sp["steps"], sp["chem_calls"], sp["rad_calls"], sp["cards"]) == (10, 1, 0, 1)
    assert len(sp["period_s"]) == 2 and min(sp["period_s"]) > 0
    paths = sp["paths"]
    assert {"step", "main", "main/dycore", "main/dycore/stage/acoustic", "main/pre_physics",
            "main/post_physics", "main/pre_physics/diffusion/pass", "chem",
            "chem/row_block"} <= set(paths)
    for row in paths.values():
        assert set(row) == {"device_s", "self_s", "calls", "steps", "lead_median_s",
                            "launches", "kernel_s", "idle_s"}
    assert paths["main"]["calls"] == paths["main"]["steps"] == 10
    assert paths["main/dycore/stage"]["calls"] == 30 and paths["chem"]["calls"] == 1
    assert 0 < paths["main/dycore"]["device_s"] <= paths["main"]["device_s"]
    assert m["main_span_ms"]["value"] == pytest.approx(1e2 * paths["main"]["device_s"])
    assert m["chem_span_ms"]["value"] == pytest.approx(1e3 * paths["chem"]["device_s"])
    assert m["physics_span_ms"]["value"] == pytest.approx(
        1e2 * (paths["main/pre_physics"]["device_s"] + paths["main/post_physics"]["device_s"]))
    assert "mesh" not in records


def test_bfloat16_control_fails_the_check(tmp_path):
    """The control in the port's place, judged by the cell's verdict."""
    res = _run(tmp_path, "arc_block.main", precisions=("bfloat16",))
    assert res["correct"] is True
    assert res["numbers"]["control.bfloat16.correct"] is False
    assert res["numbers"]["control.bfloat16.start_err"] == 0.0
    assert res["numbers"]["control.bfloat16.state_err"] > res["checks"]["state_err"]["limit"]


def _main_fault(monkeypatch, fault):
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    orig = Simulation._stepper

    def stepper(self, key):
        fn = orig(self, key)
        if key != "main":
            return fn
        return lambda s, g, t: fault(s, fn(s, g, t))

    monkeypatch.setattr(Simulation, "_stepper", stepper)


def _unchanged(before, after):
    return before


def _half_the_rows(before, after):
    ny = SHAPE["ny"]
    out = dict(after)
    for k, v in after.items():
        if v.dim() >= 2 and v.shape[-2] == ny:
            out[k] = torch.cat([v[..., : ny // 2, :], before[k][..., ny // 2:, :]], dim=-2)
    return out


def _one_value_altered(before, after):
    out = dict(after)
    t = after["t"].clone()
    t[3, 4, 5] += 0.5
    out["t"] = t
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half_the_rows, _one_value_altered])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    _main_fault(monkeypatch, fault)
    res = _run(tmp_path, "arc_block.main")
    assert res["correct"] is False
    assert res["numbers"]["state_err"] > res["checks"]["state_err"]["limit"]


def test_a_different_start_is_not_correct(tmp_path, monkeypatch):
    from port_bench import case
    orig = case.seeded_state
    calls = []

    def seeded(state, spec_, traffic, seed):
        calls.append(seed)
        # the port's side (the first call) gets another seed's inputs
        return orig(state, spec_, traffic, seed + (1 if len(calls) == 1 else 0))

    monkeypatch.setattr(case, "seeded_state", seeded)
    res = _run(tmp_path, "arc_block.main")
    assert res["correct"] is False
    assert res["numbers"]["start_err"] > 0


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct(tmp_path):
    """The kernels' path on the card against the plain reference at a small
    shape (run on the chip: python3 -m pytest -m cuda port_bench/tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench, cell = _cell(tmp_path, "arc_block.main")
    cell["config_spec"]["namelist"]["domain"].update(nx=64, ny=48, nz=20)
    res = harness.run(cell, bench, 12345, 0.0, False, "cuda", time.perf_counter(),
                      precisions=("tf32",))
    assert res["correct"] is True, res["numbers"]
    # the control in the port's place: TF32 in the optics' products fails the verdict
    assert res["numbers"]["control.tf32.correct"] is False, res["numbers"]
