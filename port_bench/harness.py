"""One run of a cell: set-up, the measured window, the check, the records
that the metrics' readers read.

`run` drives the PyTorch port (`wrfchem_arc_interactions_tpu_torch`) on
the device it is given; `port_bench.run` gives it the card and refuses to
run without one, and the CPU tests give it the CPU at small shapes.  From
the port it takes the system under test (`Simulation`, `make_case`, the
namelist) and its counters (`phase_times`, the allocator's statistics,
the profiler's kernels); everything it compares against comes from this
folder.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from typing import Sequence

import numpy as np
import torch

from port_bench import case, check, spec, window
from port_bench import trace as trace_mod

ALLOCATOR_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _alloc_stats(device) -> dict:
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOCATOR_COUNTS}


def _calls(model, first: int, steps: int) -> dict:
    return {"steps": steps,
            "chem_calls": window.alarm_calls(model.chem_every, first, steps),
            "rad_calls": window.alarm_calls(model.rad_every, first, steps)}


def _main_peak(sim, device) -> int:
    """Bytes one synchronised main call allocates at its peak above what
    was allocated before it."""
    _sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = sim._stepper("main")(sim.state, sim.grid, np.float32(sim.time_s))
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del out
    return peak


def follow(cell: dict, seed: int, device, snap_state: dict, snap_step: int, final: dict,
           start_stats: dict, precisions: Sequence[str] = ()) -> dict:
    """The check: the reference's case from the seed against the port's
    start, then the reference's steps from the port's copied state through
    the window's last steps against the port's final state.  With
    `precisions`, the control: the reference in each of those precisions,
    followed from the same copy, put in the port's place and judged by the
    same verdict (``control.<precision>.<number>`` and
    ``control.<precision>.correct``, which a sound check reads false)."""
    from port_bench.reference.runner import Model
    from port_bench.reference.wrf.config import namelist
    cfg_spec, traffic, limits = cell["config_spec"], cell["traffic"], cell["limits"]
    t0 = time.perf_counter()
    ref_cfg = case.build_config(namelist, cfg_spec)
    model = Model(ref_cfg)
    grid, state = model.case(cfg_spec["case"], device, **cfg_spec["case_args"])
    state = case.seeded_state(state, cfg_spec, traffic, seed)
    start_err, start_where = check.stats_err(start_stats, check.field_stats(state, grid))
    del state
    _say(f"reference case built and compared in {time.perf_counter() - t0:.1f} s")

    def steps(model_):
        s = {k: v.to(device) for k, v in snap_state.items()}
        for n in range(snap_step, snap_step + traffic["check_steps"]):
            s = model_.step(s, grid, n)
        return s

    ref = steps(model)
    _say(f"reference followed {traffic['check_steps']} steps from step {snap_step} in "
         f"{time.perf_counter() - t0:.1f} s")
    errs = check.field_errs(final, ref, device)
    out = {"start_err": start_err, "start_field": start_where,
           **check.state_numbers(errs), "fields": len(errs),
           "reference_s": time.perf_counter() - t0,
           "top_fields": sorted(errs.items(), key=lambda kv: -kv[1])[:5]}
    if precisions:
        ref = {k: v.to("cpu") for k, v in ref.items()}
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for p in precisions:
        t_p = time.perf_counter()
        low = steps(Model(ref_cfg, precision=p))
        # in the port's place: its start is the reference's own case
        control = {"start_err": 0.0, **check.state_numbers(check.field_errs(low, ref, device))}
        del low
        for k, v in control.items():
            out[f"control.{p}.{k}"] = v
        out[f"control.{p}.correct"] = check.verdict(control, limits)
        _say(f"control {p} followed in {time.perf_counter() - t_p:.1f} s")
    return out


def run(cell: dict, bench: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, precisions: Sequence[str] = ()) -> dict:
    """One run of `cell`: the result line's object, and under ``records``
    what the metrics were read from."""
    from wrfchem_arc_interactions_tpu_torch.config import namelist
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from port_bench.reference.runner import Model
    from port_bench.reference.wrf.config import namelist as ref_namelist

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg_spec, traffic = cell["config_spec"], cell["traffic"]
    # the configuration's alarms and scalars, counted by the reference
    counted = Model(case.build_config(ref_namelist, cfg_spec))

    # set-up: the case from the seed, the Simulation, the warm-up steps
    cfg = case.build_config(namelist, cfg_spec)
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    grid, state = ideal.make_case(cfg, cfg_spec["case"], device=device, **cfg_spec["case_args"])
    state = case.seeded_state(state, cfg_spec, traffic, seed)
    t_check = time.perf_counter()
    start_stats = check.field_stats(state, grid)
    excluded_s = time.perf_counter() - t_check
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    sim = Simulation(cfg, grid, state, device=device)
    del grid, state
    sim.advance(traffic["warmup_steps"])
    sim.sync()
    setup_s = time.perf_counter() - t_start - excluded_s
    _say(f"set-up {setup_s:.2f} s (step {sim.step_idx})")

    # the check's copy buffers: allocated after set-up, before the window
    snap = window.Snapshot(sim.state, device)
    period_steps, follow_steps = traffic["period_steps"], traffic["check_steps"]

    def period(last, phase_timing=False):
        window.run_period(sim, period_steps, follow_steps, snap if last else None,
                          phase_timing)

    first = sim.step_idx
    most = window.max_periods((counted.chem_every, counted.rad_every), first, period_steps,
                              traffic["max_periods"])
    alloc0 = _alloc_stats(device)
    records = {"cell": cell["name"], "shape": [cfg.domain.nx, cfg.domain.ny, cfg.domain.nz],
               "scalars": counted.scalars(),
               "bins": case.aerosol_bins(cfg_spec), "chemdt_s": cfg.chem.chemdt_s,
               "gas_chem": cfg.chem.gaschem_onoff and "cbmz" in cfg.chem.chem_opt.value,
               "state_bytes": state_bytes, "setup_s": setup_s}
    breakdown = None
    if not trace:
        each, wall = window.timed_periods(period, sim.sync, seconds, most)
        records["window"] = dict(_calls(counted, first, len(each) * period_steps),
                                 periods=len(each), seconds=wall, period_s=each)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        n_prof = traffic["traced_periods"]
        if 2 * n_prof > most:
            raise ValueError(f"{cell['name']}: {2 * n_prof} traced periods, but only {most} "
                             "hold the same calls")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(trace_mod.WINDOW):
                for _ in range(n_prof):
                    period(False)
                    sim.sync()
        t_red = time.perf_counter()
        reduced = trace_mod.reduce(trace_mod.events(prof))
        del prof
        _say(f"trace reduced in {time.perf_counter() - t_red:.1f} s")
        reduced.update(_calls(counted, first, n_prof * period_steps))
        records["trace"] = reduced
        breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
        # the phases: every executable closed by a synchronisation
        first_phase = sim.step_idx
        for i in range(n_prof):
            period(i == n_prof - 1, phase_timing=True)
        sim.sync()
        records["phases"] = dict(_calls(counted, first_phase, n_prof * period_steps),
                                 **{f"{k}_s": v for k, v in sim.phase_times.items()})
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    records["peak_bytes"] = peak
    alloc1 = _alloc_stats(device)
    records["allocator"] = {k: alloc1[k] - alloc0[k] for k in alloc1}
    if trace and cuda:
        records["main_peak_bytes"] = _main_peak(sim, device)

    # the check: the port's final state and the copy, then the reference
    final = {k: v.to("cpu") for k, v in sim.state.items()}
    snap_state, snap_step = snap.state(), snap.step
    if snap_step != sim.step_idx - follow_steps:
        raise RuntimeError(f"the copy is of step {snap_step}, the window ended at "
                           f"{sim.step_idx}")
    del sim, period
    gc.collect()          # the Simulation's steppers close over it: a cycle
    if cuda:
        torch.cuda.empty_cache()
    _say(f"window closed: {json.dumps(records.get('window') or records.get('phases'))}; "
         f"peak {peak}; checking")
    numbers = follow(cell, seed, device, snap_state, snap_step, final, start_stats,
                     precisions)
    del final, snap
    limits = cell["limits"]
    correct = check.verdict(numbers, limits)
    metrics = spec.read_metrics(bench, cell["name"], trace, records)
    steps_done = sum(records.get(k, {}).get("steps", 0)
                     for k in ("window", "trace", "phases"))
    result = {"correct": correct, "attempted": steps_done,
              "failed": 0 if correct else steps_done, "metrics": metrics,
              "device": _device(device, peak, records.get("trace"))}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits.items()}
    result["records"] = records
    result["numbers"] = numbers
    return result


def _power_limit_w(index: int):
    """The card's power limit [W] by nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _device(device, peak, traced) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": peak,
               "power_limit_w": _power_limit_w(device.index or 0)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    if traced is not None:
        out["busy_s"] = traced["busy_s"] / out["count"]
        out["window_s"] = traced["window_s"]
    return out


def report(records: dict, numbers: dict) -> None:
    """What the run measured and compared, on standard error."""
    brief = {k: v for k, v in records.items() if k != "trace"}
    if "trace" in records:
        brief["trace"] = {k: v for k, v in records["trace"].items() if k != "kernels"}
    _say("records " + json.dumps(brief, default=str))
    _say("check " + json.dumps(numbers, default=str))
