"""One run of a cell: set-up, the measured window, the check, the records
that the metrics' readers read.

`measure` drives the PyTorch port (`wrfchem_arc_interactions_tpu_torch`)
on the devices it is given; `port_bench.run` gives it the cards and
refuses to run without them, and the CPU tests give it the CPU at small
shapes.  From the port it takes the system under test (`Simulation`,
`make_case`, the namelist, and for a cell of several cards
`parallel.launch.spawn` and `parallel.mesh.make_mesh`) and its counters
(`phase_times`, the allocator's statistics, the profiler's kernels);
everything it compares against comes from this folder.

A one-card cell runs in this process (`run`).  A cell of several runs one
rank a device (`_rank`): every rank builds the global case from the seed
on its card, the `Simulation` keeps the rank's block, and the window's
periods each close with the rank's synchronisation and a barrier, the
last one chosen by rank 0 for all, so that rank 0's clock times the
slowest rank; with ``--trace 1`` every rank profiles the same periods.
After the window each rank checks its block in ringed tiles
(`port_bench.tiles`), and `_mesh_result` joins the ranks' parts: the
whole domain's numbers, rank 0's records with the global shape, the
largest peak over the cards, and the traced busy, window and kernel
seconds summed over the cards.
"""

from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from port_bench import case, check, spec, window
from port_bench import trace as trace_mod

ALLOCATOR_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")
SPAN_BLOCKS = 2          # the blocks of traced periods `_spans` runs
SPAN_SUMS = ("device_s", "self_s", "kernel_s", "idle_s")     # card-seconds on a mesh

# a run of several ranks, and each collective in it, ends within this; a
# checkout's first run builds the kernels and may take 1,200 s
MESH_TIMEOUT_S = 1200.0


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


def _window(sim, snap, counted, cell: dict, seconds: float, trace: bool, device,
            sync: Callable[[], None], agree=None) -> tuple:
    """The measured window from the run's set-up on: whole periods timed
    (or, with `trace`, profiled and then phase-timed), each closed by
    `sync`; `agree` shares the choice of the last period over the ranks of
    a mesh (`window.timed_periods`).  Returns (the records of the window,
    the breakdown or None)."""
    cuda = device.type == "cuda"
    traffic = cell["traffic"]
    period_steps, follow_steps = traffic["period_steps"], traffic["check_steps"]

    def period(last, phase_timing=False):
        window.run_period(sim, period_steps, follow_steps, snap if last else None,
                          phase_timing)

    first = sim.step_idx
    most = window.max_periods((counted.chem_every, counted.rad_every), first, period_steps,
                              traffic["max_periods"])
    records: dict = {}
    if not trace:
        each, wall = window.timed_periods(period, sync, seconds, most, agree=agree)
        records["window"] = dict(_calls(counted, first, len(each) * period_steps),
                                 periods=len(each), seconds=wall, period_s=each)
        return records, None
    from torch.profiler import ProfilerActivity, profile, record_function
    n_prof = traffic["traced_periods"]
    # the profiled and the phase-timed periods here, the spans' two blocks
    # after the check's copy (`_spans`)
    if 4 * n_prof > most:
        raise ValueError(f"{cell['name']}: {4 * n_prof} traced periods, but only {most} "
                         "hold the same calls")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(trace_mod.WINDOW):
            for _ in range(n_prof):
                period(False)
                sync()
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
    sync()
    records["phases"] = dict(_calls(counted, first_phase, n_prof * period_steps),
                             **{f"{k}_s": v for k, v in sim.phase_times.items()})
    return records, breakdown


def _result(cell: dict, bench: dict, trace: bool, records: dict, numbers: dict,
            device_info: dict, breakdown) -> dict:
    """The result line's object (``correct`` .. ``checks``), then under
    ``records`` and ``numbers`` what the metrics and the verdict were read
    from."""
    limits = cell["limits"]
    # a probe's run without the check (`measure(check=False)`) has no numbers
    correct = check.verdict(numbers, limits) if numbers else None
    metrics = spec.read_metrics(bench, cell["name"], trace, records)
    steps_done = sum(records.get(k, {}).get("steps", 0)
                     for k in ("window", "trace", "phases"))
    steps_done += SPAN_BLOCKS * records.get("spans", {}).get("steps", 0)
    result = {"correct": correct, "attempted": steps_done,
              "failed": 0 if correct else steps_done, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = ({k: {"value": numbers[k], "limit": v["limit"]}
                         for k, v in limits.items()} if numbers else {})
    result["records"] = records
    result["numbers"] = numbers
    return result


def run(cell: dict, bench: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, precisions: Sequence[str] = ()) -> dict:
    """One run of a one-card `cell`: the result line's object, and under
    ``records`` what the metrics were read from."""
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
    follow_steps = traffic["check_steps"]
    alloc0 = _alloc_stats(device)
    records = _records(cell, cfg, counted, state_bytes, setup_s)
    measured, breakdown = _window(sim, snap, counted, cell, seconds, trace, device, sim.sync)
    records.update(measured)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    records["peak_bytes"] = peak
    alloc1 = _alloc_stats(device)
    records["allocator"] = {k: alloc1[k] - alloc0[k] for k in alloc1}
    if trace and cuda:
        records["main_peak_bytes"] = _main_peak(sim, device)

    # the check: the port's final state and the copy, then the reference
    final = _final_state(sim)
    snap_state, snap_step = snap.state(), snap.step
    if snap_step != sim.step_idx - follow_steps:
        raise RuntimeError(f"the copy is of step {snap_step}, the window ended at "
                           f"{sim.step_idx}")
    if trace:
        records["spans"] = _spans(sim, counted, cell, cuda, sim.sync)
    del sim
    gc.collect()          # the Simulation's steppers close over it: a cycle
    if cuda:
        torch.cuda.empty_cache()
    _say(f"window closed: {json.dumps(records.get('window') or records.get('phases'))}; "
         f"peak {peak}; checking")
    numbers = follow(cell, seed, device, snap_state, snap_step, final, start_stats,
                     precisions)
    del final, snap
    return _result(cell, bench, trace, records, numbers,
                   _device(device, peak, records.get("trace")), breakdown)


def _spans(sim, counted, cell: dict, cuda: bool, sync: Callable[[], None]) -> dict:
    """The port's spans (`port_bench.spans.traced_blocks`) in two blocks of
    the traffic's traced periods, after the window's and the check's copy
    of its end, each period closed by `sync`: per span path the device
    seconds of its spans, their self seconds, calls, steps and median host
    lead (block (b), no profiler), and the launches, the kernels' device
    seconds and the idle seconds of it and every span inside it (block
    (a), profiled).
    ``steps`` and the calls are one block's; ``cards`` 1 (`_mesh_result`
    sums the seconds over the cards)."""
    from port_bench import spans
    traffic = cell["traffic"]
    n, period_steps = traffic["traced_periods"], traffic["period_steps"]
    first = sim.step_idx
    blocks = spans.traced_blocks(sim, lambda: sim.advance(period_steps), n, cuda, sync)
    a, b = blocks["a"], blocks["b"]
    paths = {}
    for path, row in b["spans"].items():
        inside = spans.under(a["by_span"], path)
        paths[path] = {"device_s": 1e-3 * row["device_ms"], "self_s": 1e-3 * row["self_ms"],
                       "calls": row["count"], "steps": row["steps"],
                       "lead_median_s": 1e-3 * row["lead_median_ms"],
                       "launches": inside["launches"], "kernel_s": float(inside["device_s"]),
                       "idle_s": float(inside["idle_s"])}
    outside = a["by_span"].get(spans.UNATTRIBUTED, {})
    return dict(_calls(counted, first, n * period_steps), periods=n, cards=1,
                period_s=[a["period_s"], b["period_s"]], launches=a["launches"],
                unattributed_launches=a["unattributed_launches"],
                unattributed_idle_s=float(outside.get("idle_s", 0.0)), paths=paths)


def _records(cell: dict, cfg, counted, state_bytes: int, setup_s: float) -> dict:
    """What the metrics' readers read of the configuration and the set-up:
    the global shape (nx, ny, nz) and state bytes, the scalars, bins, chem
    step and vertical diffusion."""
    return {"cell": cell["name"], "shape": [cfg.domain.nx, cfg.domain.ny, cfg.domain.nz],
            "scalars": counted.scalars(),
            "bins": case.aerosol_bins(cell["config_spec"]), "chemdt_s": cfg.chem.chemdt_s,
            "kvdif": cfg.dynamics.kvdif,
            "gas_chem": cfg.chem.gaschem_onoff and "cbmz" in cfg.chem.chem_opt.value,
            "state_bytes": state_bytes, "setup_s": setup_s}


def measure(cell: dict, bench: dict, seed: int, seconds: float, trace: bool,
            devices: Sequence[str], t_start: float, precisions: Sequence[str] = (),
            rank_init: Optional[Callable[[int], None]] = None, check: bool = True) -> dict:
    """One run of `cell` on `devices`, one a chip: `run` in this process
    for a one-card cell; for a cell of several, one rank a device
    (`parallel.launch.spawn`: NCCL between distinct cards, gloo on the
    host or where ranks share a card), each running `_rank`, and their
    parts joined here (`_mesh_result`).  `rank_init(rank)`, where given,
    runs first in each rank (the tests plant faults with it).  Without
    `check` (the mesh probe's spread, several cards only) the ranks stop
    after the window, and the result has no numbers and ``correct``
    None.  Raises where a rank raises."""
    if len(devices) != cell["chips"]:
        raise ValueError(f"{cell['name']} runs on {cell['chips']} devices, not {len(devices)}")
    if cell["chips"] == 1:
        if not check:
            raise ValueError("a one-card run always checks")
        return run(cell, bench, seed, seconds, trace, devices[0], t_start, precisions)
    spec.mesh_shape(cell)
    from wrfchem_arc_interactions_tpu_torch.parallel import launch
    cards = [torch.device(d) for d in devices]
    nccl = all(d.type == "cuda" for d in cards) and len(set(devices)) == len(devices)
    parts = launch.spawn(_rank, len(devices), "nccl" if nccl else "gloo", list(devices),
                         args=(cell, bench, seed, seconds, trace, t_start, tuple(precisions),
                               rank_init, check),
                         timeout_s=MESH_TIMEOUT_S)
    return _mesh_result(cell, bench, trace, precisions, parts)


def _final_state(sim) -> dict:
    """The port's state at the window's close, on the host."""
    return {k: v.to("cpu") for k, v in sim.state.items()}


def _periods(marks: list) -> list:
    """Between each two of a rank's marks (own synchronisation done,
    barrier left, step, the mesh's exchanges and bytes sent): the steps,
    the seconds to its own synchronisation and in the barrier, and the
    exchanges and bytes it sent.  In a traced run the second interval
    also holds the profile's reduction."""
    return [{"steps": s1 - s0, "own_s": o1 - r0, "barrier_s": r1 - o1,
             "exchanges": e1 - e0, "bytes_sent": b1 - b0}
            for (_, r0, s0, e0, b0), (o1, r1, s1, e1, b1) in zip(marks, marks[1:])]


def _rank(rank: int, device: str, cell: dict, bench: dict, seed: int, seconds: float,
          trace: bool, t_start: float, precisions: tuple, rank_init,
          check_run: bool = True) -> dict:
    """One rank of a cell of several cards: this rank's block of the
    global case, the window on the mesh, with ``--trace 1`` the spans'
    blocks, then the check of the block in ringed tiles (`tiles`).
    Returns this rank's part of the run: its records, each window
    period's own and barrier seconds and mesh counts, and what its
    threads did over the window."""
    if rank_init is not None:
        rank_init(rank)
    import torch.distributed as dist
    from wrfchem_arc_interactions_tpu_torch.config import namelist
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh
    from port_bench import guard, host as host_mod, tiles
    from port_bench.reference.runner import Model
    from port_bench.reference.wrf.config import namelist as ref_namelist

    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // cell["chips"])))
    my, mx = spec.mesh_shape(cell)
    mesh = make_mesh(my, mx, device=device)
    # the harness's own messages go between the hosts' memories
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    marks: list = []

    def sync():
        sim.sync()
        t_own = time.perf_counter()
        dist.barrier(group=host)
        marks.append((t_own, time.perf_counter(), sim.step_idx, mesh.exchanges,
                      mesh.bytes_sent))

    def agree(last: bool) -> bool:
        flag = torch.tensor([int(last)])
        dist.broadcast(flag, src=0, group=host)
        return bool(flag.item())

    cfg_spec, traffic = cell["config_spec"], cell["traffic"]
    counted = Model(case.build_config(ref_namelist, cfg_spec))
    cfg = case.build_config(namelist, cfg_spec)
    if cuda:
        torch.cuda.init()
    # set-up: every rank builds the global case from the seed; the
    # Simulation keeps this rank's block
    t_case = time.perf_counter()
    grid, state = ideal.make_case(cfg, cfg_spec["case"], device=device, **cfg_spec["case_args"])
    state = case.seeded_state(state, cfg_spec, traffic, seed)
    excluded_s, start_stats = 0.0, None
    if rank == 0:
        t_check = time.perf_counter()
        start_stats = check.field_stats(state, grid)
        excluded_s = time.perf_counter() - t_check
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    t_sim = time.perf_counter()
    sim = Simulation(cfg, grid, state, mesh=mesh)
    del grid, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        # the block's peak: the global inputs that every rank held are gone
        torch.cuda.reset_peak_memory_stats(device)
    t_warm_0 = time.perf_counter()
    sim.advance(traffic["warmup_steps"])
    sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start - excluded_s
    setup_phases = {"start_s": t_case - t_start, "case_s": t_sim - t_case - excluded_s,
                    "place_s": t_warm_0 - t_sim, "warmup_s": t_warm - t_warm_0}
    _say(f"rank {rank}: set-up {setup_s:.2f} s (step {sim.step_idx}) {setup_phases}")

    snap = window.Snapshot(sim.state, device)
    follow_steps = traffic["check_steps"]
    alloc0 = _alloc_stats(device)
    records = _records(cell, cfg, counted, state_bytes, setup_s)
    # the ranks start the window together; its periods are counted from here
    sync()
    first_mark = len(marks) - 1
    host0 = host_mod.sample()
    measured, breakdown = _window(sim, snap, counted, cell, seconds, trace, device, sync,
                                  agree)
    host_used = host_mod.used(host0, host_mod.sample())
    periods = _periods(marks[first_mark:])
    records.update(measured)
    records["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
    alloc1 = _alloc_stats(device)
    records["allocator"] = {k: alloc1[k] - alloc0[k] for k in alloc1}
    if trace and cuda:
        records["main_peak_bytes"] = _main_peak(sim, device)
    found = guard.jax_modules()
    if found:
        raise RuntimeError(f"rank {rank}: JAX or the JAX package is loaded: {found}")

    # the check: this rank's final block and copy, ringed from the others'
    final = _final_state(sim)
    snap_state, snap_step = snap.state(), snap.step
    if snap_step != sim.step_idx - follow_steps:
        raise RuntimeError(f"the copy is of step {snap_step}, the window ended at "
                           f"{sim.step_idx}")
    if trace:
        records["spans"] = _spans(sim, counted, cell, cuda, sync)
    ys, xs = mesh.window(cfg.domain.ny, cfg.domain.nx)
    del sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    part = {"records": records, "breakdown": breakdown, "periods": periods,
            "host": host_used, "setup_phases": setup_phases,
            "device": _device(device, None, None)}
    if not check_run:
        return dict(part, start=None, maxima=None, tiles=0, reference_s=0.0,
                    check_phases={}, host_peak_bytes=_host_peak())
    t0 = time.perf_counter()
    ref_cfg = case.build_config(ref_namelist, cfg_spec)
    model = Model(ref_cfg)
    start = None
    if rank == 0:
        # the start's statistics are rank 0's alone: only it builds the
        # reference's whole case; the other ranks need its grid
        ref_grid, ref_state = model.case(cfg_spec["case"], device, **cfg_spec["case_args"])
        ref_state = case.seeded_state(ref_state, cfg_spec, traffic, seed)
        start = check.stats_err(start_stats, check.field_stats(ref_state, ref_grid))
        del ref_state
    else:
        ref_grid = model.grid(cfg_spec["case"], device)
    if cuda:
        torch.cuda.empty_cache()
    t_ext = time.perf_counter()
    ext = tiles.extend(snap_state, (my, mx), rank, tiles.RING, group=host)
    del snap_state, snap
    by, bx = ys.stop - ys.start, xs.stop - xs.start
    plan = tiles.plan(by, bx, tiles.RING, tiles.max_columns(
        device, state_bytes // (cfg.domain.nx * cfg.domain.ny)))
    t_tiles = time.perf_counter()
    maxima = tiles.follow(model, ref_grid, ext, (ys.start, xs.start), plan, tiles.RING,
                          snap_step, follow_steps, final, device,
                          [Model(ref_cfg, precision=p) for p in precisions])
    t_end = time.perf_counter()
    reference_s = t_end - t0
    phases = {"case_s": t_ext - t0, "ring_s": t_tiles - t_ext, "tiles_s": t_end - t_tiles}
    _say(f"rank {rank}: {len(plan)} tiles followed; check {reference_s:.1f} s {phases}")
    return dict(part, start=start, maxima=maxima, tiles=len(plan), reference_s=reference_s,
                check_phases=phases, host_peak_bytes=_host_peak())


def _host_peak() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _mesh_counts(parts: list) -> dict:
    """The mesh's point-to-point messages (`Mesh.exchanges`) and bytes
    (`Mesh.bytes_sent`) per step over the window's periods: summed over
    the ranks, each rank's, and each period's sum over the ranks."""
    ranks = []
    for p in parts:
        steps = sum(q["steps"] for q in p["periods"])
        ranks.append({k + "_per_step": sum(q[k] for q in p["periods"]) / steps
                      for k in ("exchanges", "bytes_sent")})
    periods = [{"steps": qs[0]["steps"], **{k: sum(q[k] for q in qs)
                                            for k in ("exchanges", "bytes_sent")}}
               for qs in zip(*(p["periods"] for p in parts))]
    return {"exchanges_per_step": sum(r["exchanges_per_step"] for r in ranks),
            "bytes_sent_per_step": sum(r["bytes_sent_per_step"] for r in ranks),
            "ranks": ranks, "periods": periods}



def _mesh_result(cell: dict, bench: dict, trace: bool, precisions: Sequence[str],
                 parts: list) -> dict:
    """The ranks' parts joined into one run's result: the numbers of the
    whole domain (each field's maxima over every rank's tiles, then
    divided; rank 0's start), rank 0's records with the global shape,
    the largest peak over the cards, the mesh's counts (`_mesh_counts`),
    and with `trace` the busy, window and kernel seconds and each span
    path's seconds summed over the cards (card-seconds, against which the
    metrics' counts of the global shape are read); each rank's periods,
    host and spans under ``ranks``."""
    from port_bench import tiles
    n = len(parts)
    r0 = parts[0]
    ranks = [{"peak_bytes": p["records"]["peak_bytes"],
              "host_peak_bytes": p["host_peak_bytes"], "tiles": p["tiles"],
              "reference_s": p["reference_s"], "check_phases": p["check_phases"],
              "setup_s": p["records"]["setup_s"], "setup_phases": p["setup_phases"],
              "periods": p["periods"], "host": p["host"]} for p in parts]
    for p, row in zip(parts, ranks):
        if "trace" in p["records"]:
            row.update(busy_s=p["records"]["trace"]["busy_s"],
                       window_s=p["records"]["trace"]["window_s"])
        if "spans" in p["records"]:
            row["spans"] = {
                path: {k: r[k] for k in ("device_s", "idle_s", "lead_median_s")}
                for path, r in p["records"]["spans"]["paths"].items()}
    records = r0["records"]
    peaks = [p["records"]["peak_bytes"] for p in parts]
    records["peak_bytes"] = None if None in peaks else max(peaks)
    if "main_peak_bytes" in records:
        records["main_peak_bytes"] = max(p["records"]["main_peak_bytes"] for p in parts)
    if "trace" in records:
        t = records["trace"]
        t["busy_s"] = sum(p["records"]["trace"]["busy_s"] for p in parts)
        t["window_s"] = sum(p["records"]["trace"]["window_s"] for p in parts)
        kernels: dict = {}
        for p in parts:
            for name, (calls, secs) in p["records"]["trace"]["kernels"].items():
                c0, s0 = kernels.get(name, (0, 0.0))
                kernels[name] = (c0 + calls, s0 + secs)
        t["kernels"] = kernels
        t["cards"] = n
    if "spans" in records:
        sp = records["spans"]
        for path, row in sp["paths"].items():
            for k in SPAN_SUMS:
                row[k] = sum(p["records"]["spans"]["paths"].get(path, {}).get(k, 0.0)
                             for p in parts)
        sp["cards"] = n
    records["mesh"] = _mesh_counts(parts)
    records["ranks"] = ranks
    device_info = dict(r0["device"], count=n, memory_peak_bytes=records["peak_bytes"])
    if "trace" in records:
        device_info["busy_s"] = records["trace"]["busy_s"] / n
        device_info["window_s"] = records["trace"]["window_s"] / n
    if r0["maxima"] is None:          # a probe's run without the check
        return _result(cell, bench, trace, records, {}, device_info, r0["breakdown"])
    errs = check.errs_from_maxima(check.merge_maxima(p["maxima"]["state"] for p in parts))
    start_err, start_where = r0["start"]
    numbers = {"start_err": start_err, "start_field": start_where,
               **check.state_numbers(errs), "fields": len(errs),
               "reference_s": max(p["reference_s"] for p in parts),
               "top_fields": sorted(errs.items(), key=lambda kv: -kv[1])[:5],
               "tiles": sum(p["tiles"] for p in parts), "ring": tiles.RING}
    for prec in precisions:
        low = check.errs_from_maxima(check.merge_maxima(p["maxima"][prec] for p in parts))
        control = {"start_err": 0.0, **check.state_numbers(low)}
        for k, v in control.items():
            numbers[f"control.{prec}.{k}"] = v
        numbers[f"control.{prec}.correct"] = check.verdict(control, cell["limits"])
    return _result(cell, bench, trace, records, numbers, device_info, r0["breakdown"])


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
