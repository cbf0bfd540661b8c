"""Where the periods of a benchmark cell go, layer by layer: the port's
spans (`wrfchem_arc_interactions_tpu_torch.utils.trace`) on the card.

    python3 scripts/span_breakdown.py --workload arc_block.main --seed 12345 \
        --out chiprun_out/spans.json

Builds the cell's case from the seed and warms up as `port_bench.run`
does, then runs whole alarm periods of the cell's traffic, each closed by
a synchronisation: two pairs of one with tracing off and one with the
spans on (host clock: the spans' cost); one profiled with tracing off
(`port_bench.trace`, whose kernel count `launches_per_step` reads); block
(a) and block (b) of `port_bench.spans.traced_blocks` (the traffic's
``traced_periods`` each); and one with `phase_timing` (what
`main_step_ms` and `chem_call_ms` read).  Last, the host's time for one empty span, on and
off.  Writes every reading to `--out` and prints the per-step figures on
standard output.  `--device cpu --shape 16,8,12` rehearses it on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch
        return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="arc_block.main")
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", default=None, help="nx,ny,nz in place of the cell's")
    ap.add_argument("--out", default="chiprun_out/spans.json")
    args = ap.parse_args(argv)

    from port_bench import spec
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell["config_spec"]["allocator"]
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import case, spans, window
    from port_bench import trace as trace_mod
    from wrfchem_arc_interactions_tpu_torch.config import namelist
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.utils import trace

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cfg_spec, traffic = cell["config_spec"], cell["traffic"]
    if args.shape:
        nx, ny, nz = (int(v) for v in args.shape.split(","))
        cfg_spec["namelist"]["domain"].update(nx=nx, ny=ny, nz=nz)
    cfg = case.build_config(namelist, cfg_spec)
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, cfg_spec["case"], device=device,
                                  **cfg_spec["case_args"])
    state = case.seeded_state(state, cfg_spec, traffic, args.seed)
    sim = Simulation(cfg, grid, state, device=device)
    del grid, state
    sim.advance(traffic["warmup_steps"])
    sim.sync()
    setup_s = time.perf_counter() - t0
    steps = traffic["period_steps"]
    first = sim.step_idx
    chem_calls = window.alarm_calls(sim.chem_every, first, steps)

    def period():
        sim.advance(steps)

    def timed(traced: bool) -> float:
        if traced:
            trace.start(device)
        t = time.perf_counter()
        period()
        sim.sync()
        seconds = time.perf_counter() - t
        if traced:
            trace.flush()
            trace.stop()
        return seconds

    def span_cost(on: bool, n: int = 1000, rounds: int = 10) -> float:
        """Host microseconds of one empty span, a period's worth at a time."""
        total = 0.0
        for _ in range(rounds):
            if on:
                trace.start(device)
            t = time.perf_counter()
            for _ in range(n):
                with trace.span("probe"):
                    pass
            total += time.perf_counter() - t
            trace.stop()
        return 1e6 * total / (n * rounds)

    out = {"card": _card(device), "workload": args.workload, "seed": args.seed,
           "shape": [cfg.domain.nx, cfg.domain.ny, cfg.domain.nz], "setup_s": setup_s,
           "period_steps": steps, "chem_calls_per_period": chem_calls}
    pairs = [(timed(False), timed(True)) for _ in range(2)]
    out["untraced_s"] = [u for u, _ in pairs]
    out["spans_on_s"] = [t for _, t in pairs]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(trace_mod.WINDOW):
            period()
            sim.sync()
    off = trace_mod.reduce(trace_mod.events(prof))
    del prof
    out["profiled_off"] = off
    blocks = traffic["traced_periods"]
    out["blocks"] = spans.traced_blocks(sim, period, blocks, cuda)
    sim.advance(steps, phase_timing=True)
    out["phase_times"] = dict(sim.phase_times)
    sim.sync()
    out["span_us_off"] = span_cost(False)
    out["span_us_on"] = span_cost(True)

    b = out["blocks"]["b"]["spans"]
    a = out["blocks"]["a"]
    n_steps, n_chem = blocks * steps, blocks * chem_calls
    by = a["by_span"]
    main_launch = spans.under(by, "main")["launches"] / n_steps
    chem_launch = spans.under(by, "chem")["launches"] / max(n_chem, 1)
    period_b = out["blocks"]["b"]["period_s"]
    spans_per_period = sum(s["count"] for s in b.values()) / blocks
    figures = {
        "main_span_ms": b["main"]["device_ms"] / n_steps,
        "dycore_span_ms": b["main/dycore"]["device_ms"] / n_steps,
        "physics_span_ms": (b["main/pre_physics"]["device_ms"]
                            + b["main/post_physics"]["device_ms"]) / n_steps,
        "chem_span_ms": b["chem"]["device_ms"] / max(b["chem"]["count"], 1),
        "main_launches_per_step": main_launch,
        "chem_launches_per_call": chem_launch,
        "main_step_ms": 1e3 * out["phase_times"]["main"] / steps,
        "chem_call_ms": 1e3 * out["phase_times"]["chem"] / max(chem_calls, 1),
        "step_spans_s_over_period_b": b["step"]["device_ms"] * 1e-3 / (period_b * blocks),
        "kernel_events_a": a["kernel_events"],
        "unattributed_launches": a["unattributed_launches"],
        "launches_a": a["launches"],
        "launches_profiled_off": off["launches"],
        "launches_a_from_spans": main_launch * steps + chem_launch * chem_calls,
        "kernels_off_less_a": {k: n - a["kernels"].get(k, 0)
                               for k, (n, _) in off["kernels"].items()
                               if n != a["kernels"].get(k, 0)},
        "period_untraced_s": out["untraced_s"],
        "period_spans_on_s": out["spans_on_s"],
        "period_a_s": a["period_s"],
        "period_b_s": period_b,
        "spans_per_step": spans_per_period / steps,
        "span_us_on": out["span_us_on"],
        "span_us_off": out["span_us_off"],
        "lead_min_ms": {p: s["lead_min_ms"] for p, s in b.items()},
    }
    figures["main_span_over_step"] = figures["main_span_ms"] / figures["main_step_ms"]
    figures["parts_over_main"] = ((figures["dycore_span_ms"] + figures["physics_span_ms"])
                                  / figures["main_span_ms"])
    out["figures"] = figures
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({"card": out["card"], **{k: v for k, v in figures.items()
                                               if k != "lead_min_ms"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
