"""Probes of the multi-card path on the cards, beside the benchmark's cells:

    python3 -m port_bench.mesh_probe [--out <file>] mesh [--smoke 200] [--sizes 1000,900,800] \
        [--runs 3] [--seconds 30] [--seeds a,b,c] [--control tf32] [--traced 0] [--check 1]
    python3 -m port_bench.mesh_probe [--out <file>] tiles [--size 200] [--reach 96]

``mesh`` runs arc_block's package (``configs/arc_block.json``) on a 2x2
mesh of four cards at the global sizes of `--sizes` in turn, until one
runs (``parallel`` 2x2, nx = ny = the size; after one short run at the
`--smoke` size), through `harness.measure`, the
entry that `port_bench.run` takes for a cell of several cards, with the
traffic and limits of ``arc_block.main``; `BENCHMARK.json` is not read
for the cell.  A size whose first run fails is recorded with its error
and the next is tried; a size that runs gets `--runs` runs on distinct
seeds, the first with the `--control` precision followed in the port's
place.  Each run prints one JSON line: `correct`, the numbers compared,
the metrics, each card's peak and each rank's host peak, the set-up,
period and check seconds and the run's wall seconds, each rank's own and
barrier seconds of every period, what its threads did over the window
(`port_bench.host`) and the mesh's counts; each size a line with the
spread of `gridpoints_per_s`.  With ``--check 0`` the ranks stop after
the window (a spread's runs: the check runs after the window and moves
none of its numbers).  The first line describes the host: its cores, its
NUMA nodes, the cards' topology and the cgroup's CPU limit.

``tiles`` runs on one card: the reference's follow of a `--size` square
domain in the ringed tiles of a 2x2 mesh's blocks (`port_bench.tiles`)
against its follow of the whole domain, and the reach of the followed
steps (`tiles.reach`) at a `--reach` square domain with the
configuration's own levels.

With ``--out <file>`` every line is also appended to that file.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time
from typing import Optional


def _cell(size: int) -> dict:
    from port_bench import spec
    cell = copy.deepcopy(spec.workload(spec.benchmark(), "arc_block.main"))
    cell["name"], cell["chips"] = f"config5_mesh.probe{size}", 4
    cell["config_spec"]["namelist"]["domain"].update(nx=size, ny=size)
    cell["config_spec"]["namelist"]["parallel"] = {"mesh_y": 2, "mesh_x": 2}
    return cell


def _out(line: dict, path: Optional[str]) -> None:
    """`line` as JSON on standard output and, where `path` is given,
    appended to that file."""
    text = json.dumps(line, default=str)
    print(text, flush=True)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(text + "\n")


def _spread(values) -> dict:
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"values": values, "median": med, "iqr_share": (q3 - q1) / med,
            "range_share": (max(values) - min(values)) / med}


def _runs(bench, size: int, seeds, seconds: float, control, out: Optional[str],
          trace: bool = False, check: bool = True) -> list:
    """Runs of the 2x2 cell at `size` on `seeds` (the first with the
    control), each printed; their `gridpoints_per_s`, or None where one
    failed (its error printed).  With `trace`, profiled runs: each prints
    the joined trace (card-seconds), the phases, the breakdown, the spans,
    the mesh's counts and each rank's own."""
    from port_bench import harness
    cell = _cell(size)
    gps = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        try:
            res = harness.measure(cell, bench, seed, seconds, trace,
                                  [f"cuda:{r}" for r in range(4)], t0,
                                  precisions=(control,) if i == 0 and control else (),
                                  check=check)
        except Exception as err:    # a size that does not run: recorded, the next tried
            _out({"size": size, "seed": seed, "run": i, "failed": True,
                  "wall_s": time.perf_counter() - t0,
                  "error": str(err).strip().splitlines()[-1][:2000],
                  "traceback_tail": str(err)[-4000:]}, out)
            return None
        rec, num = res["records"], res["numbers"]
        if trace:
            kernels = rec["trace"]["kernels"]
            _out({"size": size, "seed": seed, "traced": True,
                  "correct": res["correct"], "metrics": res["metrics"],
                  "device": res["device"], "breakdown": res.get("breakdown"),
                  "trace": {k: v for k, v in rec["trace"].items() if k != "kernels"},
                  "nccl_s": {k: v for k, v in kernels.items() if k.startswith("nccl")},
                  "phases": rec["phases"], "spans": rec.get("spans"), "mesh": rec["mesh"],
                  "ranks": rec["ranks"], "state_err": num.get("state_err"),
                  "wall_s": time.perf_counter() - t0}, out)
            continue
        _out({"size": size, "seed": seed, "run": i, "correct": res["correct"],
              "wall_s": time.perf_counter() - t0, "metrics": res["metrics"],
              "device": res["device"],
              "numbers": {k: v for k, v in num.items() if k != "top_fields"},
              "top_fields": num.get("top_fields"), "window": rec["window"],
              "mesh": rec["mesh"], "ranks": rec["ranks"], "state_bytes": rec["state_bytes"],
              "probe_host_peak_bytes": _host_peak()}, out)
        gps.append(res["metrics"]["gridpoints_per_s"]["value"])
    return gps


def mesh(args) -> int:
    import torch
    from port_bench import spec
    if torch.cuda.device_count() < 4:
        print("the mesh probe runs on four cards", file=sys.stderr)
        return 3
    bench = spec.benchmark()
    seeds = [int(s) for s in args.seeds.split(",")]
    _out(_host_line(), args.out)
    if args.smoke:
        # a short run at a small size first: a fault of the path shows in seconds
        _runs(bench, args.smoke, seeds[-1:], 0.0, None, args.out)
    ran = None
    for size in (int(s) for s in args.sizes.split(",")):
        gps = _runs(bench, size, seeds[:args.runs], args.seconds, args.control, args.out,
                    check=bool(args.check))
        if gps is not None:
            _out({"size": size, "gridpoints_per_s": _spread(gps) if len(gps) > 2 else gps},
                 args.out)
            ran = size
            if args.traced:
                _runs(bench, size, seeds[args.runs:args.runs + args.traced], args.seconds,
                      None, args.out, trace=True, check=bool(args.check))
            break
    _out({"largest_size_run": ran, "card": torch.cuda.get_device_name(0)}, args.out)
    return 0 if ran else 1


def _host_line() -> dict:
    """The host's cores, NUMA nodes, the cards' topology and the cgroup's
    CPU limit, as its tools and files give them (read only)."""
    import subprocess

    def cmd(*argv):
        try:
            return subprocess.run(argv, capture_output=True, text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError) as err:
            return f"({argv[0]}: {err})"

    def text(path):
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None

    return {"host": True, "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "cgroup_cpu_max": text("/sys/fs/cgroup/cpu.max"),
            "numa_nodes": text("/sys/devices/system/node/online"),
            "lscpu": [line for line in cmd("lscpu").splitlines()
                      if line.split(":")[0].strip() in
                      ("CPU(s)", "On-line CPU(s) list", "Thread(s) per core", "Core(s) per socket",
                       "Socket(s)", "NUMA node(s)", "Model name", "CPU MHz", "CPU max MHz")
                      or line.startswith("NUMA node")],
            "topo": cmd("nvidia-smi", "topo", "-m"),
            "gpus": cmd("nvidia-smi", "--query-gpu=index,name,pci.bus_id,power.limit,clocks.sm",
                        "--format=csv,noheader")}


def _host_peak() -> int:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def tiles_probe(args) -> int:
    import torch
    from port_bench import case, check, spec, tiles
    from port_bench.reference.runner import Model
    from port_bench.reference.wrf.config import namelist
    if not torch.cuda.is_available():
        print("the tiles probe runs on a card", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    cell = spec.workload(spec.benchmark(), "arc_block.main")

    def reference(n):
        cs = copy.deepcopy(cell["config_spec"])
        cs["namelist"]["domain"].update(nx=n, ny=n)
        model = Model(case.build_config(namelist, cs))
        grid, state = model.case(cs["case"], device, **cs["case_args"])
        return model, grid, case.seeded_state(state, cs, cell["traffic"], args.seed)

    first, steps = 10, cell["traffic"]["check_steps"]
    model, grid, state = reference(args.reach)
    n = args.reach
    columns = [(n * a // 8, n * b // 8) for a, b in
               ((4, 4), (1, 6), (6, 1), (2, 2), (7, 5), (3, 7), (5, 3), (0, 0))]
    for k in range(1, steps + 1):
        t0 = time.perf_counter()
        far = tiles.reach(model, grid, state, first, k, columns)
        _out({"probe": "reach", "size": n, "nz": grid.nz, "steps": [first, first + k - 1],
              "columns": len(columns), "reach": far, "ring": tiles.RING,
              "seconds": time.perf_counter() - t0}, args.out)
    del model, grid, state
    torch.cuda.empty_cache()

    n = args.size
    model, grid, state = reference(n)
    t0 = time.perf_counter()
    whole = dict(state)
    for k in range(first, first + steps):
        whole = model.step(whole, grid, k)
    whole = {k: v.cpu() for k, v in whole.items()}
    whole_s = time.perf_counter() - t0
    host = {k: v.cpu() for k, v in state.items()}
    del state
    torch.cuda.empty_cache()
    b = n // 2
    parts = []
    t0 = time.perf_counter()
    for r in range(4):
        iy, ix = divmod(r, 2)
        ys, xs = slice(iy * b, iy * b + b), slice(ix * b, ix * b + b)
        # the block ringed from the global copy with the wrap, as extend gives it
        gy = tiles.ring_index(ys.start, b, tiles.RING, n)
        gx = tiles.ring_index(xs.start, b, tiles.RING, n)
        ext = {k: v.index_select(-2, gy).index_select(-1, gx) for k, v in host.items()}
        block = {k: v[..., ys, xs] for k, v in host.items()}
        inner = (..., slice(tiles.RING, -tiles.RING), slice(tiles.RING, -tiles.RING))
        if not all(torch.equal(ext[k][inner], block[k]) for k in block):
            raise RuntimeError("the ringed block does not hold the block")
        plan = tiles.plan(b, b, tiles.RING, (b // 2 + 2 * tiles.RING) * (b + 2 * tiles.RING))
        final = {k: v[..., ys, xs] for k, v in whole.items()}
        parts.append(tiles.follow(model, grid, ext, (ys.start, xs.start), plan, tiles.RING,
                                  first, steps, final, device)["state"])
    maxima = check.merge_maxima(parts)
    errs = check.errs_from_maxima(maxima)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    _out({"probe": "tiles_vs_whole", "size": n, "ring": tiles.RING, "tiles_per_block": len(plan),
          "bitwise": all(m[2] for m in maxima.values()), "worst": worst,
          "fields_not_bitwise": sum(1 for m in maxima.values() if not m[2]),
          "whole_s": whole_s, "tiles_s": time.perf_counter() - t0,
          "card": torch.cuda.get_device_name(0)}, args.out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.mesh_probe")
    p.add_argument("--out", help="a file each line is also appended to")
    sub = p.add_subparsers(dest="probe", required=True)
    m = sub.add_parser("mesh")
    m.add_argument("--smoke", type=int, default=200,
                   help="one short run at this size first (0: none)")
    m.add_argument("--sizes", default="1000,900,800",
                   help="tried in turn until one runs")
    m.add_argument("--runs", type=int, default=3)
    m.add_argument("--seconds", type=float, default=30.0)
    m.add_argument("--seeds", default="3000000019,3000000037,3000000041")
    m.add_argument("--control", default="tf32", help="'' for none")
    m.add_argument("--traced", type=int, default=0,
                   help="profiled runs after the spread's, on the seeds after theirs")
    m.add_argument("--check", type=int, choices=(0, 1), default=1,
                   help="0: the ranks stop after the window")
    t = sub.add_parser("tiles")
    t.add_argument("--size", type=int, default=200)
    t.add_argument("--reach", type=int, default=96)
    t.add_argument("--seed", type=int, default=3000000053)
    args = p.parse_args(argv)
    from port_bench import spec
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = spec.config("arc_block")["allocator"]
    return mesh(args) if args.probe == "mesh" else tiles_probe(args)


if __name__ == "__main__":
    sys.exit(main())
