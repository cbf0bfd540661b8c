"""The port's benchmark: one run of one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (an entry of ``BENCHMARK.json``), its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and the
metrics (``BENCHMARK.json``, read by ``metrics/<metric>.py``) are found by
name.  The run builds the case from
the seed, warms up, measures whole alarm periods for about `seconds`, then
checks the window's result against the plain reference.  Its last line on
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``:
each number compared, with its limit, which also close standard error.

A cell of one card runs in this process on ``cuda:0``.  A cell of
``chips`` > 1 runs its configuration's ``parallel`` mesh (mesh_y x mesh_x
blocks, one a card; a mesh of another size is refused with exit code 2):
one rank a card over NCCL, started by the port's `parallel.launch.spawn`,
each stepping its block of the global case through the port's
`Simulation(..., mesh=...)`.  Every period closes with each rank's
synchronisation and a barrier, so the clock of rank 0 times the slowest;
each rank checks its block in ringed tiles (`port_bench.tiles`), and this
process joins the ranks' parts into the one line (`harness._mesh_result`)
once every rank has returned.

It exits with another code than 0, and prints no result, without the
cards the cell asks for, when the port cannot be imported, when a rank
fails, or when JAX or the JAX package has been loaded by the time the
window closes (in this process, or in a rank).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import spec  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    try:
        spec.mesh_shape(cell)
    except ValueError as err:
        print(err, file=sys.stderr)
        return 2
    # the allocator reads its setting when the card is first used; ranks
    # inherit it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell["config_spec"]["allocator"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return execute(cell, bench, args.seed, args.seconds, bool(args.trace),
                   [f"cuda:{i}" for i in range(cell["chips"])], T_START)


def execute(cell: dict, bench: dict, seed: int, seconds: float, trace: bool, devices,
            t_start: float, rank_init=None) -> int:
    """The run of `cell` on `devices` (`harness.measure`), its report on
    standard error and its line on standard output; the exit code."""
    from port_bench import guard, harness
    result = harness.measure(cell, bench, seed, seconds, trace, devices, t_start,
                             rank_init=rank_init)
    found = guard.jax_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 4
    records, numbers = result.pop("records"), result.pop("numbers")
    harness.report(records, numbers)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback
        traceback.print_exc()
        code = 1
    sys.exit(code)
