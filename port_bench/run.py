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

It exits with another code than 0, and prints no result, without the
cards the cell asks for, when the port cannot be imported, or when JAX or
the JAX package has been loaded by the time the window closes.
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
    # the allocator reads its setting when the card is first used
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell["config_spec"]["allocator"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from port_bench import guard, harness
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = harness.run(cell, bench, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         T_START)
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
