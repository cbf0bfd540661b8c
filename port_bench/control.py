"""Readings that a cell's limits are set from, on the card, in one process:

    python3 -m port_bench.control --workload <cell> --seeds 11,12,... \
        [--control-seeds 3] [--precisions tf32,bfloat16]

For each seed, one run of one period (the window at its shortest, with the
cell's traffic and sizes, on as many cards as the cell asks for, through
`harness.measure`, so that a cell of several cards is followed in ringed
tiles and its controls too) and its check: each number of the cell's
limits for the port, the lower readings.  For the first `--control-seeds` seeds
also the control: the reference in each lower precision, followed from the
same copy of the port's state, held to the float32 reference by the same
number, the upper readings.  One JSON line per seed on standard output,
then a line with the largest lower and the smallest upper readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    from port_bench import spec
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--precisions", default="tf32,bfloat16")
    args = p.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell["config_spec"]["allocator"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the control runs on {cell['chips']} card(s)", file=sys.stderr)
        return 3
    from port_bench import harness
    devices = [f"cuda:{i}" for i in range(cell["chips"])]
    precisions = [x for x in args.precisions.split(",") if x]
    lower, upper, verdicts, sound = {}, {}, {}, True
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = harness.measure(cell, bench, seed, 0.0, False, devices, time.perf_counter(),
                              precisions=precisions if i < args.control_seeds else ())
        numbers = res["numbers"]
        line = {"seed": seed, "correct": res["correct"],
                **{k: v for k, v in numbers.items() if k != "top_fields"},
                "top_fields": numbers["top_fields"]}
        print(json.dumps(line, default=str), flush=True)
        sound = sound and res["correct"]
        for k in cell["limits"]:
            lower[k] = max(lower.get(k, 0.0), numbers[k])
            for p_ in precisions:
                key = f"control.{p_}.{k}"
                if key in numbers:
                    upper[key] = min(upper.get(key, float("inf")), numbers[key])
        for p_ in precisions:
            if f"control.{p_}.correct" in numbers:
                verdicts.setdefault(p_, []).append(numbers[f"control.{p_}.correct"])
        del res
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "control_correct": verdicts, "card": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0 if sound and not any(any(v) for v in verdicts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
