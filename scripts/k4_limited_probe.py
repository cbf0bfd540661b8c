"""Probe the multi-tracer kernel's limited grid on one NVIDIA GPU: this
tree's `limited_kernel` against other shapes of its block, a floor without
plane copies, a copy that reads the clock per phase, and (with --parent)
another checkout's limited stage, in turns on the same inputs.

    python3 scripts/k4_limited_probe.py [--parent DIR] [--out FILE]

Variants are this tree's ``csrc/advect_tracers.cu`` edited in memory and
built beside it (`build.register_generated`); none is a supported
configuration:

- ``t256x4_r2``, ``t256x4_r1``, ``t384x3_r1``, ``t256x2_r2``: threads a
  block, slots a thread and blocks meant to share an SM (``L_THREADS``,
  ``L_CPT``, ``L_RESIDENT``), the plan sizing its tiles to the slots;
- ``nocopy``: no plane of q, ru or rv fetched during the march (a wrong
  result, timed only: what the copies cost);
- ``clock``: this tree's grid with each warp's clock read at the march's
  phase boundaries, the cycles per iteration written through the r_hi
  pointer (unused by the limited grid) for the first 64 blocks: the top
  barrier, the copies and the slots' loads, phase A, the barrier after it,
  B, the barrier after it, C.

For each: every instance's registers and local (spill) bytes
(`tracers_kernel.plan`), the checked variants bitwise against the plain
version into outputs filled with NaN, and the device time per call
(chip_smoke.py's `_device_ms`) at config 5's per-card block (107, 60, 500,
500) and at (107, 50, 100, 100), on chip_smoke.py's `tracer_inputs`.
Prints JSON lines and writes them to FILE (default ``k4_limited_probe.json``
in the package's ``build/`` directory).  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from kernel_ab_gpu import tracers_call  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import build, tracers_kernel  # noqa: E402

SHAPES = {"t256x4_r2": (256, 4, 2), "t256x4_r1": (256, 4, 1), "t384x3_r1": (384, 3, 1),
          "t256x2_r2": (256, 2, 2)}
CASES = ((500, 500, 60, 107), (100, 100, 50, 107))
TOP_COPIES = "    if (k + 3 < nz) fetch_q(k + 3);\n    if (k + 2 < nz) fetch_v(k + 2);\n"
# (marker, what goes in its place) for the clock copy; marker once in the
# limited grid, after the seam grids' code
CLOCK = (
    ("  for (int k = -1; k <= nz; ++k) {\n    copies_land();\n    __syncthreads();\n",
     "  unsigned acc[7] = {0, 0, 0, 0, 0, 0, 0};\n  for (int k = -1; k <= nz; ++k) {\n"
     "    const unsigned c0 = clock();\n    copies_land();\n    __syncthreads();\n"
     "    const unsigned c1 = clock();\n    acc[0] += c1 - c0;\n"),
    ("    // ---- A: faces", "    const unsigned c2 = clock();\n    acc[1] += c2 - c1;\n"
     "    // ---- A: faces"),
    ("    __syncthreads();\n\n    // ---- B:",
     "    const unsigned c3 = clock();\n    acc[2] += c3 - c2;\n    __syncthreads();\n"
     "    const unsigned c4 = clock();\n    acc[3] += c4 - c3;\n\n    // ---- B:"),
    ("    __syncthreads();\n\n    // ---- C:",
     "    const unsigned c5 = clock();\n    acc[4] += c5 - c4;\n    __syncthreads();\n"
     "    const unsigned c6 = clock();\n    acc[5] += c6 - c5;\n\n    // ---- C:"),
    ("      phi_c[m] = phi_n[m];\n    }\n  }\n}",
     "      phi_c[m] = phi_n[m];\n    }\n    acc[6] += clock() - c6;\n  }\n"
     "  if ((threadIdx.x & 31) == 0 && blockIdx.x < 64) {\n"
     "    unsigned* d = reinterpret_cast<unsigned*>(a.r_hi) +\n"
     "                  (blockIdx.x * (L_THREADS / 32) + threadIdx.x / 32) * 8;\n"
     "    for (int e = 0; e < 7; ++e) d[e] = acc[e];\n    d[7] = nz;\n  }\n}"),
)
PHASES = ("top barrier", "copies and loads", "A", "barrier after A", "B", "barrier after B", "C")


def _limited_part(text: str) -> int:
    return text.index("__global__ void __launch_bounds__(L_THREADS, L_RESIDENT) limited_kernel")


def variant(text: str, key: str) -> str:
    """This tree's source as variant `key`."""
    if key in SHAPES:
        th, cpt, res = SHAPES[key]
        for name, value in (("L_THREADS", th), ("L_CPT", cpt), ("L_RESIDENT", res)):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            assert n == 1, name
        return text
    i = _limited_part(text)
    head, tail = text[:i], text[i:]
    if key == "nocopy":
        assert tail.count(TOP_COPIES) == 1
        return head + tail.replace(TOP_COPIES, "")
    for old, new in CLOCK:
        assert tail.count(old) == 1, old
        tail = tail.replace(old, new)
    return head + tail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose limited stage to time")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "k4_limited_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_limited_probe: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = cs._card()
    print(card)
    with open(build._source("advect_tracers")) as f:
        text = f.read()
    names = {"this": "advect_tracers"}
    for key in (*SHAPES, "nocopy", "clock"):
        build.register_generated(f"probe_{key}", variant(text, key))
        names[key] = f"probe_{key}"
    if args.parent:
        with open(os.path.join(args.parent, "wrfchem_arc_interactions_tpu_torch", "csrc",
                               "advect_tracers.cu")) as f:
            build.register_generated("probe_parent", f.read())
        names["parent"] = "probe_parent"
    t0 = time.perf_counter()
    build.build_all(list(names.values()))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    libs = {key: build.load(name) for key, name in names.items()}
    out = {"card": card, "registers_local": {}, "rows": []}
    for key, lib in libs.items():
        if key != "parent":
            out["registers_local"][key] = {
                f"{'x tiles' if nx > 200 else 'one tile'}, {'m2' if msf else 'flat'}":
                [tracers_kernel.plan(lib, True, 107, 60, ny, nx, msf=msf)[0][f]
                 for f in ("registers", "local_bytes")]
                for ny, nx in ((500, 500), (50, 50)) for msf in (False, True)}
    print(json.dumps({"registers_local": out["registers_local"]}))
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    for nx, ny, nz, nt in CASES:
        grid, _ = ideal.make_case(cs._cfg3(nx=nx, ny=ny, nz=nz, rad_chem=False), "squall2d_x",
                                  device=dev, bubble_amp=3.0)
        targs, pt, _ = cs.tracer_inputs(dev, grid, nt)
        shape = (nt, nz, ny, nx)
        o = torch.empty(shape, device=dev)
        r_hi = torch.empty_like(o)
        ref = torch.empty_like(o)
        for a in range(0, nt, 8):
            b = min(nt, a + 8)
            ref[a:b] = tracers_kernel.advect_tracers_reference(
                targs[0][a:b], targs[1][a:b], *targs[2:], pt=pt[a:b], pd=True, clip=True)
        calls = {key: tracers_call(lib, targs, pt, True, o, r_hi) for key, lib in libs.items()}
        row = {"shape": list(shape)}
        for key, call in calls.items():
            o.fill_(float("nan"))
            r_hi.zero_()
            call()
            torch.cuda.synchronize()
            equal = bool(torch.equal(o, ref))
            row[f"{key}_bitwise"] = equal
            if not equal and key != "nocopy":
                raise RuntimeError(f"{key} at {shape}: not bitwise its plain version")
            if key == "clock":
                warps = int(re.search(r"constexpr int L_THREADS = (\d+);", text).group(1)) // 32
                d = r_hi.view(-1)[:64 * warps * 8].view(torch.int32).cpu().view(64, warps, 8)
                per = d[..., :7].double() / float(nz + 2)
                row["clock_cycles_per_iteration"] = dict(
                    zip(PHASES, [round(float(v), 1) for v in per.mean(dim=(0, 1))]))
        del ref
        timed = [k for k in calls if k != "clock"]
        big = nx * ny > 10 ** 5
        for key in timed + timed[::-1]:
            row.setdefault(f"{key}_ms", []).append(
                cs._device_ms(calls[key], calls=2 if big else 10, trials=5 if big else 20))
        print(json.dumps(row) + f" [{card}]")
        out["rows"].append(row)
        del targs, pt, o, r_hi, calls, grid
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
