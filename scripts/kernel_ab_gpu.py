"""Time the scalar advection kernel, the Mie evaluator and the multi-tracer
stage-update kernel on one NVIDIA GPU: this tree's sources and (with
--parent) the same three sources of another checkout, in turns on the same
inputs, beside the scalar kernel's floors.

    python3 scripts/kernel_ab_gpu.py [--parent DIR] [--kernels adv,mie,tracers] [--out FILE]

DIR is the root of another checkout (for example a `git archive` of the
parent commit unpacked into a directory that .gitignore lists): its
``csrc/advect_scalar_5_3.cu``, ``csrc/mie_cheb_eval.cu`` and
``csrc/advect_tracers.cu`` are built with the flags of their design and
called through their C entry points, which take the same arguments as this
tree's.  A Mie kernel that exports ``mie_cheb_eval_shape`` reads the packed
corner table and is built as this tree's (multiply-adds contracted); an
older one reads the (90, 80) grid matrix and was built with
``--fmad=false``, as every other kernel is.  Every kernel is
first checked against its plain version on the same inputs (the scalar and
multi-tracer kernels bitwise, the Mie kernels to 3.2e-4).

It prints, and writes as JSON to FILE (default ``kernel_ab.json`` in the
package's ``build/`` directory):

- the SASS instructions of each kernel by opcode (``cuobjdump``);
- scalar advection at (50, 106, 106), the main path's shape: the parent's
  kernel and this tree's in turns (parent, this, this, parent); the
  floors: an empty kernel on each grid, and a kernel that reads each input
  once and writes the output; the parent's kernel with its flux arithmetic
  replaced by plain sums of the same operands (what its loads cost without
  the arithmetic);
- the Mie evaluator at 30 x 500,000 elements on random inputs, on
  warp-coherent ones, on runs of 8 elements in one cell (a quarter-warp's),
  and on config 4's own (each bin's call of one chem call of
  chip_smoke.py's config 4 after two steps): the parent's kernel and this
  tree's in turns;
- the multi-tracer kernel on chip_smoke.py's stage inputs
  (`tracer_inputs`) at slice 6's 219 scalars, config 4's 107 and config
  3's 47 on the 100x100x50 squall grid, at 47 on a 1000x100x50 one, at
  107 on config 5's per-card block (500x500x60) and on slice 10's 50x50x50
  block, each without the limiter and with PD limiter and clip: the
  parent's kernel (it must take rows of any width, as one with x tiles
  does; with the limiter it may launch two grids, and gets an r_hi scratch
  that this tree's one grid leaves unused) and this tree's in turns
  (parent, this, this, parent), beside the bound of chip_smoke.py's
  `_tracers_bound` and this tree's plan of each grid
  (`tracers_kernel.plan`: tile, blocks an SM, registers, spill bytes).  The
  plain version is held bitwise over slices of 8 tracers, each checked call
  writing into outputs filled with NaN.  On the 50x50x50 block also the
  seam grids (`advect_tracers_seam`, seams on all four sides, the limiter):
  the parent's and this tree's in turns, their outputs bitwise equal.

``--kernels`` picks the sections (all three by default).

Times are device time per call (chip_smoke.py's device-sleep method, warm
L2).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import (  # noqa: E402
    adv_kernel, build, mie_kernel, tracers_kernel,
)

CSRC = os.path.join("wrfchem_arc_interactions_tpu_torch", "csrc")

# (nx, ny, nz, scalar counts) of the multi-tracer section
TRACER_SHAPES = ((100, 100, 50, (219, 107, 47)), (1000, 100, 50, (47,)), (500, 500, 60, (107,)),
                 (50, 50, 50, (107,)))
TRACER_SLICE = 8              # tracers of one plain-version pass

# an empty kernel, and one that reads four float4 arrays once (a grid-stride
# sum per thread) and writes one: the floors of a short memory-bound call
FLOORS_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void read_write_kernel(const float4* a, long long na, const float4* b,
                                  long long nb, const float4* c, long long nc,
                                  const float4* d, long long nd, float4* out,
                                  long long no) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long st = (long long)gridDim.x * blockDim.x;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long e = i; e < na; e += st) { s.x += a[e].x; s.y += a[e].y; s.z += a[e].z; s.w += a[e].w; }
  for (long long e = i; e < nb; e += st) { s.x += b[e].x; s.y += b[e].y; s.z += b[e].z; s.w += b[e].w; }
  for (long long e = i; e < nc; e += st) { s.x += c[e].x; s.y += c[e].y; s.z += c[e].z; s.w += c[e].w; }
  for (long long e = i; e < nd; e += st) { s.x += d[e].x; s.y += d[e].y; s.z += d[e].z; s.w += d[e].w; }
  for (long long e = i; e < no; e += st) out[e] = s;
}
extern "C" int empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int read_write(const float* a, long long na, const float* b, long long nb,
                          const float* c, long long nc, const float* d, long long nd,
                          float* out, long long no, int blocks, void* stream) {
  read_write_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)a, na / 4, (const float4*)b, nb / 4, (const float4*)c, nc / 4,
      (const float4*)d, nd / 4, (float4*)out, no / 4);
  return (int)cudaGetLastError();
}
"""


def loads_only(text: str) -> str:
    """The scalar kernel's source with flux5 and flux3 reduced to sums of
    their operands: the same loads, almost no arithmetic."""
    text = re.sub(r"(float flux5\([^)]*\) \{).*?\n\}",
                  r"\1\n  return vel + qm3 + qm2 + qm1 + q0 + qp1 + qp2;\n}", text, flags=re.S)
    return re.sub(r"(float flux3\([^)]*\) \{).*?\n\}",
                  r"\1\n  return vel + qm2 + qm1 + q0 + qp1;\n}", text, flags=re.S)


def sass_counts(so_path: str):
    """The instructions of each kernel in the library `so_path` by opcode,
    from cuobjdump's SASS listing, with their total; None without cuobjdump.
    The kernels' loops are unrolled, so this is close to what one thread
    issues for one element (the Mie kernel) or one level (the scalar one)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and fn:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return {fn: dict(sorted(c.items(), key=lambda kv: -kv[1]), total=sum(c.values()))
            for fn, c in counts.items()}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with {err}")


def adv_inputs(dev, nz=50, ny=100, nx=100):
    """chip_smoke.py's inputs of the scalar kernel's phase (seed 0)."""
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    q = put(300.0 + rng.normal(size=(nz, ny + 6, nx + 6)))
    ru = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    rv = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    ww = rng.normal(size=(nz + 1, ny, nx)) * 1e3
    ww[0] = 0.0
    ww[-1] = 0.0
    rdnw = put(rng.uniform(-60.0, -40.0, nz))
    return q, ru, rv, put(ww), rdnw


def adv_call(lib, args, out, rdx=1e-3, rdy=1e-3):
    """A no-argument call of the scalar kernel of `lib` on `args` into `out`."""
    fn = lib.advect_scalar_5_3
    fn.argtypes = adv_kernel._ARGTYPES
    fn.restype = ctypes.c_int
    q, ru, rv, ww, rdnw = args
    nz, ny, nx = out.shape
    ptrs = [a.data_ptr() for a in (q, ru, rv, ww, rdnw, out)]

    def call():
        _checked(fn(*ptrs, nz, ny, nx, rdx, rdy, _stream()), "advect_scalar_5_3")
    return call


def mie_call(lib, table, inputs, outs, blocks):
    fn = lib.mie_cheb_eval
    fn.argtypes = mie_kernel._ARGTYPES
    fn.restype = ctypes.c_int
    ptrs = [a.data_ptr() for a in (table, *inputs, *outs)]
    n = inputs[2].numel()

    def call():
        _checked(fn(*ptrs, n, blocks, _stream()), "mie_cheb_eval")
    return call


def tracers_call(lib, args, pt, pd, out, r_hi):
    """A no-argument call of the multi-tracer kernel of `lib` on the
    positional arguments `args` of `advect_tracers` (as
    chip_smoke.tracer_inputs makes them), with limiter and clip if `pd`,
    into `out` (r_hi its scratch); it returns the output."""
    fn = lib.advect_tracers
    fn.argtypes = tracers_kernel._ARGTYPES
    fn.restype = ctypes.c_int
    q_pad, phi, ru, rv, ww, mu_full, mu_new, grid, hx, dts = args
    ptrs = [a.data_ptr() for a in (q_pad, phi, pt, ru, rv, ww, mu_full, mu_new, grid.rdnw)]
    m2 = tracers_kernel.map_factor_sq(grid)
    edges = tracers_kernel.edge_codes(hx)

    def call():
        _checked(fn(*ptrs, None if m2 is None else m2.data_ptr(),
                    None if r_hi is None else r_hi.data_ptr(), out.data_ptr(),
                    *out.shape, float(grid.rdx), float(grid.rdy), float(dts), int(pd),
                    int(pd), *edges, _stream()), "advect_tracers")
        return out
    return call


def tracers_ab(dev, libs, parent, card):
    """The multi-tracer section (see the module docstring): a list of rows."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    rows = []
    for nx, ny, nz, counts in TRACER_SHAPES:
        grid, _ = ideal.make_case(cs._cfg3(nx=nx, ny=ny, nz=nz, rad_chem=False), "squall2d_x",
                                  device=dev, bubble_amp=3.0)
        for nt in counts:
            args, pt, _ = cs.tracer_inputs(dev, grid, nt)
            out = torch.empty((nt, nz, ny, nx), device=dev)
            for pd in (False, True):
                r_hi = torch.empty_like(out) if pd else None
                keys = (["parent_tracers"] if parent else []) + ["tracers"]
                calls = {k: tracers_call(libs[k], args, pt, pd, out, r_hi) for k in keys}
                ref = torch.empty_like(out)
                for a in range(0, nt, TRACER_SLICE):
                    b = min(nt, a + TRACER_SLICE)
                    ref[a:b] = tracers_kernel.advect_tracers_reference(
                        args[0][a:b], args[1][a:b], *args[2:], pt=pt[a:b], pd=pd, clip=pd)
                row = {"nt": nt, "shape": [nz, ny, nx], "pd": pd,
                       "bound_ms": cs._tracers_bound(nt, nz, ny, nx, pd)[0],
                       "plan": tracers_kernel.plan(libs["tracers"], pd, nt, nz, ny, nx)}
                for k, call in calls.items():
                    # a cell the call leaves unwritten must not keep an
                    # earlier call's value
                    out.fill_(float("nan"))
                    if r_hi is not None:
                        r_hi.fill_(float("nan"))
                    call()
                    torch.cuda.synchronize()
                    equal = bool(torch.equal(out, ref))
                    row[f"{k}_bitwise"] = equal
                    if not equal:
                        raise RuntimeError(f"{k} at nt={nt}, shape {(nz, ny, nx)}, pd={pd}: "
                                           f"max|d| {float((out - ref).abs().max())}, not "
                                           "bitwise")
                del ref
                order = keys + keys[::-1]
                for k in order:
                    row.setdefault(f"{k}_ms", []).append(
                        cs._device_ms(calls[k], calls=2 if nx * ny > 10 ** 5 else 10,
                                      trials=5 if nx * ny > 10 ** 5 else 20))
                print(f"advect_tracers {row} [{card}]")
                rows.append(row)
                del calls, r_hi
            if nx == 50 and parent:
                rows.append(seams_ab(libs, args, pt, card))
            del args, pt, out
            torch.cuda.empty_cache()
        del grid
    return rows


def seams_ab(libs, args, pt, card):
    """The seam grids (FACTOR, then LIMITED on r_hi's ring) of the parent's
    library and this tree's on one block with seams on all four sides, the
    rings of phi, ww and r_hi cut from the block's own fields padded by one
    (a stand-in for the exchange; the ring's values do not change the
    work): the two outputs bitwise equal, and each library's time in
    turns."""
    q_pad, phi, ru, rv, ww, mu_full, mu_new, grid, hx, dts = args
    nt, nz, ny, nx = phi.shape
    edges = (tracers_kernel.SEAM,) * 4
    phi_r, ww_r = hx.pad(phi, 1), hx.pad(ww, 1)
    outs = {k: torch.empty_like(phi) for k in ("parent_tracers", "tracers")}
    r_hi = torch.empty_like(phi)
    r_ring = {}
    ptrs = [a.data_ptr() for a in (q_pad, phi_r, pt, ru, rv, ww_r, mu_full, mu_new, grid.rdnw)]

    def grid_call(key, g):
        fn = libs[key].advect_tracers_seam
        fn.argtypes = tracers_kernel._SEAM_ARGTYPES
        fn.restype = ctypes.c_int
        ring = r_ring.get(key)
        _checked(fn(g, *ptrs, None, r_hi.data_ptr(), None if ring is None else ring.data_ptr(),
                    outs[key].data_ptr(), nt, nz, ny, nx, float(grid.rdx), float(grid.rdy),
                    float(dts), 1, *edges, _stream()), "advect_tracers_seam")

    calls = {}
    for key in outs:
        r_hi.fill_(float("nan"))
        outs[key].fill_(float("nan"))
        grid_call(key, tracers_kernel.FACTOR)
        r_ring[key] = hx.pad(r_hi, 1)
        grid_call(key, tracers_kernel.LIMITED)
        calls[key] = lambda key=key: (grid_call(key, tracers_kernel.FACTOR),
                                      grid_call(key, tracers_kernel.LIMITED))
    torch.cuda.synchronize()
    if not torch.equal(r_ring["parent_tracers"], r_ring["tracers"]):
        raise RuntimeError("seam grids: r_hi differs between the parent's and this tree's")
    if not torch.equal(outs["parent_tracers"], outs["tracers"]):
        raise RuntimeError("seam grids: the parent's and this tree's outputs differ")
    row = {"nt": nt, "shape": [nz, ny, nx], "pd": True, "seam": True,
           "bound_ms": cs._tracers_bound(nt, nz, ny, nx, True)[0],
           "plan": tracers_kernel.plan(libs["tracers"], True, nt, nz, ny, nx, seam=True),
           "bitwise_parent": True}
    for k in ["parent_tracers", "tracers", "tracers", "parent_tracers"]:
        row.setdefault(f"{k}_ms", []).append(cs._device_ms(calls[k], calls=10, trials=20))
    print(f"advect_tracers_seam {row} [{card}]")
    return row


def config4_mie_inputs(dev):
    """Each bin's Mie inputs of one chem call of chip_smoke.py's config 4
    (100x100x50, bench.py's seed) after two steps."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = cs._cfg4()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, cs._seed4(state), device=dev)
    sim.advance(2)
    sim.sync()
    chem = sim._stepper("chem")
    t_now = np.float32(sim.time_s)
    from wrfchem_arc_interactions_tpu_torch.chem import optics
    calls = []
    with cs._Checked(optics, {"cheb_eval": cs._recorder(calls)}):
        chem(sim.state, sim.grid, t_now)
    del sim, grid, state
    return [args for args, _, _ in calls]


def runs_of(shape, gen, run):
    """Mie inputs whose runs of `run` consecutive elements each lie in one
    floor cell (8: a quarter-warp's lanes, what one 16-byte shared-memory
    wavefront serves)."""
    n = int(np.prod(shape))
    runs = -(-n // run)
    cell_nr = torch.randint(0, 7, (runs,), generator=gen).repeat_interleave(run)[:n]
    cell_u = torch.randint(0, 9, (runs,), generator=gen).repeat_interleave(run)[:n]
    nr_n = (cell_nr + torch.rand(n, generator=gen)) / 7.0
    u = (cell_u + torch.rand(n, generator=gen)) / 9.0
    t = 2.0 * torch.rand(n, generator=gen) - 1.0
    return tuple(a.reshape(shape) for a in (nr_n, u, t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout to time against")
    ap.add_argument("--kernels", default="adv,mie,tracers",
                    help="comma-separated sections to run: adv, mie, tracers")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "kernel_ab.json"))
    args = ap.parse_args(argv)
    sections = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("kernel_ab_gpu: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = cs._card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(card)
    result = {"card": card, "sms": sms}

    # ---- sources: this tree's, the parent's, the floors
    names = {"adv": "advect_scalar_5_3", "mie": "mie_cheb_eval", "tracers": "advect_tracers"}
    build.register_generated("ab_floors", FLOORS_SRC)
    names["floors"] = "ab_floors"
    if args.parent:
        for key, src in (("parent_adv", "advect_scalar_5_3.cu"), ("parent_mie", "mie_cheb_eval.cu"),
                         ("parent_tracers", "advect_tracers.cu")):
            with open(os.path.join(args.parent, CSRC, src)) as f:
                text = f.read()
            build.register_generated(f"ab_{key}", text)
            if key == "parent_mie" and "mie_cheb_eval_shape" in text:
                build.DROPPED_FLAGS["ab_parent_mie"] = build.DROPPED_FLAGS["mie_cheb_eval"]
            names[key] = f"ab_{key}"
            if key == "parent_adv":
                build.register_generated("ab_parent_adv_loads", loads_only(text))
                names["parent_adv_loads"] = "ab_parent_adv_loads"
    t0 = time.perf_counter()
    build.build_all(list(names.values()), verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    libs = {key: build.load(name) for key, name in names.items()}
    result["sass"] = {key: sass_counts(build.lib_path(names[key]))
                      for key in ("adv", "mie", "parent_adv", "parent_mie") if key in names}
    for key, counts in result["sass"].items():
        print(f"SASS {key}: {counts}")
    # the multi-tracer instances: instructions in all (their listings are long)
    for key in ("tracers", "parent_tracers"):
        if key in names:
            counts = sass_counts(build.lib_path(names[key])) or {}
            result["sass"][key] = {fn: c["total"] for fn, c in counts.items()}
            print(f"SASS {key} (instructions by kernel instance): {result['sass'][key]}")
    if "tracers" in sections:
        torch.cuda.empty_cache()
        result["advect_tracers"] = tracers_ab(dev, libs, bool(args.parent), card)

    nz, ny, nx = 50, 100, 100
    if "adv" in sections:          # ---- scalar advection
        inputs = adv_inputs(dev, nz, ny, nx)
        ref = adv_kernel.advect_scalar_5_3_reference(*inputs, 1e-3, 1e-3)
        adv_keys = [k for k in libs if k in ("adv", "parent_adv", "parent_adv_loads")]
        calls, outs = {}, {}
        for key in adv_keys:
            outs[key] = torch.full_like(ref, float("nan"))
            calls[key] = adv_call(libs[key], inputs, outs[key])
            calls[key]()
        torch.cuda.synchronize()
        adv = {"shape": [nz, ny + 6, nx + 6], "plan": adv_kernel.plan(libs["adv"], nz, ny, nx, sms),
               "bound_ms": cs._adv_bound(nz, ny, nx)[0]}
        for key in adv_keys:
            equal = bool(torch.equal(outs[key], ref))
            if key != "parent_adv_loads" and not equal:
                raise RuntimeError(f"{key} is not bitwise equal to the plain version")
            adv[f"{key}_bitwise"] = equal
        order = (["parent_adv", "adv", "adv", "parent_adv"] if args.parent else ["adv", "adv"])
        for key in order:
            adv.setdefault(f"{key}_ms", []).append(cs._device_ms(calls[key], calls=20))
        if "parent_adv_loads" in calls:
            adv["parent_adv_loads_ms"] = [cs._device_ms(calls["parent_adv_loads"], calls=20)]
        floors = libs["floors"]
        floors.empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        floors.read_write.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 5
                                      + [ctypes.c_int, ctypes.c_void_p])
        old_blocks = -(-nx // 32) * -(-ny // 8) * nz
        for label, blocks in (("empty_parent_grid", old_blocks),
                              ("empty_this_grid", adv["plan"]["blocks"])):
            adv[f"{label}_ms"] = [cs._device_ms(
                lambda b=blocks: _checked(floors.empty(b, 256, _stream()), "empty"), calls=20)]
        q, ru, rv, ww, _ = inputs
        out = torch.empty_like(ref)
        rw = [x for a in (q, ru, rv, ww, out) for x in (a.data_ptr(), a.numel())]
        for per_sm in (4, 8):
            adv[f"read_write_{per_sm}_per_sm_ms"] = [cs._device_ms(
                lambda p=per_sm: _checked(floors.read_write(*rw, p * sms, _stream()), "read_write"),
                calls=20)]
        adv["read_write_bytes"] = 4 * sum(a.numel() for a in (q, ru, rv, ww, out))
        for key, value in adv.items():
            print(f"advect_scalar_5_3 {key}: {value}")
        result["advect_scalar_5_3"] = adv
        del inputs, ref, outs, calls, out

    if "mie" in sections:          # ---- Mie evaluator
        gen = torch.Generator(device="cpu").manual_seed(1)
        shape = (30, nz, ny, nx)
        cases = {"random": tuple(torch.rand(shape, generator=gen) for _ in range(2))
                 + (2.0 * torch.rand(shape, generator=gen) - 1.0,),
                 "coherent": cs._coherent(shape, gen), "runs8": runs_of(shape, gen, 8)}
        cases = {k: tuple(a.contiguous().to(dev) for a in v) for k, v in cases.items()}
        for b, ins in enumerate(config4_mie_inputs(dev), start=1):
            cases[f"config4_bin{b}"] = ins
        table = mie_kernel.packed_table(dev, mie_kernel.launch_shape(libs["mie"])["cell_stride"])
        G = mie_kernel.grid_matrix(dev)
        if args.parent and hasattr(libs["parent_mie"], "mie_cheb_eval_shape"):
            parent_table = mie_kernel.packed_table(
                dev, mie_kernel.launch_shape(libs["parent_mie"])["cell_stride"])
        mie = {"bound_ms": cs._mie_bound(30 * nz * ny * nx)[0]}
        for case, ins in cases.items():
            ref = mie_kernel.cheb_eval_reference(*ins)
            outs = tuple(torch.empty_like(ins[2]) for _ in range(3))
            n = ins[2].numel()
            kernels = {"mie": mie_call(libs["mie"], table, ins, outs,
                                       mie_kernel.grid_blocks(libs["mie"], n, sms))}
            if args.parent and hasattr(libs["parent_mie"], "mie_cheb_eval_shape"):
                kernels["parent_mie"] = mie_call(libs["parent_mie"], parent_table, ins, outs,
                                                 mie_kernel.grid_blocks(libs["parent_mie"], n, sms))
            elif args.parent:
                kernels["parent_mie"] = mie_call(libs["parent_mie"], G, ins, outs,
                                                 min(-(-n // 256), 7 * sms))
            row = {"elements": n,
                   "cells_per_warp_mean": float(cs.cells_per_warp(*ins[:2]).float().mean())}
            for key, call in kernels.items():
                call()
                torch.cuda.synchronize()
                err = max(float((o - r).abs().max()) for o, r in zip(outs, ref))
                if not err <= 3.2e-4:
                    raise RuntimeError(f"{key} on {case} inputs: max|d| {err}")
                row[f"{key}_max_abs_err"] = err
            order = ["parent_mie", "mie", "mie", "parent_mie"] if args.parent else ["mie", "mie"]
            for key in order:
                row.setdefault(f"{key}_ms", []).append(
                    cs._device_ms(kernels[key], calls=5, trials=20))
            print(f"mie_cheb_eval {case}: {row}")
            mie[case] = row
            del ref, outs
        result["mie_cheb_eval"] = mie
        del cases

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
