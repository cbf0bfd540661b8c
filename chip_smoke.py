"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases (each raises on failure, and the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``wrfchem_arc_interactions_tpu_torch/csrc``
   (one nvcc per source, in parallel);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, timed with CUDA events;
4. slice phase: the config-3 grid (100x100x50, dx = 1 km, dt = 6 s) with
   radiation and chemistry off, ``make_case(cfg, "squall2d_x")`` then
   ``Simulation.advance``; checks finite fields, 0 < max w < 60 m/s and
   the kernel launch count of the run (9 per step);
5. a short profile of two steps (device time by kernel, device busy share)
   and the time of one Thomas solve;
6. cross-check: 3 steps of a small case on the card against the CPU.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with
code 1 and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
REPLACES = "wrfchem_arc_interactions_tpu/ops/pallas_adv.py:135"
SOURCE = "wrfchem_arc_interactions_tpu_torch/csrc/advect_scalar_5_3.cu"


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cfg3(nx=100, ny=100, nz=50):
    """bench.py's _cfg3 values with radiation and chemistry off."""
    from wrfchem_arc_interactions_tpu_torch.config import (
        Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl,
    )
    from wrfchem_arc_interactions_tpu_torch.config.namelist import MPScheme
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                            ztop=17000.0, p_top=8000.0),
        time_control=TimeControl(dt=6.0),
        dynamics=DynamicsConfig(kvdif=30.0),
        physics=PhysicsConfig(mp_physics=MPScheme.KESSLER),
    )


def _device_ms(fn, calls: int, trials: int = 50, warmup: int = 5) -> float:
    """Device time per call of `fn`: median over `trials` of the mean of
    `calls` back-to-back calls between two CUDA events.  Each trial is
    queued behind a device-side sleep longer than the host takes to enqueue
    it, so the events bracket device work only, not the host's launch
    overhead.  Inputs stay in L2 between calls (warm cache)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    per_call = []
    while len(per_call) < trials:
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s0.elapsed_time(a) < 1.5 * host_ms:     # sleep too short: retry
            cycles *= 2
            continue
        per_call.append(a.elapsed_time(b) / calls)
    return statistics.median(per_call)


def _wall_ms(fn, reps: int = 10) -> float:
    """Host wall time per call, synchronised (what a launch-bound caller
    sees)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _adv_bound(nz, ny, nx):
    """Least time for one advect_scalar_5_3 call: bytes (each input read
    once, the output written once) over HBM rate vs float ops over the
    float32 rate.  Ops per face: flux5 20, flux3 16 (with the two sign
    flips); per cell 9 for the divergence."""
    nbytes = 4 * (3 * nz * (ny + 6) * (nx + 6) + (nz + 1) * ny * nx + nz
                  + nz * ny * nx)
    ops = (20 * (nz * ny * (nx + 1) + nz * (ny + 1) * nx)
           + 16 * (nz - 1) * ny * nx + 9 * nz * ny * nx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev, rdnw, rdx, rdy, nz, ny, nx):
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    q = put(300.0 + rng.normal(size=(nz, ny + 6, nx + 6)))
    ru = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    rv = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    ww = rng.normal(size=(nz + 1, ny, nx)) * 1e3
    ww[0] = 0.0
    ww[-1] = 0.0
    ww = put(ww)
    args = (q, ru, rv, ww, rdnw, rdx, rdy)
    out = adv_kernel.advect_scalar_5_3(*args)
    ref = adv_kernel.advect_scalar_5_3_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("advect_scalar_5_3: non-finite output")
    max_abs = float((out - ref).abs().max())
    rel = max_abs / float(ref.abs().max())
    print(f"advect_scalar_5_3 (kernel) vs plain on the card: max|d| = {max_abs:.6g}, "
          f"max|d|/max|ref| = {rel:.3g} (limit 1e-5; built with --fmad=false)")
    if not rel <= 1e-5:
        raise RuntimeError(f"advect_scalar_5_3 disagrees with its plain version: {rel}")
    ms = _device_ms(lambda: adv_kernel.advect_scalar_5_3(*args), calls=20)
    plain_ms = _device_ms(lambda: adv_kernel.advect_scalar_5_3_reference(*args), calls=4)
    wall_ms = _wall_ms(lambda: adv_kernel.advect_scalar_5_3(*args), reps=50)
    plain_wall_ms = _wall_ms(lambda: adv_kernel.advect_scalar_5_3_reference(*args))
    bound_ms, bound_by = _adv_bound(nz, ny, nx)
    print(f"advect_scalar_5_3 at ({nz}, {ny + 6}, {nx + 6}), device time per call: "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, {100.0 * bound_ms / ms:.1f}% of it); "
          f"host wall per synchronised call: kernel {wall_ms * 1e3:.2f} us, plain "
          f"{plain_wall_ms * 1e3:.2f} us")
    return {"name": "advect_scalar_5_3", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": None, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def slice_phase(cfg, grid, state, dev, steps, card):
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel
    sim = Simulation(cfg, grid, state, device=dev)
    sim.advance(2)                              # warm-up (allocator, library)
    sim.sync()
    adv_kernel.advect_scalar_5_3.launches = 0
    t0 = time.perf_counter()
    sim.advance(steps)
    sim.sync()
    wall = time.perf_counter() - t0
    launches = adv_kernel.advect_scalar_5_3.launches
    for k, v in sim.state.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"non-finite {k} after {steps + 2} steps")
    w_max = float(sim.state["w"].max())
    if not 0.0 < w_max < 60.0:
        raise RuntimeError(f"max w = {w_max} m/s outside (0, 60)")
    if launches != 9 * steps:
        raise RuntimeError(f"advect_scalar_5_3 launched {launches} times in "
                           f"{steps} steps, expected {9 * steps}")
    d = cfg.domain
    ms_step = wall / steps * 1e3
    gps = d.nx * d.ny * d.nz / (wall / steps)
    print(f"slice: {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up steps: "
          f"{ms_step:.3f} ms/step, {gps / 1e6:.4f} M gridpoints/s "
          f"[{card}]; max w {w_max:.3f} m/s, max qc "
          f"{float(sim.state['qc'].max()):.3e}, kernel launches {launches}")
    return sim, launches, ms_step


def profile_phase(sim, dev, ms_step):
    """Device time by kernel over 2 steps, and one Thomas solve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas
    sim.sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.advance(2)
        sim.sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t_us = getattr(evt, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(evt, "self_cuda_time_total", 0.0)
        if t_us > 0:
            rows.append((t_us, evt.count, evt.key))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    n_kernels = sum(r[1] for r in rows)
    adv_us = [t / n for t, n, k in rows if "advect_scalar_5_3" in k]
    print(f"profile of 2 steps: device busy {dev_ms / 2:.3f} ms per step in "
          f"{n_kernels / 2:.0f} kernels; against the unprofiled {ms_step:.3f} ms/step "
          f"the device is busy {100.0 * dev_ms / 2 / ms_step:.1f}% "
          f"(profiled wall {wall_ms:.1f} ms); advect_scalar_5_3 "
          f"{adv_us[0] if adv_us else float('nan'):.2f} us per call")
    for t_us, count, key in rows[:12]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")

    nz1, ny, nx = sim.state["w"].shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    a, cc = (-0.2 - 0.1 * torch.rand((nz1, ny, nx), generator=gen) for _ in range(2))
    b = 1.0 + a.abs() + cc.abs()
    dd = torch.randn((nz1, ny, nx), generator=gen)
    a, b, cc, dd = (x.to(dev) for x in (a, b, cc, dd))
    th_wall = _wall_ms(lambda: thomas(a, b, cc, dd))
    th_dev = _device_ms(lambda: thomas(a, b, cc, dd), calls=1, trials=5, warmup=1)
    print(f"thomas ({nz1}, {ny}, {nx}): host wall {th_wall:.3f} ms per solve, device "
          f"{th_dev:.3f} ms; 7 solves per step = {100.0 * 7 * th_wall / ms_step:.1f}% "
          f"of the step's wall time")


def cross_check(dev):
    """3 steps of a small squall line on the card against the CPU.  The
    limit per field is 1e-4 of its magnitude, or three times the CPU run's
    own float32 noise (the CPU run again from theta changed by one ulp)
    where that is larger — as the CPU tests hold the port to the
    reference."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = _cfg3(nx=32, ny=8, nz=20)
    grid, state = ideal.make_case(cfg, "squall2d_x", device="cpu", bubble_amp=3.0)
    ulp = dict(state, t=state["t"] * (1.0 + 2.0 ** -23))
    runs = {}
    for key, s0, where in (("gpu", state, dev), ("cpu", state, "cpu"), ("ulp", ulp, "cpu")):
        sim = Simulation(cfg, grid, s0, device=where)
        sim.advance(3)
        runs[key] = {k: v.double().cpu() for k, v in sim.state.items()}
    phb = float(grid.phb.abs().max())
    worst = []
    for k, ref in runs["cpu"].items():
        scale = max(phb if k == "ph" else float(ref.abs().max()), 1e-30)
        err = float((runs["gpu"][k] - ref).abs().max()) / scale
        noise = float((runs["ulp"][k] - ref).abs().max()) / scale
        worst.append((err, k, noise))
        if not err <= max(1e-4, 3.0 * noise):
            raise RuntimeError(f"card vs CPU: {k} differs by {err:.3g} of its "
                               f"magnitude (CPU noise {noise:.3g})")
    err, k, noise = max(worst)
    print(f"cross-check 3 steps 32x8x20, card vs CPU: worst field {k} "
          f"{err:.3g} of its magnitude (CPU one-ulp noise {noise:.3g})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.ops import build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = _card()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    per_kernel = build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_kernel.items())})")

    cfg = _cfg3()
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    print(f"case squall2d_x 100x100x50 built in {time.perf_counter() - t0:.2f} s")
    d = cfg.domain
    entry = kernel_phase(dev, grid.rdnw, grid.rdx, grid.rdy, d.nz, d.ny, d.nx)

    sim, launches, ms_step = slice_phase(cfg, grid, state, dev, args.steps, card)
    entry["launches"] = launches
    profile_phase(sim, dev, ms_step)
    cross_check(dev)

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
