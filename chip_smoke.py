"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases (each raises on failure, and the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``wrfchem_arc_interactions_tpu_torch/csrc``
   (one nvcc per source, in parallel);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, timed with CUDA events, beside its
   bound;
4. slice phase: BASELINE config 3 exactly as bench.py's ``_cfg3`` builds it
   (100x100x50, dx = 1 km, dt = 6 s, RRTMG SW/LW every 600 s, MOSAIC 4-bin
   optics every 600 s with aer_ra_feedback, gas and aerosol chemistry off)
   on the ``squall2d_x`` case with bench.py's chem seed: 2 warm-up steps
   (both alarms ring at step 0), then one alarm period of 100 steps closed
   by one sync — one rad call and one chem call in the window.  Checks
   finite fields, 0 < max w < 60 m/s, OLR in 100-400 W m-2, tau_aer_sw > 0
   where bins are seeded, ssa_aer_sw in (0, 1], and the exact kernel
   launch counts of the window; then the time of one rad call, one chem
   call and one main step, each synchronised, and the rad call's peak
   memory;
5. slice 1's path (radiation and chemistry off): 10 steps, 9 launches of
   the fused advection kernel per step;
6. a short profile of two config-3 steps and one chem call (device time by
   kernel, device busy share) and the time of one Thomas solve;
7. cross-check: 3 steps of a small config 3 starting at noon UTC (both
   alarms every step) on the card against the CPU.

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
PKG = "wrfchem_arc_interactions_tpu_torch"
REPLACES = {
    "advect_scalar_5_3": "wrfchem_arc_interactions_tpu/ops/pallas_adv.py:135",
    "mie_cheb_eval": "wrfchem_arc_interactions_tpu/ops/pallas_mie.py:157",
    "advect_tracers": "wrfchem_arc_interactions_tpu/ops/pallas_adv_multi.py:281",
}
RAD_CHEM_EVERY = 100          # radt_s = chemdt_s = 600 s at dt = 6 s


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cfg3(nx=100, ny=100, nz=50, rad_chem=True, every_s=600.0,
          start_date="2000-06-20_00:00:00"):
    """bench.py's _cfg3 values; `rad_chem=False` is slice 1's path."""
    from wrfchem_arc_interactions_tpu_torch.config import (
        ChemConfig, Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl,
    )
    from wrfchem_arc_interactions_tpu_torch.config.namelist import (
        ChemOpt, MPScheme, RAScheme,
    )
    ra = RAScheme.RRTMG if rad_chem else RAScheme.NONE
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                            ztop=17000.0, p_top=8000.0),
        time_control=TimeControl(dt=6.0, start_date=start_date),
        dynamics=DynamicsConfig(kvdif=30.0),
        physics=PhysicsConfig(mp_physics=MPScheme.KESSLER, ra_sw_physics=ra,
                              ra_lw_physics=ra, radt_s=every_s),
        chem=ChemConfig(chem_opt=ChemOpt.MOSAIC_4BIN if rad_chem else ChemOpt.NONE,
                        chemdt_s=every_s, aer_ra_feedback=rad_chem,
                        gaschem_onoff=False, aerchem_onoff=False),
    )


def _seed(state):
    """bench.py's chem seed (config 3): so4 2.0 and oc 1.0 ug/kg and 2e9
    particles/kg in bins 1-2."""
    for b in (1, 2):
        state[f"chem_so4_a{b:02d}"] = torch.full_like(state["t"], 2.0)
        state[f"chem_oc_a{b:02d}"] = torch.full_like(state["t"], 1.0)
        state[f"chem_num_a{b:02d}"] = torch.full_like(state["t"], 2e9)
    return state


def _kernels():
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, mie_kernel, tracers_kernel
    return {"advect_scalar_5_3": adv_kernel.advect_scalar_5_3,
            "mie_cheb_eval": mie_kernel.cheb_eval,
            "advect_tracers": tracers_kernel.advect_tracers}


def _reset_counts():
    for fn in _kernels().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _kernels().items()}


def _device_ms(fn, calls: int, trials: int = 50, warmup: int = 5) -> float:
    """Device time per call of `fn`: median over `trials` of the mean of
    `calls` back-to-back calls between two CUDA events.  Each trial is
    queued behind a device-side sleep longer than the host takes to enqueue
    it, so the events bracket device work only, not the host's launch
    overhead.  Inputs stay in L2 between calls where they fit (warm
    cache).  For a few launches per call only: the host blocks once the
    device's launch queue is full, so a function of thousands of launches
    never gets ahead of the sleep (`_profiled_ms` times those)."""
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
            if cycles >= 1 << 33:
                raise RuntimeError("_device_ms: the host cannot enqueue the calls "
                                   "ahead of the device; time them with _profiled_ms")
            cycles *= 2
            continue
        per_call.append(a.elapsed_time(b) / calls)
    return statistics.median(per_call)


def _profiled_ms(fn, reps: int = 3) -> float:
    """Device time per call of `fn` as the profiler sums it over the call's
    kernels (the gaps between launches excluded): the median of `reps`
    profiled calls, after one warm call."""
    fn()
    return statistics.median(_profile(fn)[0] for _ in range(reps))


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


def _bound(nbytes, ops):
    """Least time [ms]: bytes over the HBM rate vs float32 operations over
    the float32 rate, and which one sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _adv_bound(nz, ny, nx):
    """advect_scalar_5_3: each input read once, the output written once;
    ops per face: flux5 20, flux3 16 (with the two sign flips); per cell 9
    for the divergence."""
    nbytes = 4 * (3 * nz * (ny + 6) * (nx + 6) + (nz + 1) * ny * nx + nz
                  + nz * ny * nx)
    ops = (20 * (nz * ny * (nx + 1) + nz * (ny + 1) * nx)
           + 16 * (nz - 1) * ny * nx + 9 * nz * ny * nx)
    return _bound(nbytes, ops)


# float operations per element of the Mie evaluator: 2 scalings, 4 hat
# weights of 4 operations, 4 weight products, the doubling of t, 90
# coefficients of 4 products and 3 sums, 90 Clenshaw steps of 3 and 3
# closing steps of 4
MIE_OPS_PER_ELEMENT = 2 + 16 + 4 + 1 + 90 * 7 + 90 * 3 + 3 * 4


def _mie_bound(n):
    """mie_cheb_eval: 3 float32 inputs and 3 outputs per element."""
    return _bound(24 * n, MIE_OPS_PER_ELEMENT * n)


# float operations per (tracer, cell) of the stage update, each face
# counted once: 3 face fluxes (flux5 20, flux5 20, flux3 16), divergence 9,
# tendency 2, update 3; the limiter adds the low-order fluxes (8), two
# factors (~25 each), the renormalisation (6), phi_td (12), the
# antidiffusive fluxes (3), the limited fluxes (9) and the clip (1)
TRACER_OPS = {False: 70, True: 160}


def _tracers_bound(nt, nz, ny, nx, pd):
    """advect_tracers: q (padded), phi_old, pt, ru, rv (padded), ww,
    mu_full, mu_new, rdnw read once, q_new written once."""
    cells = nz * ny * nx
    padded = nz * (ny + 6) * (nx + 6)
    nbytes = 4 * (nt * padded + 3 * nt * cells + 2 * padded + (nz + 1) * ny * nx
                  + 2 * ny * nx + nz)
    return _bound(nbytes, TRACER_OPS[pd] * nt * cells)


def _entry(name, launches, max_abs, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def kernel_adv(dev, rdnw, rdx, rdy, nz, ny, nx):
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
    bound = _adv_bound(nz, ny, nx)
    print(f"advect_scalar_5_3 at ({nz}, {ny + 6}, {nx + 6}), device time per call: "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound[0] * 1e3:.2f} us ({bound[1]}, {100.0 * bound[0] / ms:.1f}% of it); "
          f"host wall per synchronised call: kernel {wall_ms * 1e3:.2f} us, plain "
          f"{plain_wall_ms * 1e3:.2f} us")
    return _entry("advect_scalar_5_3", None, max_abs, ms, plain_ms, bound)


def kernel_mie(dev, nz, ny, nx, nband=30):
    """One bin's call at the main path's shape: (30 bands, nz, ny, nx)
    elements, with the edges of both interpolation axes among them."""
    from wrfchem_arc_interactions_tpu_torch.ops import mie_kernel
    gen = torch.Generator(device="cpu").manual_seed(1)
    shape = (nband, nz, ny, nx)
    nr_n, u = (torch.rand(shape, generator=gen) for _ in range(2))
    t = 2.0 * torch.rand(shape, generator=gen) - 1.0
    u[:, :, :, :10] = 0.0           # ni clipped at 1e-9
    nr_n[:, :, :2, :2] = 1.0        # the top nodes
    u[:, :, 2:4, :2] = 1.0
    t[:, :, 0, 20] = -1.0
    t[:, :, 0, 21] = 1.0
    nr_n, u, t = (a.contiguous().to(dev) for a in (nr_n, u, t))
    out = mie_kernel.cheb_eval(nr_n, u, t)
    ref = mie_kernel.cheb_eval_reference(nr_n, u, t)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise RuntimeError("mie_cheb_eval: non-finite output")
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    print(f"mie_cheb_eval (kernel) vs plain on the card at {shape}: max|d| ln Qext "
          f"{errs[0]:.3g}, ln Qsca {errs[1]:.3g}, g {errs[2]:.3g} (limit 3.2e-4)")
    if not max(errs) <= 3.2e-4:
        raise RuntimeError(f"mie_cheb_eval disagrees with its plain version: {errs}")
    ms = _device_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t), calls=5, trials=20)
    plain_ms = _profiled_ms(lambda: mie_kernel.cheb_eval_reference(nr_n, u, t))
    wall_ms = _wall_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t))
    plain_wall_ms = _wall_ms(lambda: mie_kernel.cheb_eval_reference(nr_n, u, t), reps=2)
    bound = _mie_bound(t.numel())
    print(f"mie_cheb_eval, {t.numel()} elements, device time per call: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
          f"{100.0 * bound[0] / ms:.1f}% of it); host wall per synchronised call: "
          f"kernel {wall_ms:.4f} ms, plain {plain_wall_ms:.3f} ms")
    return _entry("mie_cheb_eval", None, max(errs), ms, plain_ms, bound)


def kernel_tracers(dev, grid, nt=47):
    """One stage update of config 3's 47 scalars at full width, without
    the limiter (stages 0-1) and with PD limiter and clip (stage 2)."""
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    gen = torch.Generator(device="cpu").manual_seed(2)
    mub = grid.mub.cpu()

    def jitter():
        return mub * (0.995 + 0.01 * torch.rand(mub.shape, generator=gen))

    q = 2.0 * torch.rand((nt, nz, ny, nx), generator=gen) \
        * (torch.rand((nt, nz, ny, nx), generator=gen) > 0.5)
    mu0, mu_full, mu_new = jitter(), jitter(), jitter()
    ru = mu_full * 20.0 * torch.randn((nz, ny, nx), generator=gen)
    rv = mu_full * 20.0 * torch.randn((nz, ny, nx), generator=gen)
    ww = 100.0 * torch.randn((nz + 1, ny, nx), generator=gen)
    ww[0] = 0.0
    ww[-1] = 0.0
    pt = 1e-3 * torch.randn((nt, nz, ny, nx), generator=gen)
    hx = HaloOps()
    q, mu0, mu_full, mu_new, ru, rv, ww, pt = (
        a.to(dev) for a in (q, mu0, mu_full, mu_new, ru, rv, ww, pt))
    args = (hx.pad(q, 3), mu0 * q, hx.pad(ru, 3), hx.pad(rv, 3), ww, mu_full, mu_new,
            grid, hx, 6.0)
    qmax = float(q.abs().max())
    modes = {}
    for pd in (False, True):
        kw = dict(pt=pt, pd=pd, clip=pd)
        out = tracers_kernel.advect_tracers(*args, **kw)
        ref = tracers_kernel.advect_tracers_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError("advect_tracers: non-finite output")
        max_abs = float((out - ref).abs().max())
        print(f"advect_tracers (kernel) vs plain on the card, nt={nt}, pd={pd}: "
              f"max|d| = {max_abs:.6g}, max|d|/max|q| = {max_abs / qmax:.3g} "
              f"(limit 1e-5; built with --fmad=false)")
        if not max_abs / qmax <= 1e-5:
            raise RuntimeError(f"advect_tracers disagrees with its plain version: {max_abs}")
        del out, ref
        ms = _device_ms(lambda: tracers_kernel.advect_tracers(*args, **kw),
                        calls=10, trials=20)
        plain_ms = _device_ms(lambda: tracers_kernel.advect_tracers_reference(*args, **kw),
                              calls=1, trials=5, warmup=1)
        wall_ms = _wall_ms(lambda: tracers_kernel.advect_tracers(*args, **kw))
        bound = _tracers_bound(nt, nz, ny, nx, pd)
        print(f"advect_tracers at ({nt}, {nz}, {ny}, {nx}), pd={pd}, device time per "
              f"call: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}, {100.0 * bound[0] / ms:.1f}% of it); host wall per "
              f"synchronised call: kernel {wall_ms:.4f} ms")
        modes["pd_clip" if pd else "no_limiter"] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1]}
    _tracers_boundaries(dev, grid)
    # the main path calls it twice without the limiter and once with it per
    # step: the entry carries the mean per call over that mix (its
    # "launches" count grids, five per step)
    a, b = modes["no_limiter"], modes["pd_clip"]
    mean = {k: (2.0 * a[k] + b[k]) / 3.0 for k in ("ms", "plain_ms", "bound_ms")}
    entry = _entry("advect_tracers", None, max(a["max_abs_err"], b["max_abs_err"]),
                   mean["ms"], mean["plain_ms"],
                   (mean["bound_ms"], a["bound_by"] if a["bound_by"] == b["bound_by"]
                    else "bytes and operations"))
    entry["modes"] = modes
    return entry


def _tracers_boundaries(dev, grid, nt=3, ny=9, nx=13):
    """The kernel against its plain version on open and symmetric lateral
    boundaries (config 3 is periodic), on a corner of config 3's grid: the
    limiter reads neighbour factors through each boundary's index map."""
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    nz = grid.nz
    gen = torch.Generator(device="cpu").manual_seed(3)
    mub = grid.mub[:ny, :nx].cpu()
    q = 2.0 * torch.rand((nt, nz, ny, nx), generator=gen) \
        * (torch.rand((nt, nz, ny, nx), generator=gen) > 0.5)
    ru = mub * 20.0 * torch.randn((nz, ny, nx), generator=gen)
    rv = mub * 20.0 * torch.randn((nz, ny, nx), generator=gen)
    ww = 100.0 * torch.randn((nz + 1, ny, nx), generator=gen)
    ww[0] = 0.0
    ww[-1] = 0.0
    pt = 1e-3 * torch.randn((nt, nz, ny, nx), generator=gen)
    q, ru, rv, ww, pt, mub = (a.to(dev) for a in (q, ru, rv, ww, pt, mub))
    worst = 0.0
    for bc in (BCKind.OPEN, BCKind.SYMMETRIC, BCKind.PERIODIC):
        hx = HaloOps(bc_x=bc, bc_y=bc)
        args = (hx.pad(q, 3), mub * q, hx.pad(ru, 3), hx.pad(rv, 3), ww, mub,
                1.001 * mub, grid, hx, 6.0)
        out = tracers_kernel.advect_tracers(*args, pt=pt, pd=True, clip=True)
        ref = tracers_kernel.advect_tracers_reference(*args, pt=pt, pd=True, clip=True)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max() / q.abs().max())
        worst = max(worst, err)
        if not err <= 1e-5:
            raise RuntimeError(f"advect_tracers on {bc.value} boundaries disagrees "
                               f"with its plain version: {err}")
    print(f"advect_tracers (kernel) vs plain with the limiter on open, symmetric and "
          f"periodic boundaries at ({nt}, {nz}, {ny}, {nx}): max|d|/max|q| = {worst:.3g} "
          f"(limit 1e-5)")


def _timed_ms(fn, n):
    """Synchronised host wall time per call of fn, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def slice_phase(cfg, grid, state, dev, steps, card):
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    sim = Simulation(cfg, grid, state, device=dev)
    if not (sim.rad_every == sim.chem_every == steps):
        raise RuntimeError(f"window of {steps} steps is not one alarm period "
                           f"(rad every {sim.rad_every}, chem every {sim.chem_every})")
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)              # steps 2 .. steps+1: one rad and one chem call
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"non-finite {k} after {steps + 2} steps")
    w_max = float(s["w"].max())
    olr = (float(s["olr"].min()), float(s["olr"].max()))
    seeded = s["tau_aer_sw"]        # bins 1-2 are seeded in every cell
    ssa = (float(s["ssa_aer_sw"].min()), float(s["ssa_aer_sw"].max()))
    if not 0.0 < w_max < 60.0:
        raise RuntimeError(f"max w = {w_max} m/s outside (0, 60)")
    if not (100.0 <= olr[0] and olr[1] <= 400.0):
        raise RuntimeError(f"OLR {olr} outside 100-400 W m-2")
    if not float(seeded.min()) > 0.0:
        raise RuntimeError("tau_aer_sw is not positive where the bins are seeded")
    if not (0.0 < ssa[0] and ssa[1] <= 1.0):
        raise RuntimeError(f"ssa_aer_sw {ssa} outside (0, 1]")
    # advect_tracers counts grids: one per call without the limiter (stages
    # 0-1), three with it (stage 2)
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": 5 * steps,
            "mie_cheb_eval": 4}
    if launches != want:
        raise RuntimeError(f"kernel launches in the {steps}-step window {launches}, "
                           f"expected {want}")
    d = cfg.domain
    ms_step = wall / steps * 1e3
    gps = d.nx * d.ny * d.nz / (wall / steps)
    print(f"slice (config 3): {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up "
          f"steps, one rad and one chem call in the window: {ms_step:.3f} ms/step, "
          f"{gps / 1e6:.4f} M gridpoints/s [{card}]; max w {w_max:.3f} m/s, max qc "
          f"{float(s['qc'].max()):.3e}, OLR {olr[0]:.1f}-{olr[1]:.1f} W m-2, "
          f"tau_aer_sw {float(seeded.min()):.4g}-{float(seeded.max()):.4g}, ssa "
          f"{ssa[0]:.4f}-{ssa[1]:.4f}; kernel launches {launches}")

    t_now = np.float32(sim.time_s)
    main, rad, chem = (sim._stepper(k) for k in ("main", "rad", "chem"))
    main_ms = _timed_ms(lambda: main(sim.state, sim.grid, t_now), 10)
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 3)
    chem_ms = _timed_ms(lambda: chem(sim.state, sim.grid, t_now), 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = rad(sim.state, sim.grid, t_now)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    print(f"phases, synchronised: main step {main_ms:.3f} ms, rad call {rad_ms:.3f} ms, "
          f"chem call {chem_ms:.3f} ms; per step of the window: main + (rad + chem)/"
          f"{steps} = {main_ms + (rad_ms + chem_ms) / steps:.3f} ms; rad call peak "
          f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before it; columns are not chunked)")
    return sim, launches, ms_step


def slice1_phase(dev, card, steps=10):
    """Slice 1's path: config 3's grid with radiation and chemistry off."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = _cfg3(rad_chem=False)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, state, device=dev)
    sim.advance(2)
    sim.sync()
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"advect_scalar_5_3": 9 * steps, "advect_tracers": 0, "mie_cheb_eval": 0}
    if launches != want:
        raise RuntimeError(f"slice 1's path: launches {launches}, expected {want}")
    if not all(bool(torch.isfinite(v).all()) for v in sim.state.values()):
        raise RuntimeError("slice 1's path: non-finite fields")
    print(f"slice 1's path (radiation and chemistry off): {steps} steps, "
          f"{wall / steps * 1e3:.3f} ms/step [{card}]; kernel launches {launches}")


def _profile(fn):
    """(device ms, kernel count, rows by kernel) of one profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
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
    return sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows), rows


def _per_call_us(rows, name):
    us = [t / n for t, n, k in rows if name in k]
    return us[0] if us else float("nan")


def profile_phase(sim, dev, ms_step):
    """Device time by kernel over 2 main steps and one chem call, and one
    Thomas solve."""
    from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas
    sim.sync()
    t0 = time.perf_counter()
    dev_ms, n_kernels, rows = _profile(lambda: sim.advance(2))
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of 2 steps: device busy {dev_ms / 2:.3f} ms per step in "
          f"{n_kernels / 2:.0f} kernels; against the unprofiled {ms_step:.3f} ms/step "
          f"the device is busy {100.0 * dev_ms / 2 / ms_step:.1f}% "
          f"(profiled wall {wall_ms:.1f} ms); advect_scalar_5_3 "
          f"{_per_call_us(rows, 'advect_scalar_5_3'):.2f} us per call; advect_tracers "
          f"grids: update {_per_call_us(rows, 'update_kernel'):.2f} us, low factor "
          f"{_per_call_us(rows, 'low_factor'):.2f} us, high factor "
          f"{_per_call_us(rows, 'high_factor'):.2f} us per launch")
    for t_us, count, key in rows[:12]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")
    chem = sim._stepper("chem")
    t_now = np.float32(sim.time_s)
    dev_ms, n_kernels, rows = _profile(lambda: chem(sim.state, sim.grid, t_now))
    print(f"profile of one chem call: device busy {dev_ms:.3f} ms in {n_kernels} "
          f"kernels; mie_cheb_eval {_per_call_us(rows, 'mie_cheb_eval') / 1e3:.4f} ms "
          f"per launch on the main path's inputs")
    for t_us, count, key in rows[:5]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")

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
    """3 steps of a small config 3 starting at noon UTC, radiation and chem
    every step, on the card against the CPU.  The limit per field is 1e-4
    of its magnitude, or three times the CPU run's own float32 noise (the
    CPU run again from theta changed by one ulp) where that is larger — as
    the CPU tests hold the port to the reference."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = _cfg3(nx=32, ny=8, nz=20, every_s=6.0, start_date="2000-06-20_12:00:00")
    grid, state = ideal.make_case(cfg, "squall2d_x", device="cpu", bubble_amp=3.0)
    state = _seed(state)
    ulp = dict(state, t=state["t"] * (1.0 + 2.0 ** -23))
    runs = {}
    for key, s0, where in (("gpu", state, dev), ("cpu", state, "cpu"), ("ulp", ulp, "cpu")):
        sim = Simulation(cfg, grid, s0, device=where)
        sim.advance(3)
        runs[key] = {k: v.double().cpu() for k, v in sim.state.items()}
    if not float(runs["gpu"]["swdown"].max()) > 100.0:
        raise RuntimeError("cross-check: no sunlight at noon")
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
    worst.sort(reverse=True)
    print("cross-check 3 steps of config 3 at 32x8x20 from noon, card vs CPU, worst "
          "fields: " + ", ".join(f"{k} {e:.3g} (CPU one-ulp noise {n:.3g})"
                                  for e, k, n in worst[:4]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=RAD_CHEM_EVERY,
                    help="window length; must be one alarm period (100)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.ops import build

    t_start = time.perf_counter()
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
    state = _seed(state)
    print(f"case squall2d_x 100x100x50 (config 3, {len(state)} fields) built in "
          f"{time.perf_counter() - t0:.2f} s")
    d = cfg.domain
    entries = {
        "advect_scalar_5_3": kernel_adv(dev, grid.rdnw, grid.rdx, grid.rdy,
                                        d.nz, d.ny, d.nx),
        "mie_cheb_eval": kernel_mie(dev, d.nz, d.ny, d.nx),
        "advect_tracers": kernel_tracers(dev, grid),
    }
    torch.cuda.empty_cache()

    sim, launches, ms_step = slice_phase(cfg, grid, state, dev, args.steps, card)
    for name, n in launches.items():
        entries[name]["launches"] = n
    slice1_phase(dev, card)
    profile_phase(sim, dev, ms_step)
    cross_check(dev)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
