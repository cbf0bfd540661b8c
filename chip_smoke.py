"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases (each raises on failure, and the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every kernel: the three sources under
   ``wrfchem_arc_interactions_tpu_torch/csrc`` and the ROS2 gas-chemistry
   kernel, whose source ``ops/ros2_kernel.py`` generates from the CBM-Z
   tables into ``build/`` (one nvcc per source, all at once);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it (the Mie evaluator on random and on
   warp-coherent inputs; the multi-tracer kernel at config 3's 47 and config
   4's 107 scalars, and at small shapes that stress its tile and its ring of
   planes on all three boundary kinds, with rows of 1,000 cells in x tiles
   held bitwise; the ROS2 kernel against its plain version at config 4's
   500,000 cells and at 4,133 cells), timed with CUDA events, beside its
   bound, with each library's build flags;
4. slice phase: BASELINE config 3 exactly as bench.py's ``_cfg3`` builds it
   (100x100x50, dx = 1 km, dt = 6 s, RRTMG SW/LW every 600 s, MOSAIC 4-bin
   optics every 600 s with aer_ra_feedback, gas and aerosol chemistry off)
   on the ``squall2d_x`` case with bench.py's chem seed: 2 warm-up steps
   (both alarms ring at step 0), then one alarm period of 100 steps closed
   by one sync — one rad call and one chem call in the window.  Checks
   finite fields, 0 < max w < 60 m/s, OLR in 100-400 W m-2, tau_aer_sw > 0
   where bins are seeded, ssa_aer_sw in (0, 1], and the exact kernel
   launch counts of the window; then the time of one rad call, one chem
   call and one main step, each synchronised, the rad call's peak memory
   (10,000 columns, one chunk) and the call in chunks of 4,096 columns held
   bitwise to it, and the scalar advection kernel bitwise against its
   plain version on the inputs of one main step (so too in phases 5, 8 and
   10);
5. slice 1's path (radiation and chemistry off): 10 steps, 9 launches of
   the fused advection kernel per step;
6. a short profile of two config-3 steps and one chem call (device time by
   kernel, device busy share) and the time of one Thomas solve;
7. cross-check: 3 steps of a small config 3 starting at noon UTC (both
   alarms every step) on the card against the CPU;
8. config-4 slice phase: BASELINE config 4 exactly as bench.py's ``_cfg4``
   builds it (Morrison two-moment with progn, CBM-Z + MOSAIC 4-bin with the
   default stage list every 60 s, RRTMG every 600 s, aer_ra_feedback) with
   bench.py's aerosol and gas seed: 2 warm-up steps, then one 100-step
   window closed by one sync — 10 chem calls and 1 rad call.  Checks finite
   fields, every chem field >= 0, O3 within 0.02-0.06 ppmv of its 0.04 seed,
   droplet number in at least 90% of the cells with cloud water,
   tau_aer_sw > 0, and the
   exact launch counts of all four kernels; then the synchronised phase
   times, a profile of one chem call, and the Mie kernel on that call's own
   inputs (distinct floor cells per warp, device time per bin, within
   3.2e-4 of its plain version);
9. config-4 cross-check: 3 steps of a small config 4 from noon UTC (both
   alarms every step) on the card against the CPU;
10. slice-6 phase: bench.py's --config4-8bin
   (config 4 with cbmz_mosaic_8bin) with emissions (seeded surface fluxes
   and fire sources lifted by plume rise), the cloud-borne phase with
   aqueous chemistry and wet scavenging: 219 advected scalars, 2 warm-up
   steps, one 100-step window with exact launches (300 / 400 / 80 / 10),
   finite fields and no negative chem field; on one chem call the emitted
   burden against the fluxes, cw_exchange's conservation and cloud-borne
   number in cloudy updrafts, and rain lowering the scavenged fields; the
   synchronised phase times, profiles of a chem call and a main step, the
   Mie kernel on the 8 bins' own inputs;
11. slice-6 cross-check: 3 steps at 16x8x20 from noon on the card against
   the CPU;
12. slice-7 phase, this slice's main path: config 4 with WRF-Chem's usual
   transport and boundary layer (`_cfg7`: moist and chem scalars under the
   monotonic limiter, the 6th-order filter, 2D Smagorinsky with kvdif = 0,
   YSU over the revised MM5 surface layer and the Noah land surface): 2
   warm-up steps, one 100-step window with exact launches (300 / 200 / 40 /
   10: the final stage's monotonic update is a plain batched pass, not the
   multi-tracer kernel), finite fields, no negative chem or moist field,
   the PBL height inside the domain and the soil state in its bounds; the
   synchronised phase times, a profile of one main step, and the scalar
   advection and multi-tracer kernels bitwise on one main step's calls;
13. slice-7 cross-checks, card against CPU, 3 steps each from noon: the
   slice-7 configuration at 16x8x20; the LES case with the TKE closure and
   WENO5; SPPT and SKEBS; MYNN over the slab surface; BMJ, KF and Grell with
   WSM6 at dx = 10 km; the simple radiation;
14. wide phase: config 3 at 1000x100x50 (100,000 columns, rows in x tiles
   of the multi-tracer kernel): that kernel timed at 47 scalars on the
   grid, 3 steps with one rad and one chem call and exact launches, and
   the rad call's peak memory.

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
    "ros2_integrate": "wrfchem_arc_interactions_tpu/ops/pallas_ros2.py:230",
}
# ros2_integrate's CUDA source is generated at run time by this module
ROS2_SOURCE = f"{PKG}/ops/ros2_kernel.py"
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


def _cfg4(nx=100, ny=100, nz=50, chem_s=60.0, rad_s=600.0,
          start_date="2000-06-20_00:00:00"):
    """bench.py's _cfg4 values: Morrison two-moment with prognostic droplet
    number, CBM-Z + MOSAIC 4-bin with the default stage list (dry
    deposition, Fast-J photolysis, gas chemistry, aerosol dynamics, optics)
    every 60 s, RRTMG every 600 s, aerosol feedback on radiation."""
    from wrfchem_arc_interactions_tpu_torch.config import (
        ChemConfig, Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl,
    )
    from wrfchem_arc_interactions_tpu_torch.config.namelist import (
        ChemOpt, MPScheme, RAScheme,
    )
    return Config(
        domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                            ztop=17000.0, p_top=8000.0),
        time_control=TimeControl(dt=6.0, start_date=start_date),
        dynamics=DynamicsConfig(kvdif=30.0),
        physics=PhysicsConfig(mp_physics=MPScheme.MORRISON2, progn=True,
                              ra_sw_physics=RAScheme.RRTMG,
                              ra_lw_physics=RAScheme.RRTMG, radt_s=rad_s),
        chem=ChemConfig(chem_opt=ChemOpt.CBMZ_MOSAIC_4BIN, chemdt_s=chem_s,
                        aer_ra_feedback=True),
    )


GAS_SEED = (("o3", 0.04), ("no2", 2e-3), ("no", 1e-3), ("co", 0.12), ("so2", 2e-3),
            ("h2o2", 1e-3))


def _seed4(state):
    """bench.py's config-4 seed: the aerosol seed of config 3 plus six gases
    [ppmv]."""
    state = _seed(state)
    for name, v in GAS_SEED:
        state[f"chem_{name}"] = torch.full_like(state["t"], v)
    return state


def _cfg6(nx=100, ny=100, nz=50, chem_s=60.0, rad_s=600.0,
          start_date="2000-06-20_00:00:00"):
    """Slice 6's path: bench.py's --config4-8bin (`_cfg4` with
    cbmz_mosaic_8bin) with emissions, the cloud-borne phase with aqueous
    chemistry and wet scavenging on."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config.namelist import ChemOpt
    cfg = _cfg4(nx, ny, nz, chem_s, rad_s, start_date)
    return cfg.replace(chem=dataclasses.replace(
        cfg.chem, chem_opt=ChemOpt.CBMZ_MOSAIC_8BIN, emiss_opt=True, cldchem_onoff=True,
        wetscav_onoff=True))


def _cfg7(nx=100, ny=100, nz=50, chem_s=60.0, rad_s=600.0,
          start_date="2000-06-20_00:00:00"):
    """Slice 7's path: config 4 (`_cfg4`) with WRF-Chem's usual transport and
    boundary layer: the monotonic limiter for moist and chem scalars, the
    6th-order filter (diff_6th_opt = 2, factor 0.12), 2D Smagorinsky with
    kvdif = 0 (the PBL mixes in the vertical), YSU over the revised MM5
    surface layer and the Noah land surface."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config.namelist import (
        AdvLimiter, KMOpt, PBLScheme, SFScheme, SFSurface,
    )
    cfg = _cfg4(nx, ny, nz, chem_s, rad_s, start_date)
    return cfg.replace(
        dynamics=dataclasses.replace(
            cfg.dynamics, moist_adv_opt=AdvLimiter.MONOTONIC,
            chem_adv_opt=AdvLimiter.MONOTONIC, diff_6th_opt=2, diff_6th_factor=0.12,
            km_opt=KMOpt.SMAGORINSKY_2D, kvdif=0.0),
        physics=dataclasses.replace(
            cfg.physics, bl_pbl_physics=PBLScheme.YSU,
            sf_sfclay_physics=SFScheme.REVISED_MM5, sf_surface_physics=SFSurface.NOAH))


def _cfg_small(nx, ny, nz, dx, dt, ztop, p_top, dynamics=None, physics=None):
    """A small configuration of the options the cross-checks hold; enum
    values given by name."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config import (
        Config, DomainConfig, DynamicsConfig, PhysicsConfig, TimeControl,
    )

    def fill(obj, values):
        return dataclasses.replace(obj, **{k: type(getattr(obj, k))(v)
                                          for k, v in (values or {}).items()})

    return Config(domain=DomainConfig(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, ztop=ztop,
                                      p_top=p_top),
                  time_control=TimeControl(dt=dt, start_date="2000-06-20_12:00:00"),
                  dynamics=fill(DynamicsConfig(), dynamics),
                  physics=fill(PhysicsConfig(), physics))


def _les_state(state):
    """The LES cross-check's start: TKE of 0.1 m2/s2 and a mean wind with
    seeded eddies, which WENO5 needs to set its weights above rounding."""
    gen = torch.Generator(device="cpu").manual_seed(12)
    state["tke"] = torch.full_like(state["tke"], 0.1)
    for k, mean in (("u", 2.0), ("v", 1.0)):
        state[k] = mean + 0.5 * torch.randn(state[k].shape, generator=gen)
    return state


# surface fluxes of a regional air-quality run: gases [ppmv/s * m], aerosol
# [ug/m2/s] (oc and bc into bin 1)
SURFACE_EMISSIONS = (("so2", 2e-4), ("no", 5e-4), ("co", 2e-3), ("nh3", 3e-4),
                     ("oc_a01", 0.05), ("bc_a01", 0.02))


def _emissions6(grid, seed=6):
    """Constant emissions made from a seed, on the grid's device: the
    surface fluxes of `SURFACE_EMISSIONS` x U(0.5, 1.5) per column, and
    fire sources of so2 and no (5e-3, 2e-3) with a heat of 2,000 MW over
    a patch of a sixteenth of the columns, which plume rise lifts aloft."""
    ny, nx = grid.ny, grid.nx
    rng = np.random.default_rng(seed)
    out = {k: v * rng.uniform(0.5, 1.5, (ny, nx)) for k, v in SURFACE_EMISSIONS}
    patch = np.zeros((ny, nx), bool)
    patch[ny // 4: ny // 4 + max(1, ny // 4), nx // 4: nx // 4 + max(1, nx // 4)] = True
    out["elev_so2"] = np.where(patch, 5e-3, 0.0)
    out["elev_no"] = np.where(patch, 2e-3, 0.0)
    out["heat_mw"] = np.where(patch, 2000.0, 0.0)
    dev = grid.mub.device
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in out.items()}


def _kernels():
    from wrfchem_arc_interactions_tpu_torch.ops import (
        adv_kernel, mie_kernel, ros2_kernel, tracers_kernel,
    )
    return {"advect_scalar_5_3": adv_kernel.advect_scalar_5_3,
            "mie_cheb_eval": mie_kernel.cheb_eval,
            "advect_tracers": tracers_kernel.advect_tracers,
            "ros2_integrate": ros2_kernel.ros2_integrate}


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


def _entry(name, launches, max_abs, ms, plain_ms, bound, source=None):
    return {"name": name, "route": "cuda", "source": source or f"{PKG}/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def _flags(name) -> str:
    """The nvcc flags of kernel `name`'s library, as a message says them."""
    from wrfchem_arc_interactions_tpu_torch.ops import build
    flags = build.nvcc_flags(name)
    fmad = ("--fmad=false: no multiply-add contracted" if "--fmad=false" in flags
            else "multiply-adds contracted (no --fmad=false)")
    return f"built with {fmad} ({' '.join(flags)})"


def _adv_plan(nz, ny, nx) -> dict:
    """The grid the scalar advection kernel launches at (nz, ny, nx)."""
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return adv_kernel.plan(build.load("advect_scalar_5_3"), nz, ny, nx, sms)


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
          f"max|d|/max|ref| = {rel:.3g} (limit 1e-5), bitwise equal "
          f"{bool(torch.equal(out, ref))}; {_flags('advect_scalar_5_3')}; grid "
          f"{_adv_plan(nz, ny, nx)}")
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


def _coherent(shape, gen):
    """Mie inputs whose runs of 32 elements (a warp's) each lie in one floor
    cell of the (8, 10) grid, as neighbouring cells of one band mostly do on
    the main path."""
    n = int(np.prod(shape))
    runs = -(-n // 32)
    cell_nr = torch.randint(0, 7, (runs,), generator=gen).repeat_interleave(32)[:n]
    cell_u = torch.randint(0, 9, (runs,), generator=gen).repeat_interleave(32)[:n]
    nr_n = (cell_nr + torch.rand(n, generator=gen)) / 7.0
    u = (cell_u + torch.rand(n, generator=gen)) / 9.0
    t = 2.0 * torch.rand(n, generator=gen) - 1.0
    return tuple(a.reshape(shape) for a in (nr_n, u, t))


def cells_per_warp(nr_n, u):
    """Distinct floor cells of the (8, 10) grid among each run of 32
    consecutive elements (the lanes of one warp of the kernel's first
    stride): a tensor of counts."""
    ja = torch.floor(nr_n.reshape(-1) * 7.0).clamp(0, 6)
    jb = torch.floor(u.reshape(-1) * 9.0).clamp(0, 8)
    cell = (9 * ja + jb).nan_to_num(0.0)
    n = cell.numel() // 32 * 32
    srt = cell[:n].reshape(-1, 32).sort(dim=1).values
    return 1 + (srt[:, 1:] != srt[:, :-1]).sum(dim=1)


def _mie_check(mie_kernel, label, nr_n, u, t):
    """The kernel against its plain version on the same inputs: the errors."""
    out = mie_kernel.cheb_eval(nr_n, u, t)
    ref = mie_kernel.cheb_eval_reference(nr_n, u, t)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise RuntimeError(f"mie_cheb_eval: non-finite output ({label})")
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    print(f"mie_cheb_eval (kernel) vs plain on the card, {label} inputs at "
          f"{tuple(t.shape)}: max|d| ln Qext {errs[0]:.3g}, ln Qsca {errs[1]:.3g}, g "
          f"{errs[2]:.3g} (limit 3.2e-4); {_flags('mie_cheb_eval')}")
    if not max(errs) <= 3.2e-4:
        raise RuntimeError(f"mie_cheb_eval disagrees with its plain version ({label}): {errs}")
    return errs


# calls of each dycore kernel compared on each path's own inputs, by path
ON_PATH = {"advect_scalar_5_3": {}, "advect_tracers": {}}


def dycore_on_path(step, label):
    """The scalar advection kernel and the multi-tracer kernel against their
    plain versions, bitwise, on the inputs of their calls in one main step of
    a path (`step` runs the step; the multi-tracer kernel's calls are those
    of the path's stages, with and without the limiter, at its own scalar
    count).  Records the number of calls compared in `ON_PATH`."""
    from wrfchem_arc_interactions_tpu_torch.dycore import solve
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, tracers_kernel
    kernels = {"advect_scalar_5_3": (adv_kernel.advect_scalar_5_3,
                                     adv_kernel.advect_scalar_5_3_reference),
               "advect_tracers": (tracers_kernel.advect_tracers,
                                  tracers_kernel.advect_tracers_reference)}
    seen = {name: [] for name in kernels}
    inner = {name: getattr(solve, name) for name in kernels}

    def recording(name):
        def call(*args, **kw):
            seen[name].append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args),
                               {k: v.clone() if isinstance(v, torch.Tensor) else v
                                for k, v in kw.items()}))
            return inner[name](*args, **kw)
        return call

    for name in kernels:
        setattr(solve, name, recording(name))
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for name in kernels:
            setattr(solve, name, inner[name])
    if not seen["advect_scalar_5_3"]:
        raise RuntimeError(f"advect_scalar_5_3: no call in one step of {label}")
    for name, (kernel, plain) in kernels.items():
        shapes = set()
        for args, kw in seen[name]:
            out, ref = kernel(*args, **kw), plain(*args, **kw)
            if not torch.equal(out, ref):
                raise RuntimeError(f"{name} on {label}'s inputs {tuple(args[0].shape)} "
                                   f"{kw.get('pd', '')}: max|d| "
                                   f"{float((out - ref).abs().max())}, not bitwise equal")
            shapes.add((tuple(args[0].shape), kw.get("pd")))
            del out, ref
        ON_PATH[name][label] = len(seen[name])
        if seen[name]:
            print(f"{name} (kernel) vs plain on the card, {label}'s own inputs: "
                  f"{len(seen[name])} calls of one main step (inputs, limiter: "
                  f"{sorted(shapes, key=str)}), max|d| = 0 (bitwise equal)")
    del seen
    torch.cuda.empty_cache()


def kernel_mie(dev, nz, ny, nx, nband=30):
    """One bin's call at the main path's shape: (30 bands, nz, ny, nx)
    elements, with the edges of both interpolation axes among them (random
    inputs: a warp's lanes fall in many floor cells); then warp-coherent
    inputs (a warp's lanes in one cell), timed likewise."""
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
    errs = _mie_check(mie_kernel, "random", nr_n, u, t)
    ms = _device_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t), calls=5, trials=20)
    plain_ms = _profiled_ms(lambda: mie_kernel.cheb_eval_reference(nr_n, u, t))
    wall_ms = _wall_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t))
    plain_wall_ms = _wall_ms(lambda: mie_kernel.cheb_eval_reference(nr_n, u, t), reps=2)
    bound = _mie_bound(t.numel())
    print(f"mie_cheb_eval, {t.numel()} elements, random inputs ({_cpw(nr_n, u)}), device "
          f"time per call: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.4f} "
          f"ms ({bound[1]}, {100.0 * bound[0] / ms:.1f}% of it); host wall per synchronised "
          f"call: kernel {wall_ms:.4f} ms, plain {plain_wall_ms:.3f} ms")
    del nr_n, u, t
    nr_c, u_c, t_c = (a.contiguous().to(dev) for a in _coherent(shape, gen))
    errs_c = _mie_check(mie_kernel, "warp-coherent", nr_c, u_c, t_c)
    ms_c = _device_ms(lambda: mie_kernel.cheb_eval(nr_c, u_c, t_c), calls=5, trials=20)
    print(f"mie_cheb_eval, {t_c.numel()} elements, warp-coherent inputs "
          f"({_cpw(nr_c, u_c)}), device time per call: kernel {ms_c:.4f} ms "
          f"({100.0 * bound[0] / ms_c:.1f}% of the bound)")
    entry = _entry("mie_cheb_eval", None, max(errs + errs_c), ms, plain_ms, bound)
    entry.update(inputs="random", ms_warp_coherent=ms_c)
    return entry


def _cpw(nr_n, u) -> str:
    c = cells_per_warp(nr_n, u).float()
    return (f"{float(c.mean()):.2f} distinct floor cells per warp on average, "
            f"{100.0 * float((c == 1).float().mean()):.1f}% of warps in one cell")


class _Recorded:
    """Record the calls of functions of a module while a block runs: the
    list of (args, kwargs, result) per name; the originals come back after."""

    def __init__(self, module, *names):
        self.module, self.names = module, names
        self.calls = {n: [] for n in names}
        self.inner = {n: getattr(module, n) for n in names}

    def __enter__(self):
        for n in self.names:
            def recording(*args, _n=n, **kw):
                out = self.inner[_n](*args, **kw)
                # the caller may go on to assign into a dict it got or gave
                self.calls[_n].append((tuple(dict(a) if isinstance(a, dict) else a
                                             for a in args), kw,
                                       dict(out) if isinstance(out, dict) else out))
                return out
            setattr(self.module, n, recording)
        return self.calls

    def __exit__(self, *exc):
        for n in self.names:
            setattr(self.module, n, self.inner[n])
        return False


def capture_mie_inputs(fn):
    """Run `fn` (a chem call) with the Mie kernel's inputs recorded: the
    list of (nr_n, u, t) of its calls, one per bin."""
    from wrfchem_arc_interactions_tpu_torch.chem import optics
    with _Recorded(optics, "cheb_eval") as calls:
        fn()
    return [tuple(a.clone() for a in args) for args, _, _ in calls["cheb_eval"]]


def mie_on_path(chem_call, card, label="config 4"):
    """The Mie kernel on a path's own inputs (`label`): the distinct floor
    cells per warp of each bin's call (what decides whether the table loads
    are broadcasts) and the kernel's device time per call on each bin's
    inputs.  Returns {bin: numbers}."""
    from wrfchem_arc_interactions_tpu_torch.ops import mie_kernel
    per_bin = {}
    for b, (nr_n, u, t) in enumerate(capture_mie_inputs(chem_call), start=1):
        c = cells_per_warp(nr_n, u).float()
        errs = _mie_check(mie_kernel, f"{label} bin {b}", nr_n, u, t)
        ms = _device_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t), calls=5, trials=20)
        per_bin[b] = {"ms": ms, "elements": t.numel(), "max_abs_err": max(errs),
                      "cells_per_warp_mean": float(c.mean()),
                      "cells_per_warp_max": int(c.max()),
                      "warps_in_one_cell": float((c == 1).float().mean())}
        print(f"mie_cheb_eval on {label}'s own inputs, bin {b} ({t.numel()} elements): "
              f"{_cpw(nr_n, u)}, at most {int(c.max())}; kernel {ms:.4f} ms per call "
              f"[{card}]")
    return per_bin


def tracer_inputs(dev, grid, nt):
    """Seeded inputs of one stage update of `nt` scalars on `grid`: (the
    positional arguments of `advect_tracers`, the tendency stack pt,
    max|q|)."""
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
    return args, pt, float(q.abs().max())


def kernel_tracers(dev, grid, nt):
    """One stage update of `nt` scalars at full width (config 3 advects 47,
    config 4 107, slice 6 219), without the limiter (stages 0-1) and with PD
    limiter and clip (stage 2): {mode: numbers}."""
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    args, pt, qmax = tracer_inputs(dev, grid, nt)
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
    return modes


def tracers_entry(modes, others):
    """The multi-tracer kernel's entry.  A main path calls it twice without
    the limiter and once with it per step: the entry carries the mean per
    call over that mix at the main path's (slice 6's) 219 scalars (its
    "launches" count grids: one per call without the limiter, two with it);
    `modes` holds both settings at nt = 219, and `others` ({key: modes})
    those of the other paths' shapes."""
    a, b = modes["no_limiter"], modes["pd_clip"]
    mean = {k: (2.0 * a[k] + b[k]) / 3.0 for k in ("ms", "plain_ms", "bound_ms")}
    entry = _entry("advect_tracers", None,
                   max(m["max_abs_err"] for ms in (modes, *others.values())
                       for m in ms.values()),
                   mean["ms"], mean["plain_ms"],
                   (mean["bound_ms"], a["bound_by"] if a["bound_by"] == b["bound_by"]
                    else "bytes and operations"))
    entry["modes"] = modes
    entry.update(others)
    return entry


def _gas_inputs(ncell, seed, dev):
    """Seeded inputs of the ROS2 kernel: polluted-air concentrations
    [molec/cm3] x U(0.5, 2) per cell, rate constants at 215-305 K with J
    scales from night (30% of the cells) to overhead sun."""
    from wrfchem_arc_interactions_tpu_torch.chem import gas
    rng = np.random.default_rng(seed)
    t_air = torch.from_numpy(rng.uniform(215.0, 305.0, ncell).astype(np.float32))
    m_air = (rng.uniform(0.3, 1.0, ncell) * 2.5e19).astype(np.float32)
    js = rng.uniform(0.0, 1.0, ncell) * (rng.uniform(size=ncell) > 0.3)
    ppm = {"o3": 0.04, "no2": 2e-3, "no": 1e-3, "co": 0.12, "so2": 2e-3, "h2o2": 1e-3,
           "ch4": 1.7, "hcho": 1e-3, "par": 5e-3, "isop": 1e-3, "tol": 1e-4}
    conc = np.zeros((gas.NS, ncell), np.float32)
    for sp, v in ppm.items():
        conc[gas.IDX[sp]] = v * 1e-6 * m_air * rng.uniform(0.5, 2.0, ncell)
    k = gas.rate_constants(t_air, torch.from_numpy(m_air),
                           torch.from_numpy(js.astype(np.float32)))
    return torch.from_numpy(conc).to(dev), k.contiguous().to(dev)


def _ros2_compare(kin, ros2_kernel, conc, k, dt_total, n_sub):
    """Kernel, plain version and vectorised form on the same inputs:
    (max |a-b| / (|b| + 1e3) vs plain, max |a-b| vs plain, bitwise equal,
    max |a-b| / (|b| + 1e3) vs vectorised).  Raises past the limits."""
    out = ros2_kernel.ros2_integrate(kin, conc, k, dt_total, n_sub)
    ref = ros2_kernel.integrate_reference(kin, conc, k, dt_total, n_sub)
    vec = conc
    for _ in range(n_sub):
        vec = kin.step_ros2(vec, k, dt_total / n_sub)
    torch.cuda.synchronize()
    if out.shape != conc.shape or not (torch.isfinite(out).all() and (out >= 0).all()):
        raise RuntimeError("ros2_integrate: wrong shape, non-finite or negative output")
    max_abs = float((out - ref).abs().max())
    err = float(((out - ref).abs() / (ref.abs() + 1e3)).max())
    err_vec = float(((out - vec).abs() / (vec.abs() + 1e3)).max())
    equal = bool(torch.equal(out, ref))
    print(f"ros2_integrate (kernel) vs plain on the card at {conc.shape[1]} cells, n_sub "
          f"{n_sub}: max|a-b|/(|b|+1e3) = {err:.3g} (limit 1e-5; built with --fmad=false), "
          f"max|a-b| = {max_abs:.6g} molec/cm3, bitwise equal {equal}; "
          f"vs the vectorised form {err_vec:.3g} (limit 5e-3)")
    if not err <= 1e-5:
        raise RuntimeError(f"ros2_integrate disagrees with its plain version: {err}")
    if not err_vec <= 5e-3:
        raise RuntimeError(f"ros2_integrate disagrees with the vectorised form: {err_vec}")
    return err, max_abs, equal, err_vec


def kernel_ros2(dev, ncell, n_sub=2, dt_total=60.0):
    """The generated ROS2 kernel against its plain version (the same
    program walked on tensors) at the main path's `ncell` cells and `n_sub`
    substeps, and at 4,133 cells (a short grid with a ragged last block);
    then its time at `ncell` cells beside the plain version's and the
    vectorised CPU-path form's device time (profiler: both are thousands of
    launches).  The entry's errors are the ones at `ncell` cells."""
    from wrfchem_arc_interactions_tpu_torch.chem import gas
    from wrfchem_arc_interactions_tpu_torch.ops import ros2_kernel
    kin = gas._kinetics()
    _ros2_compare(kin, ros2_kernel, *_gas_inputs(4096 + 37, 5, dev), dt_total, n_sub)
    conc, k = _gas_inputs(ncell, 6, dev)
    err, max_abs, equal, err_vec = _ros2_compare(kin, ros2_kernel, conc, k, dt_total, n_sub)

    ms = _device_ms(lambda: ros2_kernel.ros2_integrate(kin, conc, k, dt_total, n_sub),
                    calls=5, trials=20)
    plain_ms = _profiled_ms(lambda: ros2_kernel.integrate_reference(
        kin, conc, k, dt_total, n_sub), reps=1)

    def vectorised():
        c = conc
        for _ in range(n_sub):
            c = kin.step_ros2(c, k, dt_total / n_sub)
        return c

    vec_ms = _profiled_ms(vectorised, reps=1)
    flops = ros2_kernel.flops_per_substep(kin)
    bound = _bound(4 * (2 * kin.ns + kin.nr) * ncell, n_sub * flops * ncell)
    print(f"ros2_integrate at {ncell} cells, n_sub {n_sub} ({flops} flops per substep and "
          f"cell), device time per call: kernel {ms:.4f} ms at {ros2_kernel.THREADS} "
          f"threads per block, {ros2_kernel.BLOCKS_PER_SM} blocks per SM and "
          f"{ros2_kernel.generate_source(kin)['shared_bytes']} bytes of shared memory per "
          f"block, plain {plain_ms:.3f} ms, vectorised form {vec_ms:.3f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}, {100.0 * bound[0] / ms:.1f}% of it)")
    entry = _entry("ros2_integrate", None, max_abs, ms, plain_ms, bound, source=ROS2_SOURCE)
    entry.update(vectorised_ms=vec_ms, flops_per_substep=flops, max_rel_err=err,
                 max_rel_err_vectorised=err_vec, bitwise_equal=equal, compared_at_cells=ncell)
    return entry


# (nz, ny, nx) that stress the multi-tracer kernel's ring of planes (fewer
# levels than the ring holds), its tile (one row; rows that do not fill the
# last tile) and its slots (rows narrower and wider than a warp; a row so
# wide that a thread owns eight slots, not four); and rows wider than one
# tile holds, which it splits into x tiles (held bitwise)
TRACER_SHAPES = ((1, 1, 13), (2, 5, 33), (3, 9, 13), (5, 17, 33), (50, 9, 13), (2, 4, 300),
                 (2, 4, 1000), (5, 17, 1000))
WIDE_ROW = 1000


def tracer_boundary_cases():
    """(nz, ny, nx, bc_x, bc_y) over `TRACER_SHAPES` and the three lateral
    boundary kinds.  A boundary's halo of 3 needs 3 rows (periodic) or 4
    (symmetric); a single row is open in y and takes each kind in x."""
    cases = []
    for nz, ny, nx in TRACER_SHAPES:
        for bc in ("open", "symmetric", "periodic"):
            need = {"open": 1, "periodic": 3, "symmetric": 4}[bc]
            cases.append((nz, ny, nx, bc, bc if ny >= need else "open"))
    return cases


def _tracers_boundaries(dev, grid, nt=3):
    """The kernel against its plain version at `tracer_boundary_cases`, with
    and without the limiter (the main paths are periodic, 100 x 100 x 50):
    the limiter reads neighbour factors through each boundary's index map."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    gen = torch.Generator(device="cpu").manual_seed(3)
    worst, bitwise = 0.0, 0
    cases = tracer_boundary_cases()
    for nz, ny, nx, bc_x, bc_y in cases:
        g = dataclasses.replace(grid, rdnw=grid.rdnw[:nz].contiguous())
        mub = float(grid.mub.mean()) * (0.995 + 0.01 * torch.rand((ny, nx), generator=gen))
        q = 2.0 * torch.rand((nt, nz, ny, nx), generator=gen) \
            * (torch.rand((nt, nz, ny, nx), generator=gen) > 0.5)
        ru = mub * 20.0 * torch.randn((nz, ny, nx), generator=gen)
        rv = mub * 20.0 * torch.randn((nz, ny, nx), generator=gen)
        ww = 100.0 * torch.randn((nz + 1, ny, nx), generator=gen)
        ww[0] = 0.0
        ww[-1] = 0.0
        pt = 1e-3 * torch.randn((nt, nz, ny, nx), generator=gen)
        q, ru, rv, ww, pt, mub = (a.to(dev) for a in (q, ru, rv, ww, pt, mub))
        hx = HaloOps(bc_x=BCKind(bc_x), bc_y=BCKind(bc_y))
        args = (hx.pad(q, 3), mub * q, hx.pad(ru, 3), hx.pad(rv, 3), ww, mub,
                1.001 * mub, g, hx, 6.0)
        for pd in (False, True):
            out = tracers_kernel.advect_tracers(*args, pt=pt, pd=pd, clip=pd)
            ref = tracers_kernel.advect_tracers_reference(*args, pt=pt, pd=pd, clip=pd)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max() / q.abs().max())
            worst = max(worst, err)
            if not err <= 1e-5 or (nx >= WIDE_ROW and not torch.equal(out, ref)):
                raise RuntimeError(f"advect_tracers at (nt, nz, ny, nx) = {(nt, nz, ny, nx)}, "
                                   f"x {bc_x}, y {bc_y}, limiter {pd} disagrees with its "
                                   f"plain version: {err}")
            bitwise += int(torch.equal(out, ref))
    print(f"advect_tracers (kernel) vs plain with and without the limiter at {len(cases)} "
          f"shapes and boundary kinds (nz 1-50, ny 1-17, nx 13, 33, 300 and {WIDE_ROW}, the "
          f"last in x tiles; open, symmetric, periodic): max|d|/max|q| = {worst:.3g} (limit "
          f"1e-5; rows of {WIDE_ROW} bitwise), {bitwise} of {2 * len(cases)} calls bitwise "
          f"equal; one tile spans {tracers_kernel.widest_row(False)} cells without the "
          f"limiter, {tracers_kernel.widest_row(True)} with it")


def _tracer_grids_per_step() -> int:
    """advect_tracers counts grids: a step calls it without the limiter on
    stages 0 and 1 and with it on stage 2."""
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    return 2 * tracers_kernel.GRIDS_PLAIN + tracers_kernel.GRIDS_LIMITED


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
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": 4, "ros2_integrate": 0}
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
    chunked = _rad_in_chunks(rad, sim, t_now, out, 4096)
    del out
    print(f"phases, synchronised: main step {main_ms:.3f} ms, rad call {rad_ms:.3f} ms, "
          f"chem call {chem_ms:.3f} ms; per step of the window: main + (rad + chem)/"
          f"{steps} = {main_ms + (rad_ms + chem_ms) / steps:.3f} ms; rad call peak "
          f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB held before it; {sim.grid.ny * sim.grid.nx} columns in "
          f"chunks of at most {_col_chunk()}); {chunked}")
    dycore_on_path(lambda: main(sim.state, sim.grid, t_now), "config 3")
    return sim, launches, ms_step


def _col_chunk() -> int:
    from wrfchem_arc_interactions_tpu_torch.physics.radiation import driver
    return driver.COL_CHUNK


RAD_FIELDS = ("rthraten_sw", "rthraten_lw", "swdown", "swupt", "olr", "glw", "cldfra")


def _rad_in_chunks(rad, sim, t_now, whole, chunk):
    """The rad call again with the column chunk set to `chunk`: every field
    must equal `whole` (the call at the driver's chunk) bit for bit.
    Returns the line to print."""
    from wrfchem_arc_interactions_tpu_torch.physics.radiation import driver
    keep = driver.COL_CHUNK
    driver.COL_CHUNK = chunk
    try:
        torch.cuda.reset_peak_memory_stats()
        out = rad(sim.state, sim.grid, t_now)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        driver.COL_CHUNK = keep
    differ = [k for k in RAD_FIELDS if k in whole and not torch.equal(out[k], whole[k])]
    if differ:
        raise RuntimeError(f"rad call in chunks of {chunk} columns differs from one chunk "
                           f"in {differ}")
    return (f"in chunks of {chunk} columns the rad call equals it bit for bit, peak "
            f"{peak / 2**30:.3f} GiB")


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
    want = {"advect_scalar_5_3": 9 * steps, "advect_tracers": 0, "mie_cheb_eval": 0,
            "ros2_integrate": 0}
    if launches != want:
        raise RuntimeError(f"slice 1's path: launches {launches}, expected {want}")
    if not all(bool(torch.isfinite(v).all()) for v in sim.state.values()):
        raise RuntimeError("slice 1's path: non-finite fields")
    print(f"slice 1's path (radiation and chemistry off): {steps} steps, "
          f"{wall / steps * 1e3:.3f} ms/step [{card}]; kernel launches {launches}")
    dycore_on_path(lambda: sim.advance(1), "slice 1's path")
    return launches


def slice4_phase(dev, card, steps=RAD_CHEM_EVERY):
    """BASELINE config 4 through `Simulation`: one 100-step window with 10
    chem calls and 1 rad call, the physical checks, the exact launch counts
    of all four kernels, the synchronised phase times and a profile of one
    chem call.  Returns (launches, numbers)."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    cfg = _cfg4()
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state = _seed4(state)
    sim = Simulation(cfg, grid, state, device=dev)
    nt = len(advected_names(cfg))
    print(f"case squall2d_x 100x100x50 (config 4, {len(state)} fields, {nt} advected "
          f"scalars) built in {time.perf_counter() - t0:.2f} s")
    if not (nt == 107 and sim.rad_every == steps and sim.chem_every == 10):
        raise RuntimeError(f"config 4: {nt} scalars, rad every {sim.rad_every}, chem "
                           f"every {sim.chem_every}; expected 107, {steps}, 10")
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)              # steps 2..101: chem at 10, 20, .., 100; rad at 100
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"config 4: non-finite {k} after {steps + 2} steps")
    neg = [k for k, v in s.items() if k.startswith("chem_") and float(v.min()) < 0.0]
    if neg:
        raise RuntimeError(f"config 4: negative chem fields {neg}")
    o3 = (float(s["chem_o3"].min()), float(s["chem_o3"].max()))
    if not (0.02 <= o3[0] and o3[1] <= 0.06):
        raise RuntimeError(f"config 4: O3 {o3} ppmv outside 0.02-0.06 (seed 0.04)")
    w_max = float(s["w"].max())
    if not 0.0 < w_max < 60.0:
        raise RuntimeError(f"config 4: max w = {w_max} m/s outside (0, 60)")
    cloudy = s["qc"] > 1e-6
    n_cloudy = int(cloudy.sum())
    with_nc = int((s["nc"][cloudy] > 0.0).sum())
    # at a cloud's evaporating or raining-out edge the scheme can leave a
    # little water with its droplet number clipped to 0 (a few percent of
    # the cloudy cells); the bulk of the cloud must carry droplets
    if n_cloudy and with_nc < 0.9 * n_cloudy:
        raise RuntimeError(f"config 4: droplet number in only {with_nc} of {n_cloudy} "
                           "cells with cloud water")
    if not float(s["tau_aer_sw"].min()) > 0.0:
        raise RuntimeError("config 4: tau_aer_sw is not positive where the bins are seeded")
    olr = (float(s["olr"].min()), float(s["olr"].max()))
    if not (100.0 <= olr[0] and olr[1] <= 400.0):
        raise RuntimeError(f"config 4: OLR {olr} outside 100-400 W m-2")
    n_chem = steps // sim.chem_every
    # theta takes the single-scalar kernel on 3 stages; the 107 scalars take
    # the multi-tracer kernel (two calls without the limiter and one with it
    # per step); each chem call launches the Mie kernel once per bin and the
    # ROS2 kernel once (its substeps are fused into the one launch)
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": 4 * n_chem, "ros2_integrate": n_chem}
    if launches != want:
        raise RuntimeError(f"config 4: kernel launches in the {steps}-step window "
                           f"{launches}, expected {want}")
    d = cfg.domain
    ms_step = wall / steps * 1e3
    print(f"slice (config 4): {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up "
          f"steps, {n_chem} chem calls and one rad call in the window: {ms_step:.3f} "
          f"ms/step, {d.nx * d.ny * d.nz / (wall / steps) / 1e6:.4f} M gridpoints/s "
          f"[{card}]; max w {w_max:.3f} m/s, max qc {float(s['qc'].max()):.3e}, cloudy "
          f"cells {n_cloudy} ({with_nc} with droplets, max nc {float(s['nc'].max()):.3e} "
          f"/kg), O3 {o3[0]:.5f}-{o3[1]:.5f} ppmv, max OH {float(s['chem_oh'].max()):.3e}, "
          f"OLR {olr[0]:.1f}-{olr[1]:.1f} W m-2, tau_aer_sw "
          f"{float(s['tau_aer_sw'].min()):.4g}-{float(s['tau_aer_sw'].max()):.4g}; "
          f"kernel launches {launches}")

    t_now = np.float32(sim.time_s)
    main, rad, chem = (sim._stepper(k) for k in ("main", "rad", "chem"))
    main_ms = _timed_ms(lambda: main(sim.state, sim.grid, t_now), 5)
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 2)
    chem_ms = _timed_ms(lambda: chem(sim.state, sim.grid, t_now), 3)
    print(f"phases (config 4), synchronised: main step {main_ms:.3f} ms, rad call "
          f"{rad_ms:.3f} ms, chem call {chem_ms:.3f} ms; per step of the window: main + "
          f"chem/{sim.chem_every} + rad/{steps} = "
          f"{main_ms + chem_ms / sim.chem_every + rad_ms / steps:.3f} ms")
    dev_ms, n_kernels, rows = _profile(lambda: chem(sim.state, sim.grid, t_now))
    print(f"profile of one config-4 chem call: device busy {dev_ms:.3f} ms in {n_kernels} "
          f"kernels; ros2_kernel {_per_call_us(rows, 'ros2_kernel') / 1e3:.4f} ms, "
          f"mie_cheb_eval {_per_call_us(rows, 'mie_cheb_eval') / 1e3:.4f} ms per launch on "
          f"the main path's inputs")
    for t_us, count, key in rows[:6]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    mie_path = mie_on_path(lambda: chem(sim.state, sim.grid, t_now), card)
    sim.sync()
    dev2_ms, n2, rows2 = _profile(lambda: sim.advance(1))     # step 107: main only
    print(f"profile of one config-4 main step: device busy {dev2_ms:.3f} ms in {n2} "
          f"kernels; against the unprofiled {ms_step:.3f} ms/step the device is busy "
          f"{100.0 * (dev2_ms + dev_ms / sim.chem_every) / ms_step:.1f}% (main step + a "
          f"tenth of a chem call); advect_tracers grids: {_tracer_grids_us(rows2)}")
    for t_us, count, key in rows2[:6]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    dycore_on_path(lambda: sim.advance(1), "config 4")
    return launches, mie_path


def _check_emissions(call, dt):
    """The column burden of the emitted species rises as the fluxes say:
    per column and level, the mass added (q change x rho dz) is the surface
    flux x dt in the lowest layer plus the elevated flux x dt x the plume
    weight.  Returns (worst relative error, fraction of the elevated mass
    injected above the lowest layer)."""
    (chem, emis, rho0, dz0, _), kw, out = call
    rho, dz, plume_w = kw["rho"], kw["dz"], kw["plume_w"]
    worst = 0.0
    for sp in ("so2", "no", "co", "nh3"):
        key = f"chem_{sp}"
        added = (out[key].double() - chem[key].double()) * (rho * dz).double()
        want = torch.zeros_like(added)
        want[0] = emis[sp].double() * dt
        if f"elev_{sp}" in emis:
            want = want + plume_w.double() * emis[f"elev_{sp}"].double()[None] * dt
        col = want.sum(dim=0)
        err = float((added - want).abs().max() / col.abs().max())
        err_col = float((added.sum(dim=0) - col).abs().max() / col.abs().max())
        worst = max(worst, err, err_col)
    elev = emis["elev_so2"].double()[None] * plume_w.double()
    aloft = float(elev[1:].sum() / elev.sum())
    if not worst <= 1e-3:
        raise RuntimeError(f"slice 6: emitted burden off the fluxes by {worst:.3g} of the "
                           "column's rise")
    if not aloft > 0.0:
        raise RuntimeError("slice 6: plume rise put no elevated mass above the lowest layer")
    return worst, aloft


def _check_cw_exchange(call, nbin):
    """One cw_exchange call on the card conserves each (bin, species)
    interstitial + cloud-borne total to float32 rounding (2^-22 of the
    total), and leaves cloud-borne number in every cell with cloud water
    (qc > QC_CLOUD).  Returns (worst relative change, cloudy cells, those
    with an updraft of 1 m/s or more)."""
    from wrfchem_arc_interactions_tpu_torch.chem import aux
    from wrfchem_arc_interactions_tpu_torch.chem.mosaic.bins import AER_SPECIES
    (chem, qc, _, _, _, w_up, _), _, out = call
    worst = 0.0
    for b in range(1, nbin + 1):
        for sp in tuple(AER_SPECIES) + ("num",):
            ki, kc = f"chem_{sp}_a{b:02d}", f"chem_{sp}_cw{b:02d}"
            tot0 = chem[ki].double() + chem[kc].double()
            tot1 = out[ki].double() + out[kc].double()
            d = (tot1 - tot0).abs()
            if not bool((d <= 2.0 ** -22 * tot0.abs()).all()):
                raise RuntimeError(f"slice 6: cw_exchange changed the {sp} total of bin {b} "
                                   f"by {float(d.max()):.3g}")
            worst = max(worst, float((d / tot0.abs().clamp(min=1e-30)).max()))
    cloudy = qc > aux.QC_CLOUD
    num_cw = sum(out[f"chem_num_cw{b:02d}"] for b in range(1, nbin + 1))
    n_cloudy, with_cw = int(cloudy.sum()), int((num_cw[cloudy] > 0.0).sum())
    if n_cloudy == 0 or with_cw != n_cloudy:
        raise RuntimeError(f"slice 6: cloud-borne number in {with_cw} of {n_cloudy} cells "
                           "with qc > QC_CLOUD")
    return worst, n_cloudy, int((cloudy & (w_up >= 1.0)).sum())


def _check_wet_scavenging(call, dev, nbin):
    """Rain lowers the scavenged fields: where rain water exceeds 1e-5 kg/kg
    every populated cloud-borne, interstitial and soluble-gas field falls,
    and where there is none nothing moves.  On the path's own rain when the
    window has rain, else on a seeded rain field over the same chem
    fields.  Returns (source of the rain, raining cells)."""
    from wrfchem_arc_interactions_tpu_torch.chem import aux
    (chem, qr, dt, gas_names), kw, out = call
    source = "the path's"
    if not float(qr.max()) > 1e-5:
        gen = torch.Generator(device="cpu").manual_seed(7)
        qr = (2e-3 * torch.rand(qr.shape, generator=gen)
              * (torch.rand(qr.shape, generator=gen) > 0.5)).to(dev)
        out = aux.wet_scavenging(chem, qr, dt, gas_names, **kw)
        source = "a seeded"
    raining, dry = qr > 1e-5, qr == 0.0
    for key in ("chem_num_cw01", "chem_so4_cw01", "chem_num_a01", "chem_so4_a02",
                f"chem_num_a{nbin:02d}", "chem_hno3", "chem_so2", "chem_h2o2"):
        fell = out[key] < chem[key]
        held = chem[key] > 1e-30
        if not bool(fell[raining & held].all()):
            raise RuntimeError(f"slice 6: rain did not lower {key} everywhere it rains")
        if not torch.equal(out[key][dry], chem[key][dry]):
            raise RuntimeError(f"slice 6: wet scavenging moved {key} where it does not rain")
    return source, int(raining.sum())


def slice6_phase(dev, card, steps=RAD_CHEM_EVERY):
    """Slice 6's path through `Simulation`: bench.py's --config4-8bin with
    emissions (plume rise), the cloud-borne phase with aqueous chemistry and
    wet scavenging, 219 advected scalars; one 100-step window with 10 chem
    and 1 rad call, the exact launches of all four kernels, the physical
    checks, the synchronised phase times, a profile of one chem call, the
    Mie kernel on the 8 bins' own inputs, the scalar advection and the
    multi-tracer kernel bitwise on the path's own inputs, and the
    multi-tracer kernel at 219 scalars on this grid, timed beside its
    bound.  Returns (launches, numbers)."""
    from wrfchem_arc_interactions_tpu_torch.chem import aux
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    cfg = _cfg6()
    nbin = 8
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state = _seed4(state)
    emissions = _emissions6(grid)
    sim = Simulation(cfg, grid, state, device=dev, emissions=emissions)
    nt = len(advected_names(cfg))
    n_cw = len([k for k in advected_names(cfg) if "_cw" in k])
    print(f"case squall2d_x 100x100x50 (slice 6: cbmz_mosaic_8bin with emissions, the "
          f"cloud-borne phase and wet scavenging; {len(state)} fields, {nt} advected scalars, "
          f"{n_cw} of them cloud-borne; emissions {sorted(emissions)}) built in "
          f"{time.perf_counter() - t0:.2f} s")
    if not (nt == 219 and n_cw == 72 and sim.rad_every == steps and sim.chem_every == 10):
        raise RuntimeError(f"slice 6: {nt} scalars ({n_cw} cloud-borne), rad every "
                           f"{sim.rad_every}, chem every {sim.chem_every}; expected 219 (72), "
                           f"{steps}, 10")
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)              # steps 2..101: chem at 10, 20, .., 100; rad at 100
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"slice 6: non-finite {k} after {steps + 2} steps")
    neg = [k for k, v in s.items() if k.startswith("chem_") and float(v.min()) < 0.0]
    if neg:
        raise RuntimeError(f"slice 6: negative chem fields {neg}")
    n_chem = steps // sim.chem_every
    # theta: the single-scalar kernel on 3 stages; the 219 scalars: the
    # multi-tracer kernel's 4 grids a step; each chem call launches the Mie
    # kernel once per bin (8) and the ROS2 kernel once
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": nbin * n_chem, "ros2_integrate": n_chem}
    if launches != want:
        raise RuntimeError(f"slice 6: kernel launches in the {steps}-step window "
                           f"{launches}, expected {want}")
    w_max = float(s["w"].max())
    cw_max = float(sum(s[f"chem_num_cw{b:02d}"] for b in range(1, nbin + 1)).max())
    d = cfg.domain
    ms_step = wall / steps * 1e3
    print(f"slice 6: {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up steps, {n_chem} "
          f"chem calls and one rad call in the window: {ms_step:.3f} ms/step, "
          f"{d.nx * d.ny * d.nz / (wall / steps) / 1e6:.4f} M gridpoints/s [{card}]; max w "
          f"{w_max:.3f} m/s, max qc {float(s['qc'].max()):.3e}, max qr "
          f"{float(s['qr'].max()):.3e}, max cloud-borne number {cw_max:.3e} /kg, so2 "
          f"{float(s['chem_so2'].min()):.4g}-{float(s['chem_so2'].max()):.4g} ppmv, nh3 "
          f"max {float(s['chem_nh3'].max()):.4g} ppmv, tau_aer_sw "
          f"{float(s['tau_aer_sw'].min()):.4g}-{float(s['tau_aer_sw'].max()):.4g}; kernel "
          f"launches {launches}")

    t_now = np.float32(sim.time_s)
    main, rad, chem = (sim._stepper(k) for k in ("main", "rad", "chem"))
    with _Recorded(aux, "apply_emissions", "cw_exchange", "wet_scavenging") as calls:
        chem(sim.state, sim.grid, t_now)
        torch.cuda.synchronize()
    if any(len(v) != 1 for v in calls.values()):
        raise RuntimeError(f"slice 6: stage calls in one chem call "
                           f"{ {k: len(v) for k, v in calls.items()} }, expected one each")
    dt = cfg.chem.chemdt_s
    em_err, aloft = _check_emissions(calls["apply_emissions"][0], dt)
    cw_err, n_cloudy, n_rising = _check_cw_exchange(calls["cw_exchange"][0], nbin)
    rain_src, n_rain = _check_wet_scavenging(calls["wet_scavenging"][0], dev, nbin)
    print(f"slice 6, one chem call on the card: emitted burden as the fluxes say within "
          f"{em_err:.3g} of each column's rise, {100.0 * aloft:.1f}% of the elevated so2 "
          f"above the lowest layer; cw_exchange conserves each (bin, species) total within "
          f"{cw_err:.3g} (limit 2^-22), cloud-borne number in every one of the {n_cloudy} "
          f"cells with qc > {aux.QC_CLOUD} ({n_rising} of them in updrafts of 1 m/s or "
          f"more); rain lowered the scavenged fields in {n_rain} raining "
          f"cells ({rain_src} rain) and moved nothing where it does not rain")
    del calls
    main_ms = _timed_ms(lambda: main(sim.state, sim.grid, t_now), 5)
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 2)
    chem_ms = _timed_ms(lambda: chem(sim.state, sim.grid, t_now), 3)
    print(f"phases (slice 6), synchronised: main step {main_ms:.3f} ms, rad call "
          f"{rad_ms:.3f} ms, chem call {chem_ms:.3f} ms; per step of the window: main + "
          f"chem/{sim.chem_every} + rad/{steps} = "
          f"{main_ms + chem_ms / sim.chem_every + rad_ms / steps:.3f} ms")
    dev_ms, n_kernels, rows = _profile(lambda: chem(sim.state, sim.grid, t_now))
    print(f"profile of one slice-6 chem call: device busy {dev_ms:.3f} ms in {n_kernels} "
          f"launches; ros2_kernel {_per_call_us(rows, 'ros2_kernel') / 1e3:.4f} ms, "
          f"mie_cheb_eval {_per_call_us(rows, 'mie_cheb_eval') / 1e3:.4f} ms per launch")
    for t_us, count, key in rows[:6]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    mie_path = mie_on_path(lambda: chem(sim.state, sim.grid, t_now), card, "slice 6")
    if len(mie_path) != nbin:
        raise RuntimeError(f"slice 6: {len(mie_path)} Mie calls in one chem call, expected "
                           f"{nbin}")
    sim.sync()
    dev2_ms, n2, rows2 = _profile(lambda: sim.advance(1))     # step 107: main only
    print(f"profile of one slice-6 main step: device busy {dev2_ms:.3f} ms in {n2} "
          f"launches; against the unprofiled {ms_step:.3f} ms/step the device is busy "
          f"{100.0 * (dev2_ms + dev_ms / sim.chem_every) / ms_step:.1f}% (main step + a "
          f"tenth of a chem call); advect_tracers grids: {_tracer_grids_us(rows2)}")
    dycore_on_path(lambda: sim.advance(1), "slice 6")
    modes = kernel_tracers(dev, sim.grid, nt)
    numbers = {"ms_step": ms_step, "main_ms": main_ms, "chem_ms": chem_ms, "rad_ms": rad_ms,
               "chem_device_ms": dev_ms, "chem_launches": n_kernels,
               "main_device_ms": dev2_ms, "main_launches": n2, "mie_by_bin": mie_path,
               "tracers_modes": modes}
    return launches, numbers


def slice7_phase(dev, card, steps=RAD_CHEM_EVERY):
    """Slice 7's path through `Simulation`: config 4 with WRF-Chem's usual
    transport and boundary layer (`_cfg7`); one 100-step window with 10 chem
    and 1 rad call, the exact launches of all four kernels (the final
    stage's monotonic update is a plain batched pass, so the multi-tracer
    kernel runs 2 grids a step), the physical checks (finite fields, no
    negative chem or moist field, the PBL height inside the domain, the
    soil state in its bounds), the synchronised phase times, a profile of
    one main step, and the scalar advection and the multi-tracer kernel
    bitwise on one main step's own calls.  Returns (launches, numbers)."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.physics import lsm
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    cfg = _cfg7()
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state = _seed4(state)
    sim = Simulation(cfg, grid, state, device=dev)
    nt = len(advected_names(cfg))
    print(f"case squall2d_x 100x100x50 (slice 7: config 4 with moist and chem "
          f"mono, diff_6th_opt 2, smag2d, kvdif 0, YSU + revised MM5 + Noah; {len(state)} "
          f"fields, {nt} advected scalars) built in {time.perf_counter() - t0:.2f} s")
    if not (nt == 107 and sim.rad_every == steps and sim.chem_every == 10):
        raise RuntimeError(f"slice 7: {nt} scalars, rad every {sim.rad_every}, chem every "
                           f"{sim.chem_every}; expected 107, {steps}, 10")
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)              # steps 2..101: chem at 10, 20, .., 100; rad at 100
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"slice 7: non-finite {k} after {steps + 2} steps")
    neg = [k for k in list(cfg.moist_species()) + [k for k in s if k.startswith("chem_")]
           if float(s[k].min()) < 0.0]
    if neg:
        raise RuntimeError(f"slice 7: negative fields {neg}")
    ztop = float(sim.grid.phb[-1].max()) / 9.81
    pblh = (float(s["pblh"].min()), float(s["pblh"].max()))
    if not (0.0 < pblh[0] and pblh[1] < ztop):
        raise RuntimeError(f"slice 7: pblh {pblh} outside (0, {ztop:.0f}) m")
    tslb = (float(s["tslb"].min()), float(s["tslb"].max()))
    smois = (float(s["smois"].min()), float(s["smois"].max()))
    # Noah clips soil moisture to [0.02, porosity]; soil temperature stays
    # near the skin's starting 297 K over 10 minutes
    if not (0.02 <= smois[0] and smois[1] <= lsm.SM_SAT and 250.0 < tslb[0]
            and tslb[1] < 330.0):
        raise RuntimeError(f"slice 7: soil state out of bounds: tslb {tslb} K, smois {smois}")
    n_chem = steps // sim.chem_every
    # theta: the single-scalar kernel on 3 stages; the 107 scalars: the
    # multi-tracer kernel without the limiter on stages 0 and 1 (the final
    # stage's monotonic update is the plain batched pass); each chem call
    # launches the Mie kernel once per bin and the ROS2 kernel once
    want = {"advect_scalar_5_3": 3 * steps,
            "advect_tracers": 2 * tracers_kernel.GRIDS_PLAIN * steps,
            "mie_cheb_eval": 4 * n_chem, "ros2_integrate": n_chem}
    if launches != want:
        raise RuntimeError(f"slice 7: kernel launches in the {steps}-step window "
                           f"{launches}, expected {want}")
    d = cfg.domain
    ms_step = wall / steps * 1e3
    print(f"slice 7: {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up steps, {n_chem} "
          f"chem calls and one rad call in the window: {ms_step:.3f} ms/step, "
          f"{d.nx * d.ny * d.nz / (wall / steps) / 1e6:.4f} M gridpoints/s [{card}]; max w "
          f"{float(s['w'].max()):.3f} m/s, max qc {float(s['qc'].max()):.3e}, pblh "
          f"{pblh[0]:.1f}-{pblh[1]:.1f} m, hfx {float(s['hfx'].min()):.2f}-"
          f"{float(s['hfx'].max()):.2f} W m-2, tsk {float(s['tsk'].min()):.2f}-"
          f"{float(s['tsk'].max()):.2f} K, tslb {tslb[0]:.3f}-{tslb[1]:.3f} K, smois "
          f"{smois[0]:.4f}-{smois[1]:.4f}, O3 {float(s['chem_o3'].min()):.5f}-"
          f"{float(s['chem_o3'].max()):.5f} ppmv; kernel launches {launches}")

    t_now = np.float32(sim.time_s)
    main, rad, chem = (sim._stepper(k) for k in ("main", "rad", "chem"))
    main_ms = _timed_ms(lambda: main(sim.state, sim.grid, t_now), 5)
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 2)
    chem_ms = _timed_ms(lambda: chem(sim.state, sim.grid, t_now), 3)
    print(f"phases (slice 7), synchronised: main step {main_ms:.3f} ms, rad call "
          f"{rad_ms:.3f} ms, chem call {chem_ms:.3f} ms; per step of the window: main + "
          f"chem/{sim.chem_every} + rad/{steps} = "
          f"{main_ms + chem_ms / sim.chem_every + rad_ms / steps:.3f} ms")
    dev_c, n_c, _ = _profile(lambda: chem(sim.state, sim.grid, t_now))
    sim.sync()
    dev_ms, n_kernels, rows = _profile(lambda: sim.advance(1))     # main only
    print(f"profile of one slice-7 main step: device busy {dev_ms:.3f} ms in {n_kernels} "
          f"launches; one chem call {dev_c:.3f} ms in {n_c}; against the unprofiled "
          f"{ms_step:.3f} ms/step the device is busy "
          f"{100.0 * (dev_ms + dev_c / sim.chem_every) / ms_step:.1f}% (main step + a tenth "
          f"of a chem call); advect_tracers grids: {_tracer_grids_us(rows)}")
    for t_us, count, key in rows[:8]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    dycore_on_path(lambda: sim.advance(1), "slice 7")
    numbers = {"ms_step": ms_step, "main_ms": main_ms, "chem_ms": chem_ms, "rad_ms": rad_ms,
               "main_device_ms": dev_ms, "main_launches": n_kernels,
               "chem_device_ms": dev_c, "chem_launches": n_c,
               "device_busy_pct": 100.0 * (dev_ms + dev_c / sim.chem_every) / ms_step}
    return launches, numbers


def item7_cross_checks(dev):
    """Card against CPU, 3 steps each from noon, for the options of slice 7
    that its window does not run: the LES case with the TKE closure, the
    surface heat flux and WENO5 momentum and scalars (stacked); SPPT and
    SKEBS; MYNN over the slab surface with RRTMG; BMJ, KF and Grell with WSM6
    at dx = 10 km; and the simple radiation."""
    sq = dict(ztop=17000.0, p_top=8000.0)
    rr = dict(ra_sw_physics="rrtmg", ra_lw_physics="rrtmg", radt_s=6.0)
    weno = 7
    cross_check(dev, _cfg_small(16, 16, 16, 100.0, 0.5, 2000.0, 80000.0,
                                dynamics=dict(km_opt="tke", h_mom_adv_order=weno,
                                              v_mom_adv_order=weno, h_sca_adv_order=weno,
                                              v_sca_adv_order=weno, scan_tracer_min=2),
                                physics=dict(sf_sfclay_physics="revised_mm5",
                                             tke_heat_flux=0.2)),
                _les_state, "LES with TKE and WENO5", case="les", full_theta_ulp=True)
    s = cross_check(dev, _cfg_small(16, 8, 12, 1000.0, 6.0, **sq,
                                    dynamics=dict(kvdif=30.0, sppt_amp=0.5, skebs_amp=0.5)),
                    lambda st: st, "SPPT and SKEBS")
    if not float(s["sppt_pattern"].abs().max()) > 0.0:
        raise RuntimeError("SPPT and SKEBS: the pattern stayed zero")
    s = cross_check(dev, _cfg_small(16, 8, 20, 1000.0, 6.0, **sq, dynamics=dict(kvdif=0.0),
                                    physics=dict(bl_pbl_physics="mynn",
                                                 sf_sfclay_physics="revised_mm5", **rr)),
                    lambda st: st, "MYNN over the slab surface")
    if not float(s["qke"].max()) > 1e-4:
        raise RuntimeError("MYNN: no QKE produced")
    for cu in ("bmj", "kf", "grell"):
        s = cross_check(dev, _cfg_small(24, 4, 20, 10000.0, 30.0, 16000.0, 10000.0,
                                        dynamics=dict(kvdif=30.0),
                                        physics=dict(mp_physics="wsm6", cu_physics=cu)),
                        lambda st: st, f"{cu.upper()} with WSM6 at dx = 10 km")
        print(f"  {cu}: rainc max {float(s['rainc'].max()):.4g} mm after 3 steps")
    cross_check(dev, _cfg_small(16, 8, 20, 1000.0, 6.0, **sq, dynamics=dict(kvdif=30.0),
                                physics=dict(ra_sw_physics="simple", ra_lw_physics="simple",
                                             radt_s=6.0)),
                lambda st: st, "the simple radiation")


def wide_phase(dev, card, steps=3):
    """Config 3 at 1000x100x50 (100,000 columns; x rows wider than one tile
    of the multi-tracer kernel): that kernel at config 3's 47 scalars on
    this grid, timed beside its bound; then `steps` steps through
    `Simulation` (both alarms ring at step 0: one rad and one chem call),
    the exact launches, finite fields, the rad call's peak memory, the Mie
    kernel on one chem call's own inputs and the scalar advection and the
    multi-tracer kernel bitwise on one main step's.  Returns (modes,
    launches, Mie numbers by bin)."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = _cfg3(nx=1000)
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state = _seed(state)
    print(f"case squall2d_x 1000x100x50 (config 3, {grid.ny * grid.nx} columns) built in "
          f"{time.perf_counter() - t0:.2f} s")
    modes = kernel_tracers(dev, grid, nt=47)
    torch.cuda.empty_cache()
    sim = Simulation(cfg, grid, state, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = {"advect_scalar_5_3": 3 * steps,
            "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": 4, "ros2_integrate": 0}
    if launches != want:
        raise RuntimeError(f"config 3 at 1000x100x50: launches {launches}, expected {want}")
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"config 3 at 1000x100x50: non-finite {k}")
    olr = (float(s["olr"].min()), float(s["olr"].max()))
    if not (100.0 <= olr[0] and olr[1] <= 400.0):
        raise RuntimeError(f"config 3 at 1000x100x50: OLR {olr} outside 100-400 W m-2")
    if not float(s["tau_aer_sw"].min()) > 0.0:
        raise RuntimeError("config 3 at 1000x100x50: tau_aer_sw is not positive")
    rad = sim._stepper("rad")
    t_now = np.float32(sim.time_s)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = rad(sim.state, sim.grid, t_now)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 1)
    print(f"config 3 at 1000x100x50: {steps} steps (one rad and one chem call at step 0) in "
          f"{wall:.2f} s [{card}], OLR {olr[0]:.1f}-{olr[1]:.1f} W m-2, launches {launches}; "
          f"rad call {rad_ms:.3f} ms synchronised, peak memory {peak / 2**30:.3f} GiB "
          f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it; "
          f"{grid.ny * grid.nx} columns in chunks of at most {_col_chunk()})")
    torch.cuda.empty_cache()
    chem = sim._stepper("chem")
    label = "config 3 at 1000x100x50"
    mie_path = mie_on_path(lambda: chem(sim.state, sim.grid, t_now), card, label)
    if len(mie_path) != 4:
        raise RuntimeError(f"{label}: {len(mie_path)} Mie calls in one chem call, expected 4")
    torch.cuda.empty_cache()
    dycore_on_path(lambda: sim.advance(1), label)
    return modes, launches, mie_path


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


def _tracer_grids_us(rows) -> str:
    """Device time per launch of the multi-tracer kernel's grids, by the
    mode in the kernel's name (0 without the limiter, 1 the r_hi grid, 2 the
    limited update)."""
    import re
    names = {"0": "no limiter", "1": "r_hi", "2": "limited update"}
    parts = []
    for t, n, key in rows:
        m = re.search(r"stage_kernel<(?:\(\w+\))?(\d)", key)
        if m:
            parts.append((m.group(1), f"{names.get(m.group(1), m.group(1))} {t / n:.2f} us x {n}"))
    return ", ".join(p for _, p in sorted(parts)) or "not found in the profile"


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
          f"grids: {_tracer_grids_us(rows)}")
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


def cross_check(dev, cfg, seed, label, emissions=None, case="squall2d_x",
                full_theta_ulp=False, **case_kw):
    """3 steps of a small configuration starting at noon UTC (radiation and
    chem, where it has them, every step) on the card against the CPU.  The
    limit per field is 1e-4 of its magnitude, or three times the CPU run's
    own float32 noise (the CPU run again from theta changed by one ulp: of
    the perturbation t, or with `full_theta_ulp` of t + 300 K for a case
    whose t is zero) where that is larger — as the CPU tests hold the port
    to the reference.  Returns the card's final state."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    case_kw = case_kw or ({"bubble_amp": 3.0} if case == "squall2d_x" else {})
    grid, state = ideal.make_case(cfg, case, device="cpu", **case_kw)
    state = seed(state)
    t = state["t"]
    ulp = dict(state, t=((t + 300.0) * (1.0 + 2.0 ** -23) - 300.0 if full_theta_ulp
                         else t * (1.0 + 2.0 ** -23)))
    runs = {}
    for key, s0, where in (("gpu", state, dev), ("cpu", state, "cpu"), ("ulp", ulp, "cpu")):
        sim = Simulation(cfg, grid, s0, device=where,
                         emissions=None if emissions is None else emissions(grid))
        sim.advance(3)
        runs[key] = {k: v.double().cpu() for k, v in sim.state.items()}
    if "swdown" in runs["gpu"] and not float(runs["gpu"]["swdown"].max()) > 100.0:
        raise RuntimeError(f"cross-check ({label}): no sunlight at noon")
    phb = float(grid.phb.abs().max())
    worst = []
    for k, ref in runs["cpu"].items():
        scale = max(phb if k == "ph" else float(ref.abs().max()), 1e-30)
        err = float((runs["gpu"][k] - ref).abs().max()) / scale
        noise = float((runs["ulp"][k] - ref).abs().max()) / scale
        worst.append((err, k, noise))
        if not err <= max(1e-4, 3.0 * noise):
            raise RuntimeError(f"card vs CPU ({label}): {k} differs by {err:.3g} of "
                               f"its magnitude (CPU noise {noise:.3g})")
    worst.sort(reverse=True)
    d = cfg.domain
    print(f"cross-check 3 steps of {label} at {d.nx}x{d.ny}x{d.nz} from noon, card vs CPU, worst "
          "fields: " + ", ".join(f"{k} {e:.3g} (CPU one-ulp noise {n:.3g})"
                                  for e, k, n in worst[:4]))
    return runs["gpu"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=RAD_CHEM_EVERY,
                    help="window length; must be one alarm period (100)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from wrfchem_arc_interactions_tpu_torch.chem import gas
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.ops import build, ros2_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = _card()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kin = gas._kinetics()
    ros2_name = ros2_kernel.register(kin)        # generates the source into build/
    print(f"generated {ros2_name}.cu from the CBM-Z tables ({kin.ns} species, {kin.nr} "
          f"reactions, {kin.nnz} LU nonzeros, {ros2_kernel.flops_per_substep(kin)} flops "
          f"per substep and cell) in {time.perf_counter() - t0:.2f} s")
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
    }
    modes_nt47 = kernel_tracers(dev, grid, nt=47)
    torch.cuda.empty_cache()
    modes_nt107 = kernel_tracers(dev, grid, nt=107)
    _tracers_boundaries(dev, grid)
    torch.cuda.empty_cache()
    entries["ros2_integrate"] = kernel_ros2(dev, d.nx * d.ny * d.nz)
    torch.cuda.empty_cache()

    sim, launches3, ms_step = slice_phase(cfg, grid, state, dev, args.steps, card)
    launches1 = slice1_phase(dev, card)
    profile_phase(sim, dev, ms_step)
    cross_check(dev, _cfg3(nx=32, ny=8, nz=20, every_s=6.0,
                           start_date="2000-06-20_12:00:00"), _seed, "config 3")
    del sim, grid, state
    torch.cuda.empty_cache()
    launches4, mie_path = slice4_phase(dev, card, args.steps)
    entries["mie_cheb_eval"]["config4_inputs"] = mie_path
    torch.cuda.empty_cache()
    cross_check(dev, _cfg4(nx=32, ny=8, nz=20, chem_s=6.0, rad_s=6.0,
                           start_date="2000-06-20_12:00:00"), _seed4, "config 4")
    torch.cuda.empty_cache()
    launches6, numbers6 = slice6_phase(dev, card, args.steps)
    entries["mie_cheb_eval"]["slice6_inputs"] = numbers6.pop("mie_by_bin")
    entries["advect_tracers"] = tracers_entry(numbers6.pop("tracers_modes"),
                                              {"modes_nt107": modes_nt107,
                                               "modes_nt47": modes_nt47})
    torch.cuda.empty_cache()
    cross_check(dev, _cfg6(nx=16, ny=8, nz=20, chem_s=6.0, rad_s=6.0,
                           start_date="2000-06-20_12:00:00"), _seed4, "slice 6", _emissions6)
    torch.cuda.empty_cache()
    launches7, numbers7 = slice7_phase(dev, card, args.steps)
    torch.cuda.empty_cache()
    cross_check(dev, _cfg7(nx=16, ny=8, nz=20, chem_s=6.0, rad_s=6.0,
                           start_date="2000-06-20_12:00:00"), _seed4, "slice 7")
    item7_cross_checks(dev)
    torch.cuda.empty_cache()
    modes_wide, launches_wide, mie_wide = wide_phase(dev, card)
    entries["advect_tracers"]["modes_nt47_1000_wide"] = modes_wide
    entries["advect_tracers"]["max_abs_err"] = max(
        entries["advect_tracers"]["max_abs_err"], *(m["max_abs_err"] for m in modes_wide.values()))
    entries["mie_cheb_eval"]["config3_1000x100_inputs"] = mie_wide
    entries["mie_cheb_eval"]["max_abs_err"] = max(
        entries["mie_cheb_eval"]["max_abs_err"],
        *(b["max_abs_err"] for path in ("config4_inputs", "slice6_inputs",
                                        "config3_1000x100_inputs")
          for b in entries["mie_cheb_eval"][path].values()))
    for name, by_path in ON_PATH.items():
        entries[name]["bitwise_on_path_calls"] = by_path
    # "launches" is the count of this slice's main path, the slice-7 window,
    # which runs all four kernels; the earlier paths' counts stand beside it
    for name, entry in entries.items():
        entry["launches"] = launches7[name]
        entry["launches_by_path"] = {"slice7_window": launches7[name],
                                     "slice6_window": launches6[name],
                                     "config4_window": launches4[name],
                                     "config3_window": launches3[name],
                                     "slice1_10_steps": launches1[name],
                                     "config3_1000x100_3_steps": launches_wide[name]}
        if launches7[name] < 1:
            raise RuntimeError(f"{name} was not launched on slice 7's path")
    print(json.dumps({"slice6": numbers6, "slice7": numbers7}))
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
