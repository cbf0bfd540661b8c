"""Build the port's CUDA kernels and drive its main path on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases (each raises on failure, and the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every kernel: the three sources under
   ``wrfchem_arc_interactions_tpu_torch/csrc`` and the ROS2 gas-chemistry
   kernel, whose source ``ops/ros2_kernel.py`` generates from the CBM-Z
   tables into ``build/`` (one nvcc per source, all at once);
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it (the scalar advection kernel flat
   and with slice 9's map factor m2, bitwise; the Mie evaluator on random
   and on warp-coherent inputs; the multi-tracer kernel at config 3's 47
   and config 4's 107 scalars, and at 107 with slice 9's m2, bitwise, and
   at small shapes that stress its tile and its ring of planes on all four
   boundary kinds, specified among them, flat and with a map factor, with
   rows of 1,000 cells in x tiles held bitwise; the ROS2 kernel against its
   plain version at config 4's 500,000 cells and at 4,133 cells), timed
   with CUDA events, beside its bound, with each library's build flags
   and, for the multi-tracer kernel, the launch plan of each grid
   (`tracers_kernel.plan`: tile, blocks an SM, registers and spill bytes;
   printed beside every time of that kernel below too);
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
   times, a profile of one chem call, and the Mie and ROS2 kernels on that
   call's own inputs as the calls are made (distinct floor cells per warp,
   device time per bin, within 3.2e-4 of its plain version; the ROS2
   kernel bitwise);
9. slice-8 phase: config 4 run as a user runs it
   (`_cfg8`): one `Simulation` with an output directory (history and
   restart every 300 s, auxhist every 600 s, all netCDF through the
   port's g++-built backend, which must build), the NaN check, an emission
   stream of two files (0 s and 300 s) feeding the emission stage, four
   tslist points, phase timing and a `guard` every 10 steps: one 100-step
   window from step 0 with config 4's exact launches (300 / 400 / 40 /
   10), each write timed between two device synchronisations with its
   file's bytes, then `write_tslist` and `flush`; a run restarted from the
   step-50 file equal to the unbroken one bit for bit in every restart
   field after 50 more steps; one history file read by scipy's netCDF
   reader equal to the state; `guard` locating a NaN put into a copy of
   theta;
10. config-4 cross-check: 3 steps of a small config 4 from noon UTC (both
   alarms every step) on the card against the CPU;
11. slice-6 phase: bench.py's --config4-8bin
   (config 4 with cbmz_mosaic_8bin) with emissions (seeded surface fluxes
   and fire sources lifted by plume rise), the cloud-borne phase with
   aqueous chemistry and wet scavenging: 219 advected scalars, 2 warm-up
   steps, one 100-step window with exact launches (300 / 400 / 80 / 10),
   finite fields and no negative chem field; on one chem call the emitted
   burden against the fluxes, cw_exchange's conservation and cloud-borne
   number in cloudy updrafts, and rain lowering the scavenged fields; the
   synchronised phase times, profiles of a chem call and a main step, the
   Mie kernel on the 8 bins' own inputs and the ROS2 kernel on its own;
12. slice-6 cross-check: 3 steps at 16x8x20 from noon on the card against
   the CPU;
13. slice-7 phase: config 4 with WRF-Chem's usual
   transport and boundary layer (`_cfg7`: moist and chem scalars under the
   monotonic limiter, the 6th-order filter, 2D Smagorinsky with kvdif = 0,
   YSU over the revised MM5 surface layer and the Noah land surface): 2
   warm-up steps, one 100-step window with exact launches (300 / 200 / 40 /
   10: the final stage's monotonic update is a plain batched pass, not the
   multi-tracer kernel), finite fields, no negative chem or moist field,
   the PBL height inside the domain and the soil state in its bounds; the
   synchronised phase times, a profile of one main step, and the scalar
   advection and multi-tracer kernels bitwise on one main step's calls;
14. slice-7 cross-checks, card against CPU, 3 steps each from noon: the
   slice-7 configuration at 16x8x20; the LES case with the TKE closure and
   WENO5; SPPT and SKEBS; MYNN over the slab surface; BMJ, KF and Grell with
   WSM6 at dx = 10 km; the simple radiation;
15. slice-9 phase, slice 9's main path: config 4's physics and
   chemistry on a real-data domain (`_cfg9`): real_init of the synthetic
   analysis at 0, 3,600 and 7,200 s on a Lambert grid at 40N over a
   1,000 m ridge, 100x100x50 at dx 12 km and dt 60 s from noon UTC,
   specified lateral boundaries from the two segments, bench.py's seed; 2
   warm-up steps, then one 100-step window (6,000 s, 10 chem and 10 rad
   calls) across the segment swap at 3,600 s, with exact launches (300 /
   400 / 40 / 10), finite fields, no negative moist or chem field, |w|
   bounded and each spec ring equal to the segment's target; the setup's
   host seconds, the synchronised phase times, a profile of one main step,
   and the scalar advection and multi-tracer kernels with m2 bitwise on one
   main step's calls;
16. item-9 cross-checks, card against CPU at small sizes: a real case with
   analysis nudging, hill2d_x, a lat-lon grid with the polar filter, a
   one-way and a two-way 3:1 nest (with a move), ndown from two history
   files written on the card;
17. wide phase: config 3 at 1000x100x50 (100,000 columns, rows in x tiles
   of the multi-tracer kernel): that kernel timed at 47 scalars on the
   grid, 3 steps with one rad and one chem call and exact launches, and
   the rad call's peak memory;
18. the multi-tracer kernel at block seams: a 2x2 set of 50x50 blocks with
   true-image halos cut out of config-4-like inputs (107 scalars, 50
   levels), with the limiter, flat and with m2, on every boundary kind on
   the outer sides, each block through the seam grids and bitwise against
   the plain version on the whole domain; one block's seam grids timed
   beside the flat kernel at the same shape;
19. slice-10 phase, slice 10's main path: config 4 (`_cfg4`, 100x100x50)
   on a 2x2 mesh, four ranks spawned on the card over gloo (the kernels
   built in this process first), 2 warm-up steps and a 20-step window (two
   chem calls), gathered on rank 0 and held to one block's run of the same
   22 steps on the card within tests/test_parallel.py's full-step
   tolerances; per rank the launches of each kernel per main step and per
   chem call (equal to one block's), the exchanges and bytes per main step
   and ms/step (four ranks share one card, strips through the host: not a
   scaling number); then on every rank, on its own inputs at its block's
   shapes, every scalar-advection and multi-tracer call of one main step
   bitwise against the plain versions (the limited calls through the
   wrapper's seam grids and r_hi's ring exchange) and one chem call's Mie
   and ROS2 calls (125,000 cells) within their limits; with two cards or
   more, also the dycore on a 1x2 mesh
   over NCCL against one card, else a line that says why it did not run;
20. slice-11 phase, this slice's main path: config 4 nested (`_cfg4` at
   100x100x50, a two-way 3:1 child of 90x90x50 at dt 2 s over parent cells
   35-64 in x and y, across both seams) through `NestedSimulation(...,
   mesh=...)` on a 2x2 mesh, four ranks spawned on the card over gloo, 2
   warm-up parent steps and a 10-step window (30 child steps, one chem
   call on each domain), both domains gathered on rank 0 and held to the
   one-block nest's run of the same steps on the card, every field (each
   difference printed; tests/test_parallel.py's full-step tolerances
   fail it); per rank and domain the launches of each kernel per parent
   step and per chem call (equal to one block's), the halo's exchanges and
   bytes and the nest's all-gathers and their bytes per parent step, and
   ms per parent step beside the one-block nest's; then on every rank, on
   the child's 45x45 block, `on_path10`'s checks (one child step's
   scalar-advection and multi-tracer calls bitwise, one child chem call's
   Mie bins and ROS2 call at 101,250 cells);
21. item 12: the reference's slow-marked tests/test_squall_line.py on the
   card with its assertions (30 min of the 2D squall line at 60x4x24 with
   its water budget within 5e-3, 600 s of the quarter_ss supercell);
22. item 11: the banded-matmul fluxes (`ops/mxu_adv.py`, full float32
   library products) against the stencil fluxes within 1e-6 relative;
23. slice-12 phase, this slice's main path (`config5_block_phase`, in a
   process of its own with the allocator's expandable segments): one
   card's block of BASELINE config 5 (1000x1000x60 on a 2x2 mesh of
   cards), config 4's package at 500x500x60 with 107 scalars from noon
   UTC through `Simulation`: the case's build time, 2 warm-up steps and a
   20-step window (chem calls at steps 10 and 20, each in two blocks of
   rows) with the exact launches, the window's peak memory and config 4's
   physical checks and the caching allocator's counters over it; one
   synchronised call of each executable with its peak memory above what it
   finds; profiles of one main step and one
   chem call (device time by kernel, busy share); the four kernels on the
   path's own inputs as the calls are made (the scalar advection and the
   multi-tracer kernel bitwise, the latter's plain version over slices of
   8 tracers; the Mie kernel within 3.2e-4; the ROS2 kernel bitwise, its
   plain version in passes of 2^20 cells), each timed alone beside its
   bound (the multi-tracer kernel's grids in x tiles of 8 x 100 cells);
   the chem and rad calls on an interior 100x100 window equal to
   the block's on those columns bit for bit; a restart of the block
   written, read into a fresh `Simulation` and one step taken in each,
   bitwise in every field, with the file's size and both times.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``; the kernels' ``launches`` are the window
of config 5's block (slice 12), the earlier paths' beside them.  Without a CUDA
device it exits with code 1 and prints no result.  It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
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


def _cfg9(nx=100, ny=100, nz=50, chem_s=600.0, rad_s=600.0,
          start_date="2000-06-20_12:00:00"):
    """Slice 9's path: config 4's physics and chemistry (`_cfg4`) on a
    real-data domain: dx = dy = 12 km, dt = 60 s, ztop 16 km, p_top 100 hPa,
    kvdif 0, specified lateral boundaries on both axes (spec zone 1, relax
    zone 4), chem and rad every 600 s, from noon UTC; 6 acoustic substeps
    a step and off-centering epssm 0.3.  With the defaults (4 and 0.1) the
    case goes non-finite within 102 steps in both packages: at the model
    top near the boundaries by step ~50 with 4 substeps, in the north
    relax zone at mid levels from step ~80 with epssm 0.1 (PERF.md §6)."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    cfg = _cfg4(nx, ny, nz, chem_s, rad_s, start_date)
    return cfg.replace(
        domain=dataclasses.replace(cfg.domain, dx=12e3, dy=12e3, ztop=16000.0, p_top=10000.0),
        time_control=dataclasses.replace(cfg.time_control, dt=60.0),
        dynamics=dataclasses.replace(cfg.dynamics, kvdif=0.0, bc_x=BCKind.SPECIFIED,
                                     bc_y=BCKind.SPECIFIED, spec_zone=1, relax_zone=4,
                                     time_step_sound=6, epssm=0.3))


# slice 9's Lambert projection, and its analyses' times [s] (two segments)
LAMBERT9 = {"kind": "lambert", "ref_lat": 40.0}
SNAPS9 = (0.0, 3600.0, 7200.0)


def _real_case(cfg, dev, times=SNAPS9, terrain_amp=1000.0, projection=None):
    """real_init on the synthetic analysis at `times` over a ridge of
    `terrain_amp`, on slice 9's Lambert projection by default: (grid,
    state, segments)."""
    from wrfchem_arc_interactions_tpu_torch.grid.projection import Projection
    from wrfchem_arc_interactions_tpu_torch.models import real
    snaps = real.synthetic_analysis(cfg, times, terrain_amp=terrain_amp)
    return real.real_init(cfg, snaps, device=dev,
                          projection=Projection(**(projection or LAMBERT9)))


def _projected9(grid):
    """`grid` with slice 9's map factors (the Lambert projection at 40N, dx
    12 km) on its (ny, nx): the kernel phase's map factor at slice 9's
    shapes."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.grid.projection import (
        Projection, projection_fields,
    )
    pf = projection_fields(Projection(**LAMBERT9), grid.ny, grid.nx, 12e3, 12e3)
    return dataclasses.replace(grid, msft=torch.from_numpy(pf["msft"]).to(grid.device),
                               curvature=True)


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


def _adv_bound(nz, ny, nx, msf=False):
    """advect_scalar_5_3: each input read once, the output written once;
    ops per face: flux5 20, flux3 16 (with the two sign flips); per cell 9
    for the divergence; with the map factor its (ny, nx) plane read once
    and one multiply a cell."""
    nbytes = 4 * (3 * nz * (ny + 6) * (nx + 6) + (nz + 1) * ny * nx + nz
                  + nz * ny * nx + (ny * nx if msf else 0))
    ops = (20 * (nz * ny * (nx + 1) + nz * (ny + 1) * nx)
           + 16 * (nz - 1) * ny * nx + (10 if msf else 9) * nz * ny * nx)
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
# antidiffusive fluxes (3), the limited fluxes (9) and the clip (1).  The
# map factor adds a multiply to each divergence and factor: 1 without the
# limiter, 4 with it (the final divergence, phi_td's, and two factors)
TRACER_OPS = {False: 70, True: 160}
TRACER_MSF_OPS = {False: 1, True: 4}


def _tracers_bound(nt, nz, ny, nx, pd, msf=False):
    """advect_tracers: q (padded), phi_old, pt, ru, rv (padded), ww,
    mu_full, mu_new, rdnw (and m2 on a projected grid) read once, q_new
    written once."""
    cells = nz * ny * nx
    padded = nz * (ny + 6) * (nx + 6)
    nbytes = 4 * (nt * padded + 3 * nt * cells + 2 * padded + (nz + 1) * ny * nx
                  + (3 if msf else 2) * ny * nx + nz)
    ops = (TRACER_OPS[pd] + (TRACER_MSF_OPS[pd] if msf else 0)) * nt * cells
    return _bound(nbytes, ops)


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


def kernel_adv(dev, rdnw, rdx, rdy, nz, ny, nx, m2=None):
    """The scalar advection kernel against its plain version and timed, on a
    flat grid or with the map factor `m2` (ny, nx): its entry."""
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel
    rng = np.random.default_rng(0)
    label = "flat" if m2 is None else "with m2"

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    q = put(300.0 + rng.normal(size=(nz, ny + 6, nx + 6)))
    ru = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    rv = put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6)))
    ww = rng.normal(size=(nz + 1, ny, nx)) * 1e3
    ww[0] = 0.0
    ww[-1] = 0.0
    ww = put(ww)
    args = (q, ru, rv, ww, rdnw, rdx, rdy, m2)
    out = adv_kernel.advect_scalar_5_3(*args)
    ref = adv_kernel.advect_scalar_5_3_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("advect_scalar_5_3: non-finite output")
    max_abs = float((out - ref).abs().max())
    rel = max_abs / float(ref.abs().max())
    equal = bool(torch.equal(out, ref))
    print(f"advect_scalar_5_3 (kernel) vs plain on the card, {label}: max|d| = "
          f"{max_abs:.6g}, max|d|/max|ref| = {rel:.3g} (limit 1e-5), bitwise equal "
          f"{equal}; {_flags('advect_scalar_5_3')}; grid {_adv_plan(nz, ny, nx)}")
    if not rel <= 1e-5:
        raise RuntimeError(f"advect_scalar_5_3 disagrees with its plain version: {rel}")
    if m2 is not None and not equal:
        raise RuntimeError("advect_scalar_5_3 with m2 is not bitwise its plain version")
    ms = _device_ms(lambda: adv_kernel.advect_scalar_5_3(*args), calls=20)
    plain_ms = _device_ms(lambda: adv_kernel.advect_scalar_5_3_reference(*args), calls=4)
    wall_ms = _wall_ms(lambda: adv_kernel.advect_scalar_5_3(*args), reps=50)
    plain_wall_ms = _wall_ms(lambda: adv_kernel.advect_scalar_5_3_reference(*args))
    bound = _adv_bound(nz, ny, nx, msf=m2 is not None)
    print(f"advect_scalar_5_3 {label} at ({nz}, {ny + 6}, {nx + 6}), device time per call: "
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


def _mie_check(mie_kernel, label, nr_n, u, t, out=None):
    """The kernel's output (`out`, else a call of it) against its plain
    version on the same inputs: the errors."""
    if out is None:
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


class _Checked:
    """Check each call of functions of a module as it is made, on its own
    inputs and result (no copies kept): `checks` maps a name to
    check(args, kwargs, result), run after the real call.  The originals
    come back after the block."""

    def __init__(self, module, checks):
        self.module, self.checks = module, checks
        self.inner = {n: getattr(module, n) for n in checks}

    def __enter__(self):
        for n, check in self.checks.items():
            def call(*args, _n=n, _check=check, **kw):
                out = self.inner[_n](*args, **kw)
                _check(args, kw, out)
                return out
            setattr(self.module, n, call)
        return self

    def __exit__(self, *exc):
        for n in self.checks:
            setattr(self.module, n, self.inner[n])
        return False


def _recorder(calls):
    """A `_Checked` check that appends each call's (args, kwargs, result) to
    `calls`; dicts copied, as the caller may go on to assign into a dict it
    got or gave."""
    def record(args, kw, out):
        calls.append((tuple(dict(a) if isinstance(a, dict) else a for a in args), kw,
                      dict(out) if isinstance(out, dict) else out))
    return record


# calls of each dycore kernel compared on each path's own inputs, by path
ON_PATH = {"advect_scalar_5_3": {}, "advect_tracers": {}}


def dycore_on_path(step, label, card=None, tracer_slice=None):
    """The scalar advection kernel and the multi-tracer kernel against their
    plain versions, bitwise, on each of their calls in one main step of a
    path (`step` runs the step), as the calls are made (`_Checked`); the
    multi-tracer kernel's calls are those of the path's stages, with and
    without the limiter, at its own scalar count.  Where `tracer_slice` is
    given, the multi-tracer kernel's plain version runs over slices of that
    many tracers (each tracer's update is its own; at config 5's block a
    plain pass over all 107 would not fit beside the step).  With `card`,
    the first call of each kernel, and of the multi-tracer kernel with the
    limiter, is timed alone on its inputs beside its bound.  Records the
    number of calls compared in `ON_PATH`; returns {"calls": {kernel:
    calls}, and with `card` the times by kernel or limiter mode}."""
    from wrfchem_arc_interactions_tpu_torch.dycore import solve
    from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, tracers_kernel
    seen = {"advect_scalar_5_3": 0, "advect_tracers": 0}
    shapes = {name: set() for name in seen}
    timed = {}

    def adv(args, kw, out):
        ref = adv_kernel.advect_scalar_5_3_reference(*args, **kw)
        if not torch.equal(out, ref):
            raise RuntimeError(f"advect_scalar_5_3 on {label}'s inputs {tuple(args[0].shape)}: "
                               f"max|d| {float((out - ref).abs().max())}, not bitwise equal")
        del ref
        seen["advect_scalar_5_3"] += 1
        shapes["advect_scalar_5_3"].add((tuple(args[0].shape), None))
        if card is not None and "advect_scalar_5_3" not in timed:
            nz, ny, nx = out.shape
            ms = _device_ms(lambda: adv_kernel.advect_scalar_5_3(*args, **kw), calls=10,
                            trials=20)
            timed["advect_scalar_5_3"] = {"shape": [nz, ny, nx], "ms": ms,
                                          "bound_ms": _adv_bound(nz, ny, nx)[0]}

    def tracers(args, kw, out):
        q_pad, phi_old, pt = args[0], args[1], kw.get("pt")
        nt = q_pad.shape[0]
        per = tracer_slice or nt
        for a in range(0, nt, per):
            b = min(nt, a + per)
            ref = tracers_kernel.advect_tracers_reference(
                q_pad[a:b], phi_old[a:b], *args[2:],
                **dict(kw, pt=None if pt is None else pt[a:b]))
            if not torch.equal(out[a:b], ref):
                raise RuntimeError(f"advect_tracers on {label}'s inputs {tuple(q_pad.shape)}, "
                                   f"tracers {a}..{b - 1}, pd={kw.get('pd')}: max|d| "
                                   f"{float((out[a:b] - ref).abs().max())}, not bitwise equal")
            del ref
        seen["advect_tracers"] += 1
        shapes["advect_tracers"].add((tuple(q_pad.shape), kw.get("pd")))
        mode = "pd_clip" if kw.get("pd") else "no_limiter"
        if card is not None and mode not in timed:
            nz, ny, nx = out.shape[1:]
            ms = _device_ms(lambda: tracers_kernel.advect_tracers(*args, **kw), calls=2,
                            trials=5, warmup=1)
            msf = args[7].has_msf
            bound = _tracers_bound(nt, nz, ny, nx, bool(kw.get("pd")), msf)
            timed[mode] = {"shape": [nt, nz, ny, nx], "ms": ms, "bound_ms": bound[0],
                           "bound_by": bound[1],
                           "plan": _tracers_plan(nt, nz, ny, nx, bool(kw.get("pd")), msf)}

    with _Checked(solve, {"advect_scalar_5_3": adv, "advect_tracers": tracers}):
        step()
        torch.cuda.synchronize()
    if not seen["advect_scalar_5_3"]:
        raise RuntimeError(f"advect_scalar_5_3: no call in one step of {label}")
    for name, n in seen.items():
        ON_PATH[name][label] = n
        if n:
            sliced = (f"; the plain version in slices of {tracer_slice} tracers"
                      if tracer_slice and name == "advect_tracers" else "")
            print(f"{name} (kernel) vs plain on the card, {label}'s own inputs: {n} calls of "
                  f"one main step (inputs, limiter: {sorted(shapes[name], key=str)}), max|d| "
                  f"= 0 (bitwise equal{sliced})")
    for mode, m in timed.items():
        plan = f"; plan: {_plan_str(m['plan'])}" if "plan" in m else ""
        print(f"{'advect_scalar_5_3' if mode == 'advect_scalar_5_3' else 'advect_tracers'} "
              f"at {tuple(m['shape'])}{'' if mode == 'advect_scalar_5_3' else ', ' + mode} on "
              f"{label}'s own inputs, alone: {m['ms']:.4f} ms per call, bound "
              f"{m['bound_ms']:.4f} ms ({m.get('bound_by', 'bytes')}, "
              f"{100.0 * m['bound_ms'] / m['ms']:.1f}% of it){plan} [{card}]")
    torch.cuda.empty_cache()
    return {"calls": dict(seen), **timed}


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


def chem_on_path(chem_call, label, card=None, ros2_chunk=None):
    """The Mie kernel and the ROS2 kernel against their plain versions on
    each of their calls in one chem call of a path (`chem_call` makes it),
    as the calls are made (`_Checked`): the Mie kernel within 3.2e-4 per
    bin, the ROS2 kernel bitwise and within `_ros2_compare`'s limits, its
    plain version and vectorised form in passes of `ros2_chunk` cells where
    given.  Per Mie call the distinct floor cells per warp (what decides
    whether the table loads are broadcasts).  With `card`, each call is
    timed alone on its inputs beside its bound.  Returns {"mie_bins": [per
    call], "ros2": [per call]}."""
    from wrfchem_arc_interactions_tpu_torch.chem import gas, optics
    from wrfchem_arc_interactions_tpu_torch.ops import mie_kernel, ros2_kernel
    bins, ros2 = [], []

    def mie(args, kw, out):
        nr_n, u, t = args
        c = cells_per_warp(nr_n, u).float()
        errs = _mie_check(mie_kernel, f"{label} Mie call {len(bins) + 1}", nr_n, u, t, out=out)
        m = {"elements": t.numel(), "max_abs_err": max(errs),
             "cells_per_warp_mean": float(c.mean()), "cells_per_warp_max": int(c.max()),
             "warps_in_one_cell": float((c == 1).float().mean())}
        if card is not None:
            m["ms"] = _device_ms(lambda: mie_kernel.cheb_eval(nr_n, u, t), calls=2, trials=5,
                                 warmup=1)
            m["bound_ms"] = _mie_bound(t.numel())[0]
            print(f"mie_cheb_eval on {label}'s own inputs, call {len(bins) + 1} "
                  f"({t.numel()} elements): {_cpw(nr_n, u)}, at most {int(c.max())}; alone "
                  f"{m['ms']:.4f} ms per call, bound {m['bound_ms']:.4f} ms (operations, "
                  f"{100.0 * m['bound_ms'] / m['ms']:.1f}% of it) [{card}]")
        bins.append(m)

    def integrate(args, kw, out):
        conc, k, dt_total = args[:3]
        n_sub = args[3] if len(args) > 3 else kw.get("n_sub")
        if n_sub is None:
            n_sub = max(1, int(np.ceil(dt_total / gas.SUBSTEP_TARGET_S)))
        kin = gas._kinetics()
        err, max_abs, equal, err_vec = _ros2_compare(kin, ros2_kernel, conc, k, dt_total,
                                                     n_sub, out=out, chunk=ros2_chunk)
        if not equal:
            raise RuntimeError(f"ros2_integrate on {label}'s inputs: max|d| {max_abs}, not "
                               "bitwise equal")
        r = {"cells": int(conc.shape[1]), "n_sub": n_sub, "max_abs_err": max_abs,
             "max_rel_err": err, "bitwise": equal, "max_rel_err_vectorised": err_vec}
        if card is not None:
            ncell = conc.shape[1]
            r["ms"] = _device_ms(lambda: ros2_kernel.ros2_integrate(kin, conc, k, dt_total,
                                                                    n_sub),
                                 calls=1, trials=5, warmup=1)
            flops = ros2_kernel.flops_per_substep(kin)
            r["bound_ms"], r["bound_by"] = _bound(4 * (2 * kin.ns + kin.nr) * ncell,
                                                  n_sub * flops * ncell)
            print(f"ros2_integrate on {label}'s own inputs at {ncell} cells, n_sub {n_sub}, "
                  f"alone: {r['ms']:.4f} ms per call, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {100.0 * r['bound_ms'] / r['ms']:.1f}% of it) [{card}]")
        ros2.append(r)

    with _Checked(optics, {"cheb_eval": mie}), _Checked(gas, {"integrate": integrate}):
        chem_call()
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"mie_bins": bins, "ros2": ros2}


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


def _tracers_plan(nt, nz, ny, nx, pd, msf=False, seam=False) -> list:
    """The multi-tracer kernel's plan of each grid of a call (`tracers_kernel.
    plan`: tile, slots a thread, blocks, shared memory, blocks an SM by the
    runtime's occupancy query, registers and local (spill) bytes a thread
    from cudaFuncGetAttributes)."""
    from wrfchem_arc_interactions_tpu_torch.ops import build, tracers_kernel
    return tracers_kernel.plan(build.load("advect_tracers"), pd, nt, nz, ny, nx, msf=msf,
                               seam=seam)


def _plan_str(plans) -> str:
    return "; ".join(
        f"{p['grid']}: {'x tiles' if p['x_tiles'] else 'one tile over the row'} of "
        f"{p['tile_rows']} x {p['tile_cells']} cells ({p['tiles_y']} x {p['tiles_x']} a "
        f"tracer), {p['slots_per_thread']} slots a thread, {p['blocks']} blocks, "
        f"{p['smem_bytes']} B shared, {p['resident']} blocks an SM, {p['registers']} "
        f"registers, {p['local_bytes']} B local (spills)" for p in plans)


def _without_plans(x):
    """`x` without the multi-tracer kernel's launch plans: the kernels line
    holds what this run measured and the bounds; each plan is printed
    beside its time."""
    if isinstance(x, dict):
        return {k: _without_plans(v) for k, v in x.items() if k != "plan"}
    if isinstance(x, list):
        return [_without_plans(v) for v in x]
    return x


def kernel_tracers(dev, grid, nt):
    """One stage update of `nt` scalars at full width (config 3 advects 47,
    config 4 107, slice 6 219), without the limiter (stages 0-1) and with PD
    limiter and clip (stage 2): {mode: numbers}."""
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    args, pt, qmax = tracer_inputs(dev, grid, nt)
    msf = grid.has_msf
    label = "with m2" if msf else "flat"
    modes = {}
    for pd in (False, True):
        kw = dict(pt=pt, pd=pd, clip=pd)
        out = tracers_kernel.advect_tracers(*args, **kw)
        ref = tracers_kernel.advect_tracers_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError("advect_tracers: non-finite output")
        max_abs = float((out - ref).abs().max())
        equal = bool(torch.equal(out, ref))
        print(f"advect_tracers (kernel) vs plain on the card, {label}, nt={nt}, pd={pd}: "
              f"max|d| = {max_abs:.6g}, max|d|/max|q| = {max_abs / qmax:.3g} "
              f"(limit 1e-5; built with --fmad=false), bitwise equal {equal}")
        if not max_abs / qmax <= 1e-5:
            raise RuntimeError(f"advect_tracers disagrees with its plain version: {max_abs}")
        if msf and not equal:
            raise RuntimeError("advect_tracers with m2 is not bitwise its plain version")
        del out, ref
        ms = _device_ms(lambda: tracers_kernel.advect_tracers(*args, **kw),
                        calls=10, trials=20)
        plain_ms = _device_ms(lambda: tracers_kernel.advect_tracers_reference(*args, **kw),
                              calls=1, trials=5, warmup=1)
        wall_ms = _wall_ms(lambda: tracers_kernel.advect_tracers(*args, **kw))
        bound = _tracers_bound(nt, nz, ny, nx, pd, msf)
        plans = _tracers_plan(nt, nz, ny, nx, pd, msf)
        print(f"advect_tracers {label} at ({nt}, {nz}, {ny}, {nx}), pd={pd}, device time per "
              f"call: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}, {100.0 * bound[0] / ms:.1f}% of it); host wall per "
              f"synchronised call: kernel {wall_ms:.4f} ms; plan: {_plan_str(plans)}")
        modes["pd_clip" if pd else "no_limiter"] = {
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "plan": plans}
    return modes


def tracers_entry(modes, others):
    """The multi-tracer kernel's entry.  A main path calls it twice without
    the limiter and once with it per step: the entry carries the mean per
    call over that mix at the main path's (slice 9's) 107 scalars with the
    map factor (its "launches" count grids: one per call without the
    limiter, two with it); `modes` holds both settings there, and `others`
    ({key: modes}) those of the other paths' shapes."""
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


def _ros2_compare(kin, ros2_kernel, conc, k, dt_total, n_sub, out=None, chunk=None):
    """The kernel's output (`out`, else a call of it), its plain version and
    the vectorised form on the same inputs, the last two in passes of
    `chunk` cells where given (each cell's integration is its own):
    (max |a-b| / (|b| + 1e3) vs plain, max |a-b| vs plain, bitwise equal,
    max |a-b| / (|b| + 1e3) vs vectorised).  Raises past the limits."""
    if out is None:
        out = ros2_kernel.ros2_integrate(kin, conc, k, dt_total, n_sub)
    torch.cuda.synchronize()
    if out.shape != conc.shape or not (torch.isfinite(out).all() and (out >= 0).all()):
        raise RuntimeError("ros2_integrate: wrong shape, non-finite or negative output")
    ncell = conc.shape[1]
    err = max_abs = err_vec = 0.0
    equal = True
    for lo in range(0, ncell, chunk or ncell):
        hi = min(ncell, lo + (chunk or ncell))
        c, kk, o = conc[:, lo:hi].contiguous(), k[:, lo:hi].contiguous(), out[:, lo:hi]
        ref = ros2_kernel.integrate_reference(kin, c, kk, dt_total, n_sub)
        vec = c
        for _ in range(n_sub):
            vec = kin.step_ros2(vec, kk, dt_total / n_sub)
        max_abs = max(max_abs, float((o - ref).abs().max()))
        err = max(err, float(((o - ref).abs() / (ref.abs() + 1e3)).max()))
        err_vec = max(err_vec, float(((o - vec).abs() / (vec.abs() + 1e3)).max()))
        equal = equal and bool(torch.equal(o, ref))
        del ref, vec
    passes = f" (in passes of {chunk} cells)" if chunk and chunk < ncell else ""
    print(f"ros2_integrate (kernel) vs plain on the card at {ncell} cells{passes}, n_sub "
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
# last tile) and its slots (rows narrower and wider than a warp); and rows
# wider than one tile spans, which it splits into x tiles (held bitwise)
TRACER_SHAPES = ((1, 1, 13), (2, 5, 33), (3, 9, 13), (5, 17, 33), (50, 9, 13), (2, 4, 300),
                 (2, 4, 1000), (5, 17, 1000))
WIDE_ROW = 1000


def tracer_boundary_cases():
    """(nz, ny, nx, bc_x, bc_y) over `TRACER_SHAPES` and the four lateral
    boundary kinds.  A boundary's halo of 3 needs 3 rows (periodic) or 4
    (symmetric); a single row is open in y and takes each kind in x."""
    cases = []
    for nz, ny, nx in TRACER_SHAPES:
        for bc in ("open", "symmetric", "periodic", "specified"):
            need = {"open": 1, "specified": 1, "periodic": 3, "symmetric": 4}[bc]
            cases.append((nz, ny, nx, bc, bc if ny >= need else "open"))
    return cases


def _tracers_boundaries(dev, grid, nt=3):
    """The kernel against its plain version at `tracer_boundary_cases`, with
    and without the limiter, flat and with a map factor (of 0.95-1.05, in
    every cell another): the limiter reads neighbour factors through each
    boundary's index map, and the factors' outflows and the divergences
    read the map factor of the right cell."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    gen = torch.Generator(device="cpu").manual_seed(3)
    worst, bitwise = 0.0, 0
    cases = tracer_boundary_cases()
    for (nz, ny, nx, bc_x, bc_y), msf in ((c, m) for c in cases for m in (False, True)):
        g = dataclasses.replace(grid, rdnw=grid.rdnw[:nz].contiguous())
        if msf:
            g = dataclasses.replace(
                g, msft=(0.95 + 0.1 * torch.rand((ny, nx), generator=gen)).to(dev),
                curvature=True)
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
            if not err <= 1e-5 or ((nx >= WIDE_ROW or msf) and not torch.equal(out, ref)):
                raise RuntimeError(f"advect_tracers at (nt, nz, ny, nx) = {(nt, nz, ny, nx)}, "
                                   f"x {bc_x}, y {bc_y}, limiter {pd}, map factor {msf} "
                                   f"disagrees with its plain version: {err}")
            bitwise += int(torch.equal(out, ref))
    print(f"advect_tracers (kernel) vs plain with and without the limiter at {len(cases)} "
          f"shapes and boundary kinds (nz 1-50, ny 1-17, nx 13, 33, 300 and {WIDE_ROW}, the "
          f"last in x tiles; open, symmetric, periodic, specified), flat and with a map "
          f"factor: max|d|/max|q| = {worst:.3g} (limit 1e-5; rows of {WIDE_ROW} and every "
          f"call with a map factor bitwise), {bitwise} of {4 * len(cases)} calls bitwise "
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


def _arc_checks(s, label, n_steps):
    """Config 4's physical checks on a state after `n_steps`: finite fields,
    no negative chem field, O3 within 0.02-0.06 ppmv of its 0.04 seed,
    0 < max w < 60 m/s, droplet number in at least 90% of the cells with
    cloud water, tau_aer_sw > 0 where the bins are seeded and OLR in
    100-400 W m-2.  Returns (max w, O3 range, OLR range, cloudy cells,
    those with droplets)."""
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{label}: non-finite {k} after {n_steps} steps")
    neg = [k for k, v in s.items() if k.startswith("chem_") and float(v.min()) < 0.0]
    if neg:
        raise RuntimeError(f"{label}: negative chem fields {neg}")
    o3 = (float(s["chem_o3"].min()), float(s["chem_o3"].max()))
    if not (0.02 <= o3[0] and o3[1] <= 0.06):
        raise RuntimeError(f"{label}: O3 {o3} ppmv outside 0.02-0.06 (seed 0.04)")
    w_max = float(s["w"].max())
    if not 0.0 < w_max < 60.0:
        raise RuntimeError(f"{label}: max w = {w_max} m/s outside (0, 60)")
    cloudy = s["qc"] > 1e-6
    n_cloudy = int(cloudy.sum())
    with_nc = int((s["nc"][cloudy] > 0.0).sum())
    # at a cloud's evaporating or raining-out edge the scheme can leave a
    # little water with its droplet number clipped to 0 (a few percent of
    # the cloudy cells); the bulk of the cloud must carry droplets
    if n_cloudy and with_nc < 0.9 * n_cloudy:
        raise RuntimeError(f"{label}: droplet number in only {with_nc} of {n_cloudy} "
                           "cells with cloud water")
    if not float(s["tau_aer_sw"].min()) > 0.0:
        raise RuntimeError(f"{label}: tau_aer_sw is not positive where the bins are seeded")
    olr = (float(s["olr"].min()), float(s["olr"].max()))
    if not (100.0 <= olr[0] and olr[1] <= 400.0):
        raise RuntimeError(f"{label}: OLR {olr} outside 100-400 W m-2")
    return w_max, o3, olr, n_cloudy, with_nc


def slice4_phase(dev, card, steps=RAD_CHEM_EVERY):
    """BASELINE config 4 through `Simulation`: one 100-step window with 10
    chem calls and 1 rad call, the physical checks, the exact launch counts
    of all four kernels, the synchronised phase times and a profile of one
    chem call.  Returns (launches, the Mie kernel's numbers on the path's
    inputs, ms/step of the window)."""
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
    w_max, o3, olr, n_cloudy, with_nc = _arc_checks(s, "config 4", steps + 2)
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
    mie_path = chem_on_path(lambda: chem(sim.state, sim.grid, t_now), "config 4",
                            card)["mie_bins"]
    sim.sync()
    dev2_ms, n2, rows2 = _profile(lambda: sim.advance(1))     # step 107: main only
    print(f"profile of one config-4 main step: device busy {dev2_ms:.3f} ms in {n2} "
          f"kernels; against the unprofiled {ms_step:.3f} ms/step the device is busy "
          f"{100.0 * (dev2_ms + dev_ms / sim.chem_every) / ms_step:.1f}% (main step + a "
          f"tenth of a chem call); advect_tracers grids: {_tracer_grids_us(rows2)}")
    for t_us, count, key in rows2[:6]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    dycore_on_path(lambda: sim.advance(1), "config 4")
    return launches, mie_path, ms_step


# the tslist points of slice 8's run: (label, j, i) on the 100x100 grid
TS_POINTS8 = (("sw", 10, 10), ("center", 50, 50), ("line", 50, 25), ("ne", 90, 90))
HISTORY_S, RESTART_S, AUXHIST_S = 300.0, 300.0, 600.0


def _cfg8(nx=100, ny=100, nz=50):
    """Slice 8's path: config 4 exactly as `_cfg4` builds it, with the
    emission stage on (fed by the stream), history and restart every 300 s,
    auxhist every 600 s and four tslist points."""
    import dataclasses
    cfg = _cfg4(nx, ny, nz)
    return cfg.replace(
        time_control=dataclasses.replace(
            cfg.time_control, history_interval_s=HISTORY_S, restart_interval_s=RESTART_S,
            auxhist_interval_s=AUXHIST_S, ts_points=TS_POINTS8),
        chem=dataclasses.replace(cfg.chem, emiss_opt=True))


class _TimedWrites:
    """Time each call of the output writers while a block runs: a device
    synchronisation before the call (so that the queued steps are not
    counted) and one after it.  {kind: [(path, seconds)]}."""

    def __init__(self):
        from wrfchem_arc_interactions_tpu_torch.io import diags, history
        self.targets = {"history": (history, "write_history"),
                        "restart": (history, "write_restart"),
                        "auxhist": (diags, "write_diags")}
        self.calls = {k: [] for k in self.targets}
        self.inner = {k: getattr(m, n) for k, (m, n) in self.targets.items()}

    def __enter__(self):
        for kind, (module, name) in self.targets.items():
            def timed(path, *args, _kind=kind, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                self.inner[_kind](path, *args, **kw)
                torch.cuda.synchronize()
                self.calls[_kind].append((path, time.perf_counter() - t0))
            setattr(module, name, timed)
        return self.calls

    def __exit__(self, *exc):
        for kind, (module, name) in self.targets.items():
            setattr(module, name, self.inner[kind])
        return False


def _stream8(grid, out_dir):
    """Two emission files, at 0 s and 300 s (`_emissions6`'s fluxes from two
    seeds), written as netCDF and read back as an `EmissionStream`."""
    from wrfchem_arc_interactions_tpu_torch.io import auxinput
    paths = []
    for i, (t_s, seed) in enumerate(((0.0, 8), (300.0, 9))):
        snap = {k: v.cpu().numpy() for k, v in _emissions6(grid, seed=seed).items()}
        paths.append(f"{out_dir}/wrfchemi_d01_{i}.nc")
        auxinput.write_emissions(paths[-1], snap, t_s)
    return auxinput.EmissionStream.from_files(paths)


def _sim8(cfg, grid, state, stream, out_dir=None):
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    return Simulation(cfg, grid, state, output_dir=out_dir, check_nans=True,
                      emissions=stream, device=grid.mub.device)


def slice8_phase(dev, card, ms_step4, steps=RAD_CHEM_EVERY):
    """Slice 8's path: config 4 run as a user runs it (`_cfg8`): one
    `Simulation` with an output directory, the NaN check, an emission
    stream of two files and four tslist points runs one 100-step window
    with phase timing and a `guard` every 10 steps, then writes the tslist
    files and flushes.  Checks: the native netCDF backend built, every file
    is netCDF, the exact launches of config 4's window, a restart from the
    step-50 file equal to the unbroken run bit for bit in every restart
    field after 50 more steps, one history file read by scipy equal to the
    state, and `guard` locating a NaN put into a copy of theta.  The same
    run without the output alarms goes first: its ms/step is the baseline
    of what the writes cost, and its state at step 100 must equal the run
    with output bit for bit.  Returns (launches, numbers)."""
    import os
    import tempfile
    from scipy.io import netcdf_file
    from wrfchem_arc_interactions_tpu_torch.io import history as hio
    from wrfchem_arc_interactions_tpu_torch.io import netcdf as ncio
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.registry.state import restart_names
    from wrfchem_arc_interactions_tpu_torch.utils.checks import guard
    if not ncio.available():
        raise RuntimeError(f"slice 8: the native netCDF backend did not build: "
                           f"{ncio.unavailable_reason()}")
    cfg = _cfg8()
    grid, state0 = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state0 = _seed4(state0)
    guards = {"base": [], "output": []}

    def every_10(key):
        def on_step(sim):
            if sim.step_idx % 10 == 0:
                guard(sim.state, sim.grid, sim.dt, sim.hx, sim.step_idx)
                guards[key].append(sim.step_idx)
        return on_step

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/run"
        stream = _stream8(grid, tmp)
        # the same run without the output alarms: what they cost the window,
        # and a second unbroken run to hold the first to (determinism)
        base = _sim8(cfg, grid, state0, stream)
        t0 = time.perf_counter()
        base.advance(steps, on_step=every_10("base"), phase_timing=True)
        base.sync()
        wall_base = time.perf_counter() - t0
        sim = _sim8(cfg, grid, state0, stream, out)
        _reset_counts()
        with _TimedWrites() as writes:
            t0 = time.perf_counter()
            sim.advance(steps, on_step=every_10("output"), phase_timing=True)
            sim.sync()
            wall = time.perf_counter() - t0
        launches = _counts()
        t0 = time.perf_counter()
        ts_files = sim.write_tslist(f"{out}/ts")
        hio.flush()
        flush_s = time.perf_counter() - t0
        n_chem = steps // sim.chem_every
        want = {"advect_scalar_5_3": 3 * steps,
                "advect_tracers": _tracer_grids_per_step() * steps,
                "mie_cheb_eval": 4 * n_chem, "ros2_integrate": n_chem}
        if launches != want:
            raise RuntimeError(f"slice 8: kernel launches in the {steps}-step window "
                               f"{launches}, expected config 4's {want}")
        files = sorted(f for f in os.listdir(out) if f != "ts")
        expect = sorted(f"{kind}_{n:06d}.nc" for kind, every in (
            ("hist", sim.hist_every), ("restart", sim.rst_every), ("auxdiag", sim.aux_every))
            for n in range(every, steps + 1, every))
        if files != expect:
            raise RuntimeError(f"slice 8: files {files}, expected {expect}")
        sizes = {f: os.path.getsize(f"{out}/{f}") for f in files}
        rows = sim.ts_series
        if any(len(r) != steps for r in rows.values()) or not all(
                np.isfinite(v) for r in rows.values() for row in r for v in row.values()):
            raise RuntimeError(f"slice 8: tslist rows {[len(r) for r in rows.values()]}")
        if any(g != list(range(10, steps + 1, 10)) for g in guards.values()):
            raise RuntimeError(f"slice 8: guard ran at steps {guards}")

        # an independent reader: scipy's netCDF implementation
        f = netcdf_file(f"{out}/hist_{steps:06d}.nc", "r", mmap=False)
        try:
            t_file = np.array(f.variables["t"][:])
            time_s = float(f._attributes["_time_s"])
        finally:
            f.close()
        if not (np.array_equal(t_file, sim.state["t"].cpu().numpy()) and time_s == sim.time_s):
            raise RuntimeError("slice 8: the history file read by scipy differs from the state")

        # restart from the step-50 file; 50 more steps equal the unbroken run
        half = steps // 2
        if half % sim.rst_every:
            raise RuntimeError(f"slice 8: no restart file at step {half}")
        restored, step, t_s = hio.read_restart(f"{out}/restart_{half:06d}.nc", cfg, state0)
        if (step, t_s) != (half, half * cfg.time_control.dt):
            raise RuntimeError(f"slice 8: restart file at step {step}, time {t_s}")
        again = _sim8(cfg, grid, restored, stream)
        again.step_idx, again.time_s = step, t_s
        t0 = time.perf_counter()
        again.advance(steps - half)
        again.sync()
        restart_wall = time.perf_counter() - t0
        names = restart_names(cfg)
        differ = [n for n in names if not torch.equal(sim.state[n], again.state[n])]
        nondet = [n for n in names if not torch.equal(sim.state[n], base.state[n])]
        if differ or nondet:
            raise RuntimeError(f"slice 8: the restarted run differs from the unbroken run "
                               f"with output in {len(differ)} of {len(names)} restart fields "
                               f"{differ[:8]}; the run without output in {len(nondet)} "
                               f"{nondet[:8]}")

    # guard locates a NaN put into a copy of theta
    t_bad = sim.state["t"].clone()
    t_bad[7, 42, 63] = float("nan")
    try:
        guard(dict(sim.state, t=t_bad), sim.grid, sim.dt, sim.hx, sim.step_idx)
    except FloatingPointError as e:
        guard_msg = str(e)
    else:
        raise RuntimeError("slice 8: guard passed a state with a NaN in theta")
    if "(k,j,i)=" not in guard_msg or "63" not in guard_msg:
        raise RuntimeError(f"slice 8: guard's message has no location: {guard_msg}")

    ms_step, ms_base = wall / steps * 1e3, wall_base / steps * 1e3
    write_s = {k: [s for _, s in v] for k, v in writes.items()}
    write_bytes = {k: [sizes[os.path.basename(p)] for p, _ in v] for k, v in writes.items()}
    total_write = sum(sum(v) for v in write_s.values())
    d = cfg.domain
    print(f"slice 8 (config 4 with output, restart, auxhist, tslist, NaN check, guard "
          f"every 10 steps, emission stream of 2 files, phase timing): {steps} steps of "
          f"{d.nx}x{d.ny}x{d.nz} from step 0: {ms_step:.3f} ms/step [{card}]; the same run "
          f"without the output alarms {ms_base:.3f} ms/step, config 4's window (no stream, "
          f"no checks, no phase timing) {ms_step4:.3f} ms/step; phases in the window "
          f"{ {k: round(v * 1e3, 3) for k, v in sim.phase_times.items()} } ms, without output "
          f"{ {k: round(v * 1e3, 3) for k, v in base.phase_times.items()} } ms; kernel "
          f"launches {launches} (config 4's)")
    for kind in ("history", "restart", "auxhist"):
        print(f"  {kind} writes: " + ", ".join(
            f"{s * 1e3:.1f} ms for {b / 2**20:.1f} MiB" for s, b in zip(write_s[kind],
                                                                      write_bytes[kind])))
    print(f"  writes synchronised {total_write * 1e3:.1f} ms in all = {total_write / steps * 1e3:.3f}"
          f" ms/step of the window; write_tslist + flush {flush_s * 1e3:.1f} ms; tslist "
          f"{len(ts_files)} files of {steps} rows")
    print(f"slice 8 restart: {steps - half} steps from restart_{half:06d}.nc ({restart_wall / (steps - half) * 1e3:.3f}"
          f" ms/step) equal the unbroken run bit for bit in all {len(names)} restart fields, "
          f"and so does the run without output; "
          f"scipy reads hist_{steps:06d}.nc's theta equal to the state; guard: {guard_msg}")
    numbers = {"ms_step": ms_step, "no_output_ms_step": ms_base,
               "config4_ms_step": ms_step4, "restarted_ms_step": restart_wall / (steps - half) * 1e3,
               "phase_ms": {k: v * 1e3 for k, v in sim.phase_times.items()},
               "no_output_phase_ms": {k: v * 1e3 for k, v in base.phase_times.items()},
               "write_ms": {k: [s * 1e3 for s in v] for k, v in write_s.items()},
               "write_bytes": write_bytes, "flush_ms": flush_s * 1e3,
               "restart_fields_compared": len(names), "restart_fields_differing": 0}
    return launches, numbers


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
    calls = {n: [] for n in ("apply_emissions", "cw_exchange", "wet_scavenging")}
    with _Checked(aux, {n: _recorder(v) for n, v in calls.items()}):
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
    mie_path = chem_on_path(lambda: chem(sim.state, sim.grid, t_now), "slice 6",
                            card)["mie_bins"]
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


FORCED9 = ("u", "v", "w", "t", "mu", "ph", "qv")


def _ring_at_target(state, target, label):
    """Each forced field's outer ring equals the boundary target exactly,
    as `SpecifiedBC.apply` sets it."""
    for k in FORCED9:
        a, b = state[k], target[k]
        for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
            if not torch.equal(a[sl], b[sl]):
                raise RuntimeError(f"{label}: the spec ring of {k} is not the boundary target "
                                   f"(max|d| {float((a[sl] - b[sl]).abs().max())})")


def slice9_phase(dev, card, steps=RAD_CHEM_EVERY):
    """Slice 9's path, the main path: config 4's physics and chemistry on a
    real-data domain (`_cfg9`: real_init of the synthetic analysis at 0,
    3600 and 7200 s on a Lambert grid at 40N over a 1,000 m ridge,
    100x100x50, dx 12 km, dt 60 s, specified boundaries from the two
    segments, bench.py's seed), 2 warm-up steps, then one 100-step window
    (6,000 s) across the segment swap at 3,600 s, with the exact launches
    (300 / 400 / 40 / 10), finite fields, no negative moist or chem field,
    |w| bounded and the spec ring at the target; the synchronised phase
    times, a profile of one main step, and the scalar advection and
    multi-tracer kernels with m2 bitwise on one main step's own calls.
    Returns (launches, numbers)."""
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    cfg = _cfg9()
    t0 = time.perf_counter()
    grid, state, segs = _real_case(cfg, dev)
    setup_s = time.perf_counter() - t0
    state = _seed4(state)
    sim = Simulation(cfg, grid, state, boundary=segs[0], device=dev)
    nt = len(advected_names(cfg))
    m = sim.grid.msft
    d = cfg.domain
    print(f"slice 9: real_init of 3 analyses at {d.nx}x{d.ny}x{d.nz} (Lambert at 40N, 1,000 m "
          f"ridge, map factor {float(m.min()):.4f}-{float(m.max()):.4f}, terrain "
          f"{float(sim.grid.ht.max()):.1f} m) in {setup_s:.2f} s of host time; {nt} advected "
          f"scalars, {len(segs)} boundary segments")
    if not (nt == 107 and sim.rad_every == sim.chem_every == 10 and len(segs) == 2
            and sim.grid.has_terrain and sim.grid.curvature):
        raise RuntimeError(f"slice 9: {nt} scalars, rad every {sim.rad_every}, chem every "
                           f"{sim.chem_every}, {len(segs)} segments; expected 107, 10, 10, 2")
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    _reset_counts()
    swap_step = None
    t0 = time.perf_counter()
    for _ in range(steps):          # steps 2..101: chem and rad at 10, 20, .., 100
        if swap_step is None and sim.time_s >= segs[0].t_hi:
            sim.boundary = segs[1]
            swap_step = sim.step_idx
        sim.advance(1)
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    if swap_step != 60:
        raise RuntimeError(f"slice 9: the segment swap came at step {swap_step}, expected 60 "
                           "(3,600 s)")
    s = sim.state
    for k, v in s.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"slice 9: non-finite {k} after {steps + 2} steps")
    neg = [k for k in list(cfg.moist_species()) + [k for k in s if k.startswith("chem_")]
           if float(s[k].min()) < 0.0]
    if neg:
        raise RuntimeError(f"slice 9: negative fields {neg}")
    w_max = float(s["w"].abs().max())
    if not 1e-3 < w_max < 20.0:
        raise RuntimeError(f"slice 9: max |w| = {w_max} m/s outside (1e-3, 20)")
    _ring_at_target(s, segs[1].at_time(np.float32(sim.time_s - sim.dt)), "slice 9")
    n_chem = steps // sim.chem_every
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": 4 * n_chem, "ros2_integrate": n_chem}
    if launches != want:
        raise RuntimeError(f"slice 9: kernel launches in the {steps}-step window {launches}, "
                           f"expected {want}")
    ms_step = wall / steps * 1e3
    print(f"slice 9: {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up steps ({n_chem} chem "
          f"and {steps // sim.rad_every} rad calls; segment swap at step {swap_step}): "
          f"{ms_step:.3f} ms/step, {d.nx * d.ny * d.nz / (wall / steps) / 1e6:.4f} M "
          f"gridpoints/s [{card}]; max |w| {w_max:.3f} m/s, max qc {float(s['qc'].max()):.3e}, "
          f"theta' {float(s['t'].min()):.2f}-{float(s['t'].max()):.2f} K, swdown max "
          f"{float(s['swdown'].max()):.1f} W m-2, O3 {float(s['chem_o3'].min()):.5f}-"
          f"{float(s['chem_o3'].max()):.5f} ppmv, tau_aer_sw "
          f"{float(s['tau_aer_sw'].min()):.4g}-{float(s['tau_aer_sw'].max()):.4g}; spec rings "
          f"at the target; kernel launches {launches}")

    t_now = np.float32(sim.time_s)
    main, rad, chem = (sim._stepper(k) for k in ("main", "rad", "chem"))
    main_ms = _timed_ms(lambda: main(sim.state, sim.grid, t_now), 5)
    rad_ms = _timed_ms(lambda: rad(sim.state, sim.grid, t_now), 2)
    chem_ms = _timed_ms(lambda: chem(sim.state, sim.grid, t_now), 3)
    print(f"phases (slice 9), synchronised: main step {main_ms:.3f} ms, rad call "
          f"{rad_ms:.3f} ms, chem call {chem_ms:.3f} ms; per step of the window: main + "
          f"(chem + rad)/{sim.chem_every} = "
          f"{main_ms + (chem_ms + rad_ms) / sim.chem_every:.3f} ms")
    dev_c, n_c, _ = _profile(lambda: chem(sim.state, sim.grid, t_now))
    dev_r, n_r, _ = _profile(lambda: rad(sim.state, sim.grid, t_now))
    sim.sync()
    dev_ms, n_kernels, rows = _profile(lambda: sim.advance(1))     # main only
    busy = 100.0 * (dev_ms + (dev_c + dev_r) / sim.chem_every) / ms_step
    print(f"profile of one slice-9 main step: device busy {dev_ms:.3f} ms in {n_kernels} "
          f"launches; one chem call {dev_c:.3f} ms in {n_c}, one rad call {dev_r:.3f} ms in "
          f"{n_r}; against the unprofiled {ms_step:.3f} ms/step the device is busy "
          f"{busy:.1f}% (main step + a tenth of a chem and a rad call); advect_scalar_5_3 "
          f"{_per_call_us(rows, 'advect_scalar_5_3'):.2f} us per call; advect_tracers grids: "
          f"{_tracer_grids_us(rows)}")
    for t_us, count, key in rows[:8]:
        print(f"  {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    dycore_on_path(lambda: sim.advance(1), "slice 9")
    numbers = {"ms_step": ms_step, "setup_host_s": setup_s, "swap_step": swap_step,
               "main_ms": main_ms, "chem_ms": chem_ms, "rad_ms": rad_ms,
               "main_device_ms": dev_ms, "main_launches": n_kernels,
               "chem_device_ms": dev_c, "rad_device_ms": dev_r, "device_busy_pct": busy,
               "w_max": w_max}
    return launches, numbers


def _noise_limited(label, gpu, cpu, ulp, phb):
    """Card against CPU per field: 1e-4 of the field's magnitude (phi at
    that of phb), or three times the CPU run's own float32 noise (`ulp`:
    the CPU run again from the full theta changed by one ulp) where that
    is larger.  States are {name: float64 CPU tensor}.  Returns the worst
    four (err, name, noise)."""
    worst = []
    for k, ref in cpu.items():
        scale = max(phb if k == "ph" else float(ref.abs().max()), 1e-30)
        err = float((gpu[k] - ref).abs().max()) / scale
        noise = float((ulp[k] - ref).abs().max()) / scale
        worst.append((err, k, noise))
        if not err <= max(1e-4, 3.0 * noise):
            raise RuntimeError(f"card vs CPU ({label}): {k} differs by {err:.3g} of its "
                               f"magnitude (CPU noise {noise:.3g})")
    worst.sort(reverse=True)
    return worst[:4]


def _theta_ulp(state):
    t = state["t"]
    return dict(state, t=(t + 300.0) * (1.0 + 2.0 ** -23) - 300.0)


def _host64(state):
    return {k: v.double().cpu() for k, v in state.items()}


def _card_vs_cpu(dev, label, run):
    """`run(device, perturb)` returns ({part: state}, phb) after its steps,
    `perturb` applied to its start; the card's run against the CPU's, part
    by part."""
    runs = {key: run(where, p) for key, where, p in (("gpu", dev, None), ("cpu", "cpu", None),
                                                     ("ulp", "cpu", _theta_ulp))}
    phb = runs["cpu"][1]
    parts = []
    for part, cpu in runs["cpu"][0].items():
        worst = _noise_limited(f"{label}, {part}" if part else label,
                               _host64(runs["gpu"][0][part]), _host64(cpu),
                               _host64(runs["ulp"][0][part]), phb)
        parts.append((f"{part}: " if part else "") + ", ".join(
            f"{k} {e:.3g} (noise {n:.3g})" for e, k, n in worst))
    print(f"cross-check {label}, card vs CPU, worst fields: " + "; ".join(parts))
    return runs["gpu"][0]


def item9_cross_checks(dev):
    """Card against CPU at small sizes for what slice 9's window does not
    run: a real case with analysis nudging toward its boundary segment; the
    hill2d_x case; a lat-lon grid reaching 68N with the polar filter; a
    one-way and a two-way 3:1 nest (the two-way one moved a parent cell
    east after its first step); and ndown from two history files the port
    wrote on the card."""
    import dataclasses
    import tempfile
    from wrfchem_arc_interactions_tpu_torch.grid import make_grid
    from wrfchem_arc_interactions_tpu_torch.grid.projection import Projection
    from wrfchem_arc_interactions_tpu_torch.io import history as hio
    from wrfchem_arc_interactions_tpu_torch.models import ideal, ndown, nest, soundings
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation

    cfg = _cfg_small(24, 16, 12, 12e3, 60.0, 16000.0, 10000.0,
                     dynamics=dict(kvdif=0.0, bc_x="specified", bc_y="specified"))
    cfg = cfg.replace(fdda=dataclasses.replace(cfg.fdda, grid_fdda=True, guv=1e-3, gt=1e-3,
                                               gq=1e-4))

    def real_fdda(where, perturb):
        grid, state, segs = _real_case(cfg, where, times=(0.0, 3600.0))
        sim = Simulation(cfg, grid, (perturb or dict)(state), boundary=segs[0], fdda=segs[0],
                         device=where)
        sim.advance(3)
        return {"": sim.state}, float(grid.phb.abs().max())

    _card_vs_cpu(dev, "real case with fdda, 24x16x12", real_fdda)
    cross_check(dev, _cfg_small(32, 4, 12, 2000.0, 6.0, 12000.0, 20000.0,
                                dynamics=dict(kvdif=10.0, bc_x="open")),
                lambda st: st, "hill2d_x", case="hill2d_x", full_theta_ulp=True,
                hm=300.0, a_half=8000.0, u0=8.0)

    cfg_ll = _cfg_small(32, 16, 10, 50e3, 60.0, 12000.0, 20000.0,
                        dynamics=dict(kvdif=10.0, fft_filter_lat=45.0, bc_y="open"))

    def latlon(where, perturb):
        grid = make_grid(cfg_ll, soundings.constant_n2_theta(), where,
                         projection=Projection(kind="lat-lon", ref_lat=60.0))
        state = ideal.warm_bubble(cfg_ll, grid, amplitude=2.0, zc=1500.0, xr=150e3, zr=1200.0,
                                  three_d=True)
        sim = Simulation(cfg_ll, grid, (perturb or dict)(state), device=where)
        sim.advance(3)
        return {"": sim.state}, float(grid.phb.abs().max())

    _card_vs_cpu(dev, "lat-lon grid at 60N (16 rows of 50 km) with the polar filter at 45N",
                 latlon)

    cfg_n = _cfg_small(24, 14, 8, 3000.0, 12.0, 12000.0, 20000.0, dynamics=dict(kvdif=20.0))
    spec = nest.NestSpec(i_start=8, j_start=3, nx_parent_cells=8, ny_parent_cells=8, ratio=3)
    for feedback in (False, True):
        def nested(where, perturb, feedback=feedback):
            grid, state = ideal.make_case(cfg_n, "warm_bubble", device=where, amplitude=2.0,
                                          zc=1500.0, xr=6000.0, zr=1200.0, three_d=True)
            n = nest.NestedSimulation(cfg_n, grid, (perturb or dict)(state), spec,
                                      theta_of_z=soundings.constant_n2_theta(),
                                      feedback=feedback, device=where)
            n.advance(1)
            if feedback:
                n.move(1, 0)
            n.advance(1)
            return ({"parent": n.parent.state, "child": n.child.state},
                    float(grid.phb.abs().max()))

        _card_vs_cpu(dev, "two-way 3:1 nest with a move" if feedback else "one-way 3:1 nest",
                     nested)

    cfg_h = cfg_n.replace(time_control=dataclasses.replace(cfg_n.time_control,
                                                           history_interval_s=24.0))
    with tempfile.TemporaryDirectory() as tmp:
        grid, state = ideal.make_case(cfg_h, "warm_bubble", device=dev, amplitude=2.0,
                                      zc=1500.0, xr=8000.0, zr=1200.0, three_d=True)
        Simulation(cfg_h, grid, state, output_dir=tmp, device=dev).advance(4)
        hio.flush()
        files = sorted(glob.glob(f"{tmp}/hist_*"))
        if len(files) != 2:
            raise RuntimeError(f"ndown: {len(files)} history files, expected 2")
        spec_d = nest.NestSpec(i_start=8, j_start=3, nx_parent_cells=8, ny_parent_cells=6)

        def fine(where, perturb):
            cfg_c, grid_c, state0, segs = ndown.ndown(cfg_h, files, spec_d,
                                                      soundings.constant_n2_theta(),
                                                      device=where)
            sim = Simulation(cfg_c, grid_c, (perturb or dict)(state0), boundary=segs[0],
                             device=where)
            sim.advance(3)
            return {"": sim.state}, float(grid_c.phb.abs().max())

        _card_vs_cpu(dev, "ndown from two history files written on the card", fine)


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
    mie_path = chem_on_path(lambda: chem(sim.state, sim.grid, t_now), label,
                            card)["mie_bins"]
    if len(mie_path) != 4:
        raise RuntimeError(f"{label}: {len(mie_path)} Mie calls in one chem call, expected 4")
    torch.cuda.empty_cache()
    dycore_on_path(lambda: sim.advance(1), label)
    return modes, launches, mie_path


MESH10 = (2, 2)                # slice 10's mesh: four 50x50 blocks of config 4
WINDOW10 = 20                  # steps 2..21: chem calls at 10 and 20
# tests/test_parallel.py:165-169, the reference's full-step tolerances
TOL10 = {"u": 5e-3, "v": 5e-3, "w": 5e-3, "t": 5e-3, "mu": 0.1, "ph": 0.2,
         "qv": 1e-7, "qc": 1e-7, "nc": 5e2, "rthraten_sw": 1e-9, "rthraten_lw": 1e-9,
         "chem_so4_a01": 1e-4, "chem_num_a01": 5e3, "chem_o3": 1e-6, "chem_no2": 1e-6}


def _run10(sim, steps):
    """Warm up 2 steps, then a window of `steps` from zeroed counts: (the
    window's launches, exchanges and bytes sent, host ms per step)."""
    sim.advance(2)
    sim.sync()
    mesh = sim.mesh
    if mesh is not None:
        mesh.barrier()
        ex0, b0 = mesh.exchanges, mesh.bytes_sent
    _reset_counts()
    t0 = time.perf_counter()
    sim.advance(steps)
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    ex, nbytes = (0, 0) if mesh is None else (mesh.exchanges - ex0, mesh.bytes_sent - b0)
    return launches, ex, nbytes, wall * 1e3 / steps


def slice10_rank(rank, device, steps, shape):
    """One rank of slice 10's phase: config 4 on its 50x50 block of the 2x2
    mesh (gloo; the ranks share the card), built from the global case
    exactly as the single-block run builds it."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(device)
    mesh = make_mesh(*MESH10, device=dev)
    cfg = _cfg4(*shape)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, _seed4(state), mesh=mesh)
    del grid, state
    torch.cuda.empty_cache()
    launches, ex, nbytes, ms_step = _run10(sim, steps)
    g = sim.gather_state()
    on_path = on_path10(sim, f"slice 10 rank {rank}")
    return {"rank": rank, "block": (mesh.iy, mesh.ix, sim.grid.ny, sim.grid.nx),
            "launches": launches, "exchanges": ex, "bytes": nbytes, "ms_step": ms_step,
            "chem_calls": sum(1 for n in range(2, 2 + steps) if n % sim.chem_every == 0),
            "on_path": on_path,
            "state": None if g is None else {k: v.numpy() for k, v in g.items()}}


def on_path10(sim, label):
    """The four kernels against their plain versions on one rank's own
    inputs, at its block's shapes: every call of the scalar advection and
    multi-tracer kernels in one main step, bitwise (`dycore_on_path`; the
    limited multi-tracer call goes through the wrapper's seam grids and the
    exchange of r_hi's ring, `tracers_kernel._seam_stage`), then the Mie
    and ROS2 calls of one chem call, within their limits (`chem_on_path`).
    Every rank calls it in the same order: the seam stage and the plain
    multi-tracer update pad through the mesh.  Returns the calls compared
    and the errors."""
    from wrfchem_arc_interactions_tpu_torch.ops import tracers_kernel
    seams = []
    with _Checked(tracers_kernel, {"_seam_stage": _recorder(seams)}):
        dycore_on_path(lambda: sim.advance(1), label)
    n_seam = len(seams)
    del seams
    if n_seam != 1:
        raise RuntimeError(f"{label}: {n_seam} multi-tracer calls through the seam grids "
                           "(the step's limited stage expected)")
    chem = sim._stepper("chem")
    t_now = np.float32(sim.time_s)
    calls = chem_on_path(lambda: chem(sim.state, sim.grid, t_now), label)
    if len(calls["mie_bins"]) != 4 or len(calls["ros2"]) != 1:
        raise RuntimeError(f"{label}: {len(calls['mie_bins'])} Mie and {len(calls['ros2'])} "
                           "gas integrations in one chem call, expected 4 and 1")
    r = calls["ros2"][0]
    return {"bitwise_calls": {name: ON_PATH[name][label] for name in ON_PATH},
            "seam_stage_calls": n_seam, "mie_bins": 4,
            "mie_max_abs_err": max(b["max_abs_err"] for b in calls["mie_bins"]),
            "ros2_cells": r["cells"], "ros2_max_abs_err": r["max_abs_err"],
            "ros2_max_rel_err": r["max_rel_err"], "ros2_bitwise": r["bitwise"],
            "ros2_rel_err_vectorised": r["max_rel_err_vectorised"]}


def slice10_phase(dev, card, steps=WINDOW10, shape=(100, 100, 50)):
    """Slice 10's main path: config 4 on a 2x2 mesh of four ranks sharing
    the card over gloo (strips staged through the host), 2 warm-up steps
    and a 20-step window, against one block on the card over the same 22
    steps; per rank the launches of each kernel per main step and per chem
    call, the exchanges and bytes per main step and ms/step.  Returns the
    window's launches summed over the ranks, and the numbers."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.parallel import launch
    cfg = _cfg4(*shape)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, _seed4(state), device=dev)
    one_launches, _, _, one_ms = _run10(sim, steps)
    one = {k: v.cpu().numpy() for k, v in sim.state.items()}
    del sim, grid, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(slice10_rank, MESH10[0] * MESH10[1], "gloo",
                         [str(dev)] * (MESH10[0] * MESH10[1]), args=(steps, shape))
    spawn_s = time.perf_counter() - t0
    got = ranks[0]["state"]
    bad = [k for k, v in got.items() if not np.isfinite(v).all()]
    if bad:
        raise RuntimeError(f"slice 10: non-finite {bad} after {steps + 2} steps")
    diffs = {k: float(np.abs(one[k].astype(np.float64) - got[k].astype(np.float64)).max())
             for k in one}
    bitwise = all(d == 0.0 for d in diffs.values())
    print(f"slice 10: config 4 on a {MESH10[0]}x{MESH10[1]} mesh, {steps + 2} steps, "
          f"gathered on rank 0, against one block on the card: every field bitwise "
          f"{bitwise}; max|d| of the prognostic fields: "
          + ", ".join(f"{k} {diffs[k]:.3g} (tol {t:g})" for k, t in TOL10.items()))
    over = {k: diffs[k] for k, t in TOL10.items() if not diffs[k] < t}
    if over:
        raise RuntimeError(f"slice 10: 2x2 vs one block beyond tolerance: {over}")
    for r in ranks:
        o = r["on_path"]
        for name, n in o["bitwise_calls"].items():
            ON_PATH[name][f"slice 10 rank {r['rank']}"] = n
        print(f"slice 10 rank {r['rank']}, kernels against their plain versions on the "
              f"rank's own inputs: one main step's advect_scalar_5_3 "
              f"{o['bitwise_calls']['advect_scalar_5_3']} calls and advect_tracers "
              f"{o['bitwise_calls']['advect_tracers']} calls ({o['seam_stage_calls']} "
              f"through the seam grids), bitwise; one chem call's mie_cheb_eval "
              f"{o['mie_bins']} bins, max|d| {o['mie_max_abs_err']:.3g}, and ros2_integrate "
              f"at {o['ros2_cells']} cells, max|a-b|/(|b|+1e3) {o['ros2_max_rel_err']:.3g}, "
              f"bitwise {o['ros2_bitwise']}")
    per_step = ("advect_scalar_5_3", "advect_tracers")
    per_chem = ("mie_cheb_eval", "ros2_integrate")
    chem_one = ranks[0]["chem_calls"]
    for r in ranks:
        c = r["launches"]
        for k in per_step:
            if c[k] != one_launches[k]:
                raise RuntimeError(f"slice 10 rank {r['rank']}: {k} {c[k]} launches, one "
                                   f"block {one_launches[k]}")
        for k in per_chem:
            if c[k] != one_launches[k] or c[k] < 1:
                raise RuntimeError(f"slice 10 rank {r['rank']}: {k} {c[k]} launches, one "
                                   f"block {one_launches[k]}")
        iy, ix, by, bx = r["block"]
        print(f"slice 10 rank {r['rank']} block ({iy}, {ix}) {by}x{bx}: per main step "
              + ", ".join(f"{k} {c[k] / steps:g}" for k in per_step)
              + "; per chem call "
              + ", ".join(f"{k} {c[k] / r['chem_calls']:g}" for k in per_chem)
              + f"; {r['exchanges'] / steps:g} exchanges, "
              f"{r['bytes'] / steps / 2**20:.3f} MiB sent per main step; "
              f"{r['ms_step']:.1f} ms/step (4 ranks share one card, strips staged "
              f"through the host: not a scaling number; one block alone "
              f"{one_ms:.1f} ms/step) [{card}]")
    print(f"slice 10: spawn, case, {steps + 2} steps and gather of 4 ranks took "
          f"{spawn_s:.1f} s; chem calls in the window {chem_one}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in one_launches}
    numbers = {"mesh": list(MESH10), "window_steps": steps, "bitwise_vs_one_block": bitwise,
               "max_abs_diff": {k: diffs[k] for k in TOL10},
               "ranks": [{k: r[k] for k in ("rank", "block", "launches", "exchanges",
                                            "bytes", "ms_step", "on_path")} for r in ranks],
               "one_block_ms_step": one_ms, "launches_one_block": one_launches}
    return launches, numbers


def kernel_tracers_seams(dev, card, nt=107):
    """K4 at block seams on the card: a 2x2 set of 50x50 blocks cut, with
    true-image halos, out of config-4-like inputs (nt = 107, nz = 50), with
    the limiter, flat and with slice 9's m2, on every boundary kind on the
    outer sides; each block through `advect_tracers_seam`'s two grids (r_hi's
    ring cut from the assembled FACTOR output, as the exchange brings it),
    bitwise against the plain version on the whole domain.  Then one
    block's seam stage timed beside the flat kernel's at the same shape."""
    import ctypes
    from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.ops import build, tracers_kernel
    from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import Mesh
    grid, _ = ideal.make_case(_cfg4(), "squall2d_x", device=dev, bubble_amp=3.0)
    args, pt, _ = tracer_inputs(dev, grid, nt)
    q = args[0][..., 3:-3, 3:-3]
    ru, rv = args[2][..., 3:-3, 3:-3], args[3][..., 3:-3, 3:-3]
    phi, ww, mu_full, mu_new = args[1], args[4], args[5], args[6]
    lib = build.load("advect_tracers")
    fn = lib.advect_tracers_seam
    fn.argtypes = tracers_kernel._SEAM_ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    by, bx = ny // 2, nx // 2
    out_numbers = {}

    def ptr(t):
        return None if t is None else t.data_ptr()

    for g in (grid, _projected9(grid)):
        label = "m2" if g.has_msf else "flat"
        m2 = tracers_kernel.map_factor_sq(g)
        for bc in (BCKind.PERIODIC, BCKind.OPEN, BCKind.SYMMETRIC, BCKind.SPECIFIED):
            hx = HaloOps(bc, bc)
            qp, rup, rvp = (hx.pad(a, 3) for a in (q, ru, rv))
            ref = tracers_kernel.advect_tracers_reference(
                qp, phi, rup, rvp, ww, mu_full, mu_new, g, hx, 6.0, pt=pt, pd=True, clip=True)
            ring = {"phi": hx.pad(phi, 1), "ww": hx.pad(ww, 1),
                    "m2": None if m2 is None else hx.pad(m2, 1)}
            blocks = []
            for rank in range(4):
                mesh = Mesh(2, 2, rank, None, dev, "gloo")
                y0, x0 = mesh.iy * by, mesh.ix * bx

                def cut(a, h=0):
                    return a[..., y0:y0 + by + 2 * h, x0:x0 + bx + 2 * h].contiguous()

                b = {"q": cut(qp, 3), "ru": cut(rup, 3), "rv": cut(rvp, 3), "pt": cut(pt),
                     "mu_full": cut(mu_full), "mu_new": cut(mu_new),
                     "phi_r": cut(ring["phi"], 1), "ww_r": cut(ring["ww"], 1),
                     "m2_r": None if m2 is None else cut(ring["m2"], 1),
                     "r_hi": torch.empty((nt, nz, by, bx), device=dev),
                     "out": torch.empty((nt, nz, by, bx), device=dev),
                     "edges": tracers_kernel.edge_codes(
                         HaloOps(bc, bc, mesh=mesh))}
                blocks.append((y0, x0, b))

            def seam(grid_no, b, r_ring):
                return fn(grid_no, b["q"].data_ptr(), b["phi_r"].data_ptr(), b["pt"].data_ptr(),
                          b["ru"].data_ptr(), b["rv"].data_ptr(), b["ww_r"].data_ptr(),
                          b["mu_full"].data_ptr(), b["mu_new"].data_ptr(), g.rdnw.data_ptr(),
                          ptr(b["m2_r"]), b["r_hi"].data_ptr(), ptr(r_ring),
                          b["out"].data_ptr(), nt, nz, by, bx, float(g.rdx), float(g.rdy),
                          6.0, 1, *b["edges"], stream)

            for _, _, b in blocks:
                if seam(tracers_kernel.FACTOR, b, None) != 0:
                    raise RuntimeError("advect_tracers_seam: FACTOR grid refused")
            r_all = torch.empty_like(ref)
            for y0, x0, b in blocks:
                r_all[..., y0:y0 + by, x0:x0 + bx] = b["r_hi"]
            r_ring = hx.pad(r_all, 1)
            for y0, x0, b in blocks:
                b["r_ring"] = r_ring[..., y0:y0 + by + 2, x0:x0 + bx + 2].contiguous()
                if seam(tracers_kernel.LIMITED, b, b["r_ring"]) != 0:
                    raise RuntimeError("advect_tracers_seam: LIMITED grid refused")
            torch.cuda.synchronize()
            worst = 0.0
            for y0, x0, b in blocks:
                want = ref[..., y0:y0 + by, x0:x0 + bx]
                worst = max(worst, float((b["out"] - want).abs().max()))
                if not torch.equal(b["out"], want):
                    raise RuntimeError(f"advect_tracers at seams ({label}, {bc.value}) block "
                                       f"({y0}, {x0}): max|d| = {worst}, not bitwise")
            print(f"advect_tracers at block seams (2x2 of {by}x{bx}, nt={nt}, nz={nz}, "
                  f"{label}, {bc.value} outer sides, limiter and clip): bitwise equal to "
                  f"the plain version on the whole domain in every block")
            if bc == BCKind.OPEN:
                y0, x0, b = blocks[0]
                seam_ms = _device_ms(lambda: (seam(tracers_kernel.FACTOR, b, None),
                                              seam(tracers_kernel.LIMITED, b, b["r_ring"])),
                                     calls=10, trials=20)
                phi_b = phi[..., y0:y0 + by, x0:x0 + bx].contiguous()
                ww_b = ww[..., y0:y0 + by, x0:x0 + bx].contiguous()
                flat_args = (b["q"], phi_b, b["ru"], b["rv"], ww_b, b["mu_full"], b["mu_new"],
                             _block_grid(g, y0, x0, by, bx),
                             HaloOps(BCKind.OPEN, BCKind.OPEN), 6.0)
                flat_ms = _device_ms(lambda: tracers_kernel.advect_tracers(
                    *flat_args, pt=b["pt"], pd=True, clip=True), calls=10, trials=20)
                bound = _tracers_bound(nt, nz, by, bx, True, g.has_msf)
                plans = {"seam": _tracers_plan(nt, nz, by, bx, True, g.has_msf, seam=True),
                         "flat": _tracers_plan(nt, nz, by, bx, True, g.has_msf)}
                print(f"advect_tracers with the limiter at ({nt}, {nz}, {by}, {bx}), {label}: "
                      f"seam grids (x tiles, ring-padded phi/ww/m2 and r_hi) "
                      f"{seam_ms:.4f} ms, flat kernel on the same block (open sides) "
                      f"{flat_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); the ring "
                      f"exchanges not included; seam plan: {_plan_str(plans['seam'])}; flat "
                      f"plan: {_plan_str(plans['flat'])} [{card}]")
                out_numbers[label] = {"seam_ms": seam_ms, "flat_ms": flat_ms,
                                      "bound_ms": bound[0], "bound_by": bound[1],
                                      "bitwise_all_kinds": True, "plan": plans}
            del ref, qp, rup, rvp, blocks, r_all, r_ring
            torch.cuda.empty_cache()
    return out_numbers


def _block_grid(grid, y0, x0, by, bx):
    """The (y0, x0) block of `grid` (its horizontal fields cut)."""
    import dataclasses
    from wrfchem_arc_interactions_tpu_torch.grid.grid import TENSOR_FIELDS
    return dataclasses.replace(grid, **{
        k: getattr(grid, k)[..., y0:y0 + by, x0:x0 + bx].contiguous()
        for k in TENSOR_FIELDS if getattr(grid, k).dim() >= 2})


def nccl_phase(dev):
    """With two cards or more: the dycore-only case (slice 1's path,
    config 3 without radiation and chemistry) on a 1x2 mesh over NCCL, one
    card per rank, against one card.  On one card it says so and returns."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"slice 10 NCCL check (1x2 mesh, one card per rank): not run, this machine "
              f"has {n} card and NCCL needs a card per rank")
        return None
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.parallel import launch
    cfg = _cfg3(rad_chem=False)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, state, device=dev)
    sim.advance(10)
    one = {k: v.cpu().numpy() for k, v in sim.state.items()}
    got = launch.spawn(nccl_rank, 2, "nccl", ["cuda:0", "cuda:1"])[0]
    diffs = {k: float(np.abs(one[k].astype(np.float64) - got[k]).max()) for k in one}
    print("slice 10 NCCL check (1x2 mesh, cuda:0 and cuda:1, 10 dycore steps) against one "
          "card: max|d| " + ", ".join(f"{k} {d:.3g}" for k, d in diffs.items()))
    over = {k: diffs[k] for k, t in TOL10.items() if k in diffs and not diffs[k] < t}
    if over:
        raise RuntimeError(f"slice 10 NCCL: 1x2 vs one card beyond tolerance: {over}")
    return diffs


def nccl_rank(rank, device):
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 2, device=device)
    cfg = _cfg3(rad_chem=False)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=device, bubble_amp=3.0)
    sim = Simulation(cfg, grid, state, mesh=mesh)
    sim.advance(10)
    g = sim.gather_state()
    return None if g is None else {k: v.numpy() for k, v in g.items()}


MESH11 = (2, 2)                # slice 11's mesh, for parent and child
WINDOW11 = 10                  # parent steps 2..11 (child 6..35): one chem call each
# the child of slice 11: 90x90 at dt 2 s over parent cells 35..64 in x and
# y, across both seams of the parent's 2x2 mesh (x = 50, y = 50); its own
# blocks are 45x45, not the parent's 50x50
SPEC11 = dict(i_start=35, j_start=35, nx_parent_cells=30, ny_parent_cells=30, ratio=3)


def _nest11(cfg, dev, spec, mesh=None):
    """Config 4 (`cfg`) nested as slice 11 runs it: the squall line with
    bench.py's seed, a two-way 3:1 child at `spec`; on `mesh` when given."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal, soundings
    from wrfchem_arc_interactions_tpu_torch.models.nest import NestedSimulation, NestSpec
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    return NestedSimulation(cfg, grid, _seed4(state), NestSpec(**spec),
                            soundings.weisman_klemp_theta(), feedback=True, mesh=mesh,
                            device=dev)


def _run11(nest, steps):
    """Warm up 2 parent steps, then a window of `steps` parent steps from
    zeroed counts: the window's launches of each domain, the mesh's halo
    exchanges and bytes and its all-gathers and their bytes, and host ms
    per parent step.  The domains' launches are told apart by counting
    around each `Simulation.advance` call that the nest makes."""
    tally = {"parent": {}, "child": {}}
    for which, counts in tally.items():
        sim = getattr(nest, which)

        def advance(n, *a, _inner=sim.advance, _counts_of=counts, **kw):
            c0 = _counts()
            _inner(n, *a, **kw)
            for k, v in _counts().items():
                _counts_of[k] = _counts_of.get(k, 0) + v - c0[k]
        sim.advance = advance
    nest.advance(2)
    nest.parent.sync()
    mesh = nest.mesh
    if mesh is not None:
        mesh.barrier()
        m0 = (mesh.exchanges, mesh.bytes_sent, mesh.all_gathers, mesh.all_gather_bytes)
    for counts in tally.values():
        counts.clear()
    _reset_counts()
    t0 = time.perf_counter()
    nest.advance(steps)
    nest.parent.sync()
    wall = time.perf_counter() - t0
    for which in tally:
        del getattr(nest, which).advance
    traffic = (0, 0, 0, 0) if mesh is None else tuple(
        b - a for a, b in zip(m0, (mesh.exchanges, mesh.bytes_sent, mesh.all_gathers,
                                   mesh.all_gather_bytes)))
    chem = {which: sum(1 for n in range(lo, hi) if n % getattr(nest, which).chem_every == 0)
            for which, (lo, hi) in (("parent", (2, 2 + steps)),
                                    ("child", (2 * nest.spec.ratio,
                                               (2 + steps) * nest.spec.ratio)))}
    return tally, chem, traffic, wall * 1e3 / steps


def slice11_rank(rank, device, steps, shape, spec):
    """One rank of slice 11's phase: config 4 nested, the parent's 50x50
    and the child's 45x45 blocks of the 2x2 mesh (gloo; the ranks share
    the card); then `on_path10` on the child's block."""
    from wrfchem_arc_interactions_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device(device)
    mesh = make_mesh(*MESH11, device=dev)
    nest = _nest11(_cfg4(*shape), dev, spec, mesh)
    torch.cuda.empty_cache()
    tally, chem, traffic, ms_step = _run11(nest, steps)
    parent, child = nest.parent.gather_state(), nest.child.gather_state()
    on_path = on_path10(nest.child, f"slice 11 child rank {rank}")
    return {"rank": rank, "blocks": {w: (getattr(nest, w).grid.ny, getattr(nest, w).grid.nx)
                                     for w in ("parent", "child")},
            "launches": tally, "chem_calls": chem, "exchanges": traffic[0],
            "bytes": traffic[1], "all_gathers": traffic[2], "all_gather_bytes": traffic[3],
            "ms_step": ms_step, "on_path": on_path,
            "state": None if parent is None else {
                "parent": {k: v.numpy() for k, v in parent.items()},
                "child": {k: v.numpy() for k, v in child.items()}}}


def slice11_phase(dev, card, steps=WINDOW11, shape=(100, 100, 50), spec=SPEC11):
    """Slice 11's main path: config 4 nested (`_cfg4`, a two-way 3:1 child
    of 90x90x50 at dt 2 s) on a 2x2 mesh of four ranks sharing the card over
    gloo, 2 warm-up parent steps and a 10-step window (30 child steps, one
    chem call on each domain), against the one-block nest on the card over
    the same steps; per rank the launches of each kernel per parent step
    and per chem call of each domain, the halo's exchanges and bytes and
    the nest's all-gathers and bytes per parent step, ms per parent step;
    then on every rank `on_path10` on the child's block.  Returns the
    window's launches summed over the ranks and both domains, and the
    numbers."""
    from wrfchem_arc_interactions_tpu_torch.parallel import launch
    nest = _nest11(_cfg4(*shape), dev, spec)
    tally_one, chem_one, _, one_ms = _run11(nest, steps)
    one = {w: {k: v.cpu().numpy() for k, v in getattr(nest, w).state.items()}
           for w in ("parent", "child")}
    del nest
    torch.cuda.empty_cache()
    per_step = ("advect_scalar_5_3", "advect_tracers")
    per_chem = ("mie_cheb_eval", "ros2_integrate")
    ratio = spec["ratio"]
    for which, n_steps in (("parent", steps), ("child", ratio * steps)):
        want = {"advect_scalar_5_3": 3 * n_steps,
                "advect_tracers": _tracer_grids_per_step() * n_steps,
                "mie_cheb_eval": 4 * chem_one[which], "ros2_integrate": chem_one[which]}
        if tally_one[which] != want or chem_one[which] < 1:
            raise RuntimeError(f"slice 11 one block, {which}: launches {tally_one[which]} "
                               f"in the window, expected {want}")
    t0 = time.perf_counter()
    ranks = launch.spawn(slice11_rank, MESH11[0] * MESH11[1], "gloo",
                         [str(dev)] * (MESH11[0] * MESH11[1]), args=(steps, shape, spec))
    spawn_s = time.perf_counter() - t0
    diffs, bitwise = {}, True
    for which in ("parent", "child"):
        got = ranks[0]["state"][which]
        bad = [k for k, v in got.items() if not np.isfinite(v).all()]
        if bad:
            raise RuntimeError(f"slice 11 {which}: non-finite {bad}")
        if set(got) != set(one[which]):
            raise RuntimeError(f"slice 11 {which}: fields differ from one block's")
        diffs[which] = {k: float(np.abs(one[which][k].astype(np.float64)
                                        - got[k].astype(np.float64)).max())
                        for k in one[which]}
        nonzero = {k: d for k, d in diffs[which].items() if d != 0.0}
        bitwise = bitwise and not nonzero
        print(f"slice 11: config 4 nested on a {MESH11[0]}x{MESH11[1]} mesh, {which} "
              f"({len(got)} fields) after {steps + 2} parent steps, gathered on rank 0, "
              f"against the one-block nest on the card: bitwise in every field "
              f"{not nonzero}" + ("" if not nonzero else "; max|d| per field: "
                                  + ", ".join(f"{k} {d:.3g}" for k, d in nonzero.items())))
        over = {k: diffs[which][k] for k, t in TOL10.items()
                if k in diffs[which] and not diffs[which][k] < t}
        if over:
            raise RuntimeError(f"slice 11 {which}: 2x2 vs one block beyond tolerance: {over}")
    for r in ranks:
        o = r["on_path"]
        for name, n in o["bitwise_calls"].items():
            ON_PATH[name][f"slice 11 child rank {r['rank']}"] = n
        print(f"slice 11 child rank {r['rank']}, kernels against their plain versions on "
              f"the rank's own inputs ({r['blocks']['child'][0]}x{r['blocks']['child'][1]} "
              f"block): one child step's advect_scalar_5_3 "
              f"{o['bitwise_calls']['advect_scalar_5_3']} calls and advect_tracers "
              f"{o['bitwise_calls']['advect_tracers']} calls ({o['seam_stage_calls']} "
              f"through the seam grids), bitwise; one chem call's mie_cheb_eval "
              f"{o['mie_bins']} bins, max|d| {o['mie_max_abs_err']:.3g}, and ros2_integrate "
              f"at {o['ros2_cells']} cells, max|a-b|/(|b|+1e3) {o['ros2_max_rel_err']:.3g}, "
              f"bitwise {o['ros2_bitwise']}")
        if not o["ros2_bitwise"]:
            raise RuntimeError(f"slice 11 child rank {r['rank']}: ros2_integrate not "
                               "bitwise on the child's inputs")
    for r in ranks:
        for which, n_steps in (("parent", steps), ("child", ratio * steps)):
            c = r["launches"][which]
            for k in per_step + per_chem:
                if c[k] != tally_one[which][k] or (k in per_chem and c[k] < 1):
                    raise RuntimeError(f"slice 11 rank {r['rank']} {which}: {k} {c[k]} "
                                       f"launches, one block {tally_one[which][k]}")
            by, bx = r["blocks"][which]
            print(f"slice 11 rank {r['rank']} {which} {by}x{bx} block: per parent step "
                  + ", ".join(f"{k} {c[k] / steps:g}" for k in per_step)
                  + "; per chem call "
                  + ", ".join(f"{k} {c[k] / r['chem_calls'][which]:g}" for k in per_chem)
                  + f" ({r['chem_calls'][which]} chem call(s) in {n_steps} {which} steps)")
        print(f"slice 11 rank {r['rank']}: per parent step {r['exchanges'] / steps:g} halo "
              f"exchanges, {r['bytes'] / steps / 2**20:.3f} MiB sent; the nest's "
              f"{r['all_gathers'] / steps:g} all-gathers, "
              f"{r['all_gather_bytes'] / steps / 2**20:.3f} MiB assembled; "
              f"{r['ms_step']:.1f} ms per parent step (4 ranks share one card, strips and "
              f"gathers through the host: not a scaling number; the one-block nest "
              f"{one_ms:.1f} ms per parent step) [{card}]")
    print(f"slice 11: spawn, cases, {steps + 2} parent steps, gathers and on-path checks "
          f"of 4 ranks took {spawn_s:.1f} s")
    names = per_step + per_chem
    launches = {k: sum(r["launches"][w][k] for r in ranks for w in ("parent", "child"))
                for k in names}
    numbers = {"mesh": list(MESH11), "spec": spec, "window_parent_steps": steps,
               "bitwise_vs_one_block": bitwise, "max_abs_diff": diffs,
               "ranks": [{k: r[k] for k in ("rank", "blocks", "launches", "chem_calls",
                                            "exchanges", "bytes", "all_gathers",
                                            "all_gather_bytes", "ms_step", "on_path")}
                         for r in ranks],
               "one_block_ms_per_parent_step": one_ms, "launches_one_block": tally_one}
    return launches, numbers


# one card's block of BASELINE config 5 (1000x1000x60 on a 2x2 mesh of
# cards): (nx, ny, nz)
CONFIG5_BLOCK = (500, 500, 60)
WINDOW12 = 20                  # steps 2..21: chem calls at 10 and 20
WIDTH12 = (200, 200, 100, 100)  # the width check's interior window (y0, x0, ny, nx)
TRACER_SLICE12 = 8             # tracers per plain pass of the multi-tracer check
ROS2_CHUNK12 = 1 << 20         # cells per plain pass of the ROS2 check


def _window_state(state, cfg, y0, x0, ny, nx):
    """The (y0, x0) window of `state` (every field split over (y, x) by the
    field table cut)."""
    from wrfchem_arc_interactions_tpu_torch.registry.state import state_partition_specs
    specs = state_partition_specs(cfg)
    return {k: v[..., y0:y0 + ny, x0:x0 + nx].contiguous() if "mx" in specs[k] else v
            for k, v in state.items()}


def _executable(fn, dev):
    """One synchronised call of `fn`: (ms, peak bytes above those held
    before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - base
    del out
    return ms, peak


def _width_check(sim, t_now, window, label):
    """The chem call and the rad call on an interior window cut out of the
    block (grid and state) and on the block: every output field equal on
    the window's columns, bit for bit (what a mesh of blocks of any width
    relies on).  Returns {call: fields the call wrote}."""
    y0, x0, wy, wx = window
    grid_w = _block_grid(sim.grid, y0, x0, wy, wx)
    state_w = _window_state(sim.state, sim.cfg, y0, x0, wy, wx)
    written = {}
    for key in ("chem", "rad"):
        fn = sim._stepper(key)
        whole = fn(sim.state, sim.grid, t_now)
        part = fn(state_w, grid_w, t_now)
        cut = _window_state(whole, sim.cfg, y0, x0, wy, wx)
        if set(cut) != set(part):
            raise RuntimeError(f"{label}: the {key} call's fields differ between block "
                               "and window")
        differ = {k: float((cut[k].double() - part[k].double()).abs().max())
                  for k in part if not torch.equal(cut[k], part[k])}
        if differ:
            raise RuntimeError(f"{label}: the {key} call on the {wy}x{wx} window differs "
                               f"from the block's on those columns: max|d| {differ}")
        written[key] = sorted(k for k in whole if whole[k] is not sim.state[k])
        del whole, part, cut
        torch.cuda.empty_cache()
    return written


def _restart_round_trip(sim, label):
    """A restart at the end of the window written and timed, read into a
    fresh `Simulation`, one step in each: the two states bit for bit equal
    in every field.  Returns the numbers."""
    import os
    import shutil
    import tempfile
    from wrfchem_arc_interactions_tpu_torch.io import history as hio
    from wrfchem_arc_interactions_tpu_torch.io import netcdf as ncio
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import restart_names
    if not ncio.available():
        raise RuntimeError(f"{label}: the native netCDF backend did not build: "
                           f"{ncio.unavailable_reason()}")
    cfg = sim.cfg
    names = set(restart_names(cfg))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/restart_{sim.step_idx:06d}.nc"
        free = shutil.disk_usage(tmp).free
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hio.write_restart(path, cfg, sim.state, sim.step_idx, sim.time_s)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        # the fields outside the restart set keep the template's values:
        # copies, so that the two runs share no tensor
        template = {k: v if k in names else v.clone() for k, v in sim.state.items()}
        t0 = time.perf_counter()
        restored, step, t_s = hio.read_restart(path, cfg, template)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    if (step, t_s) != (sim.step_idx, sim.time_s):
        raise RuntimeError(f"{label}: restart at step {step}, time {t_s}; expected "
                           f"{sim.step_idx}, {sim.time_s}")
    fresh = Simulation(cfg, sim.grid, restored, device=sim.device)
    fresh.step_idx, fresh.time_s = step, t_s
    del template, restored
    for s in (sim, fresh):
        s.advance(1)
    sim.sync()
    differ = [k for k in sim.state if not torch.equal(sim.state[k], fresh.state[k])]
    if set(sim.state) != set(fresh.state) or differ:
        raise RuntimeError(f"{label}: one step after the restart differs from the unbroken "
                           f"run in {len(differ)} fields {differ[:8]}")
    return {"bytes": size, "write_s": write_s, "read_s": read_s, "fields": len(names),
            "fields_compared": len(sim.state), "disk_free_bytes": free}


def config5_block_rank(rank, device, card):
    """`config5_block_phase` in a process of its own (one rank of
    `parallel.launch.spawn`), which `main` starts with the allocator's
    expandable segments: the block's step allocates and frees tensors of
    0.1-7 GB, whose freed pieces in fixed segments serve the next sizes
    badly (alone in its process with the default allocator the block
    peaked at 77.8 GiB reserved of 79.2; beside the script's process, which
    holds its context and its earlier paths' tensors, there is less room).
    The earlier paths keep the default allocator."""
    return config5_block_phase(torch.device(device), card)


# the caching allocator's counters that a stall can come from: an
# allocation that failed, freed the cached blocks (a device
# synchronisation) and retried; the device allocations and frees
ALLOCATOR_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                    "num_sync_all_streams")


def _allocator_counts(before, after) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in ALLOCATOR_COUNTS}


def config5_block_phase(dev, card, steps=WINDOW12, shape=CONFIG5_BLOCK, window=WIDTH12):
    """Slice 12's main path: one card's block of BASELINE config 5, config
    4's package (`_cfg4`) at 500x500x60 from noon UTC through `Simulation`:
    the case's build time, 2 warm-up steps (both alarms ring at step 0),
    a 20-step window (chem calls at steps 10 and 20) with its exact
    launches, peak memory and config 4's physical checks; each executable's
    synchronised time and peak above what it finds; profiles of one main
    step and one chem call; the four kernels on the path's own inputs,
    each timed alone beside its bound (`dycore_on_path`, `chem_on_path`,
    the plain versions over slices of the tracers and passes of the
    cells); the chem and rad calls on an
    interior window against the block (`_width_check`); a restart round
    trip (`_restart_round_trip`).  Returns (the window's launches, the
    numbers)."""
    from wrfchem_arc_interactions_tpu_torch.chem.driver import row_blocks
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    label = "config 5's block"
    cfg = _cfg4(*shape, start_date="2000-06-20_12:00:00")
    d = cfg.domain
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    state = _seed4(state)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sim = Simulation(cfg, grid, state, device=dev)
    del grid, state
    nt = len(advected_names(cfg))
    state_bytes = sum(v.numel() * v.element_size() for v in sim.state.values())
    print(f"case squall2d_x {d.nx}x{d.ny}x{d.nz} (config 4's package, {len(sim.state)} "
          f"fields, {nt} advected scalars, {state_bytes / 2**30:.3f} GiB of state) built in "
          f"{build_s:.2f} s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if not (nt == 107 and sim.rad_every == 100 and sim.chem_every == 10):
        raise RuntimeError(f"{label}: {nt} scalars, rad every {sim.rad_every}, chem every "
                           f"{sim.chem_every}; expected 107, 100, 10")
    t0 = time.perf_counter()
    sim.advance(2)                  # warm-up: both alarms ring at step 0
    sim.sync()
    warm_s = time.perf_counter() - t0
    _reset_counts()
    alloc0 = torch.cuda.memory_stats(dev)
    t0 = time.perf_counter()
    sim.advance(steps)              # steps 2..21: chem at 10 and 20
    sim.sync()
    wall = time.perf_counter() - t0
    launches = _counts()
    alloc = _allocator_counts(alloc0, torch.cuda.memory_stats(dev))
    peak_window = torch.cuda.max_memory_allocated(dev)
    peak_reserved = torch.cuda.max_memory_reserved(dev)
    n_chem = sum(1 for n in range(2, 2 + steps) if n % sim.chem_every == 0)
    # a chem call runs in blocks of rows, each launching the Mie kernel
    # once per bin and the ROS2 kernel once
    blocks = len(row_blocks(d.ny, d.nx, d.nz))
    want = {"advect_scalar_5_3": 3 * steps, "advect_tracers": _tracer_grids_per_step() * steps,
            "mie_cheb_eval": 4 * blocks * n_chem, "ros2_integrate": blocks * n_chem}
    if launches != want:
        raise RuntimeError(f"{label}: kernel launches in the {steps}-step window {launches}, "
                           f"expected {want}")
    w_max, o3, olr, n_cloudy, with_nc = _arc_checks(sim.state, label, steps + 2)
    ms_step = wall / steps * 1e3
    print(f"slice 12 ({label}): {steps} steps of {d.nx}x{d.ny}x{d.nz} after 2 warm-up steps "
          f"({warm_s:.2f} s, one rad and one chem call), {n_chem} chem calls in the window, "
          f"each in {blocks} blocks of rows: "
          f"{ms_step:.3f} ms/step, {d.nx * d.ny * d.nz / (wall / steps) / 1e6:.4f} M "
          f"gridpoints/s, peak memory since the case {peak_window / 2**30:.3f} GiB "
          f"allocated, {peak_reserved / 2**30:.3f} GiB reserved [{card}]; "
          f"max w {w_max:.3f} m/s, cloudy cells {n_cloudy} ({with_nc} with droplets), O3 "
          f"{o3[0]:.5f}-{o3[1]:.5f} ppmv, OLR {olr[0]:.1f}-{olr[1]:.1f} W m-2, tau_aer_sw "
          f"{float(sim.state['tau_aer_sw'].min()):.4g}-"
          f"{float(sim.state['tau_aer_sw'].max()):.4g}; kernel launches {launches}")

    t_now = np.float32(sim.time_s)
    execs = {}
    for key in ("main", "rad", "chem"):
        fn = sim._stepper(key)
        ms, peak = _executable(lambda: fn(sim.state, sim.grid, t_now), dev)
        execs[key] = {"ms": ms, "peak_above_bytes": peak}
    held = torch.cuda.memory_allocated(dev)
    print(f"{label}, one synchronised call of each executable (time, peak above the "
          f"{held / 2**30:.3f} GiB held before it): " + ", ".join(
              f"{k} {v['ms']:.1f} ms, {v['peak_above_bytes'] / 2**30:.3f} GiB"
              for k, v in execs.items()))
    print(f"{label}: the caching allocator over the window {alloc} [{card}]")
    main, chem = sim._stepper("main"), sim._stepper("chem")
    dev_main, n_main, rows_main = _profile(lambda: main(sim.state, sim.grid, t_now))
    dev_chem, n_chem_k, rows_chem = _profile(lambda: chem(sim.state, sim.grid, t_now))
    busy = 100.0 * (dev_main + dev_chem / sim.chem_every) / ms_step
    print(f"profile of one main step of {label}: device busy {dev_main:.3f} ms in {n_main} "
          f"kernels; of one chem call {dev_chem:.3f} ms in {n_chem_k} kernels; against the "
          f"unprofiled {ms_step:.3f} ms/step the device is busy {busy:.1f}% (main step + a "
          f"tenth of a chem call); advect_tracers grids: {_tracer_grids_us(rows_main)}")
    for what, rows in (("main step", rows_main), ("chem call", rows_chem)):
        for t_us, count, key in rows[:8]:
            print(f"  {what} {t_us / 1e3:9.3f} ms  {count:7d} x  {key[:90]}")
    torch.cuda.empty_cache()
    dycore = dycore_on_path(lambda: main(sim.state, sim.grid, t_now), label, card,
                            tracer_slice=TRACER_SLICE12)
    if dycore["calls"] != {"advect_scalar_5_3": 3, "advect_tracers": 3}:
        raise RuntimeError(f"{label}: {dycore['calls']} kernel calls in one main step, "
                           "expected 3 and 3")
    chem_k = chem_on_path(lambda: chem(sim.state, sim.grid, t_now), label, card,
                          ros2_chunk=ROS2_CHUNK12)
    if len(chem_k["mie_bins"]) != 4 * blocks or len(chem_k["ros2"]) != blocks:
        raise RuntimeError(f"{label}: {len(chem_k['mie_bins'])} Mie and "
                           f"{len(chem_k['ros2'])} gas integrations in one chem call, "
                           f"expected {4 * blocks} and {blocks}")
    written = _width_check(sim, t_now, window, label)
    y0, x0, wy, wx = window
    print(f"{label}: the chem call ({len(written['chem'])} fields written) and the rad call "
          f"({len(written['rad'])}) on the {wy}x{wx} window at ({y0}, {x0}) equal the "
          f"block's on those columns bit for bit")
    restart = _restart_round_trip(sim, label)
    print(f"{label}: restart of {restart['bytes'] / 2**30:.3f} GiB ({restart['fields']} "
          f"fields) written in {restart['write_s']:.2f} s and read in {restart['read_s']:.2f} "
          f"s ({restart['disk_free_bytes'] / 2**30:.1f} GiB free where it was written); one "
          f"step after it equals the unbroken run bit for bit in all "
          f"{restart['fields_compared']} fields [{card}]")
    numbers = {"shape": [d.nx, d.ny, d.nz], "scalars": nt, "state_bytes": state_bytes,
               "chem_row_blocks": blocks,
               "case_build_s": build_s, "window_steps": steps, "ms_step": ms_step,
               "peak_memory_bytes": peak_window, "peak_reserved_bytes": peak_reserved,
               "executables": execs, "allocator_window": alloc,
               "held_bytes": held, "device_ms": {"main": dev_main, "chem": dev_chem},
               "kernels_per_call": {"main": n_main, "chem": n_chem_k}, "busy_pct": busy,
               "profile_main": [[t / 1e3, n, k[:90]] for t, n, k in rows_main[:12]],
               "profile_chem": [[t / 1e3, n, k[:90]] for t, n, k in rows_chem[:12]],
               "dycore_on_path": dycore, "chem_on_path": chem_k,
               "width_window": list(window),
               "width_fields_written": {k: len(v) for k, v in written.items()},
               "restart": restart,
               "launches": launches}
    del sim
    return launches, numbers


SQUALL_MOIST = ("qv", "qc", "qr")


def item12_card_checks(dev, card):
    """The reference's slow-marked tests/test_squall_line.py on the card,
    with its assertions: 30 min of the 2D squall line at 60x4x24 (cloud,
    rain, bounded updrafts, positive moisture, the water budget closed to
    5e-3, theta_e bounded) and 600 s of the quarter_ss supercell at
    32x32x20 (finite, updraft above 1 m/s); both with the NaN check."""
    from wrfchem_arc_interactions_tpu_torch.config import (
        Config, DomainConfig, DynamicsConfig, TimeControl,
    )
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    cfg = Config(domain=DomainConfig(nx=60, ny=4, nz=24, dx=1000.0, dy=1000.0,
                                     ztop=17000.0, p_top=8000.0),
                 time_control=TimeControl(dt=6.0), dynamics=DynamicsConfig(kvdif=30.0))
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, state, check_nans=True, device=dev)
    mub = grid.mub.double().cpu().numpy()
    dnw = grid.dnw.double().cpu().numpy().reshape(-1, 1, 1)

    def total_water():
        s = {k: sim.state[k].double().cpu().numpy() for k in SQUALL_MOIST + ("mu", "rainnc")}
        col = -np.sum(dnw * sum(s[n] for n in SQUALL_MOIST), axis=0) * (mub + s["mu"]) / 9.81
        return float(col.sum() + s["rainnc"].sum())

    w0 = total_water()
    t0 = time.perf_counter()
    sim.run_seconds(1800.0)
    wall = time.perf_counter() - t0
    s = {k: v.cpu().numpy() for k, v in sim.state.items()}
    w_max, qc_max, rain = float(s["w"].max()), float(s["qc"].max()), float(s["rainnc"].max())
    drift = abs(total_water() - w0) / w0
    pb = grid.pb.cpu().numpy()[:17]
    th = s["t"][:17] + 300.0
    t_abs = th * (pb / 1e5) ** 0.2857
    th_e = th * np.exp(2.5e6 * s["qv"][:17] / (1004.0 * np.maximum(t_abs, 150.0)))
    fails = [msg for ok, msg in (
        (np.isfinite(s["w"]).all(), "non-finite w"),
        (1.0 < w_max < 60.0, f"w_max {w_max}"),
        (qc_max > 1e-4, f"qc_max {qc_max}"),
        (rain > 1.0, f"no rain after 30 min ({rain})"),
        (all(s[q].min() >= 0.0 for q in SQUALL_MOIST), "negative moisture"),
        (drift < 5e-3, f"water budget drift {drift:.3g}"),
        (th_e.max() < 360.0, f"theta_e pumped to {th_e.max():.1f}")) if not ok]
    if fails:
        raise RuntimeError(f"squall line on the card: {fails}")
    print(f"item 12, tests/test_squall_line.py on the card: the 2D squall line at 60x4x24, "
          f"1800 s in {sim.step_idx} steps ({wall:.1f} s): max w {w_max:.3f} m/s, max qc "
          f"{qc_max:.3e}, max rainnc {rain:.3f}, water budget drift {drift:.3g} (< 5e-3), "
          f"max theta_e {th_e.max():.1f} K [{card}]")
    cfg = Config(domain=DomainConfig(nx=32, ny=32, nz=20, dx=2000.0, dy=2000.0,
                                     ztop=16000.0, p_top=10000.0),
                 time_control=TimeControl(dt=10.0), dynamics=DynamicsConfig(kvdif=30.0))
    grid, state = ideal.make_case(cfg, "quarter_ss", device=dev, bubble_amp=3.0)
    sim = Simulation(cfg, grid, state, check_nans=True, device=dev)
    sim.run_seconds(600.0)
    w = sim.state["w"]
    ss_w_max = float(w.max())
    if not (bool(torch.isfinite(w).all()) and ss_w_max > 1.0):
        raise RuntimeError(f"quarter_ss on the card: max w {ss_w_max}")
    print(f"item 12, the quarter_ss supercell at 32x32x20 on the card: 600 s in "
          f"{sim.step_idx} steps, finite, max w {ss_w_max:.3f} m/s (> 1) [{card}]")
    return {"squall_drift": drift, "squall_w_max": w_max, "quarter_ss_w_max": ss_w_max}


def mxu_card_check(dev, card, nt=4, shape=(50, 100, 100)):
    """Item 11 on the card: `ops/mxu_adv.py::scalar_fluxes_mxu` (library
    products, full float32) against the stencil fluxes on the same seeded
    padded inputs, orders 5/3, 3/3 and upwind, a batch of `nt` tracers,
    within 1e-6 of each flux's magnitude; and the products' precision
    setting."""
    from wrfchem_arc_interactions_tpu_torch.dycore import advection
    from wrfchem_arc_interactions_tpu_torch.ops import mxu_adv
    nz, ny, nx = shape
    rng = np.random.default_rng(11)
    q = torch.from_numpy((rng.normal(size=(nt, nz, ny + 6, nx + 6)) + 3.0)
                         .astype(np.float32)).to(dev)
    ru, rv = (torch.from_numpy(rng.normal(size=(nz, ny + 6, nx + 6)).astype(np.float32))
              .to(dev) for _ in "uv")
    ww = rng.normal(size=(nz + 1, ny, nx)).astype(np.float32)
    ww[0] = ww[-1] = 0.0
    ww = torch.from_numpy(ww).to(dev)
    precision = torch.get_float32_matmul_precision()
    worst = {}
    for h, v in ((5, 3), (3, 3), (1, 1)):
        mxu = mxu_adv.scalar_fluxes_mxu(q, ru, rv, ww, h, v)
        ref = advection.scalar_fluxes(q, ru, rv, ww, h, v)
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(mxu, ref))
        worst[f"{h}/{v}"] = rel
        if not rel <= 1e-6:
            raise RuntimeError(f"scalar_fluxes_mxu ({h}, {v}) on the card: {rel:.3g} of the "
                               "fluxes' magnitude from the stencil fluxes (limit 1e-6)")
    ms = _wall_ms(lambda: mxu_adv.scalar_fluxes_mxu(q, ru, rv, ww, 5, 3))
    ms_stencil = _wall_ms(lambda: advection.scalar_fluxes(q, ru, rv, ww, 5, 3))
    print(f"item 11, scalar_fluxes_mxu on the card at ({nt}, {nz}, {ny}, {nx}) against the "
          f"stencil fluxes: max relative difference "
          + ", ".join(f"{k} {e:.3g}" for k, e in worst.items())
          + f" (limit 1e-6); float32 matmul precision '{precision}' outside, 'highest' "
          f"inside; synchronised {ms:.3f} ms per call at 5/3, the stencil {ms_stencil:.3f} "
          f"ms [{card}]")
    return {"max_rel": worst, "matmul_precision": precision, "ms": ms,
            "stencil_ms": ms_stencil}


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
    from wrfchem_arc_interactions_tpu_torch.parallel import launch

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
    # slice 9's shapes and map factor (100x100x50, the Lambert projection at
    # 40N): the dycore kernels' entries are timed with m2, as slice 9's path
    # calls them; the flat path beside them
    grid9 = _projected9(grid)
    adv_flat = kernel_adv(dev, grid.rdnw, grid.rdx, grid.rdy, d.nz, d.ny, d.nx)
    entries = {
        "advect_scalar_5_3": kernel_adv(dev, grid.rdnw, grid.rdx, grid.rdy, d.nz, d.ny, d.nx,
                                        m2=(grid9.msft * grid9.msft).contiguous()),
        "mie_cheb_eval": kernel_mie(dev, d.nz, d.ny, d.nx),
    }
    entries["advect_scalar_5_3"]["flat"] = {
        k: adv_flat[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    modes_nt47 = kernel_tracers(dev, grid, nt=47)
    torch.cuda.empty_cache()
    modes_nt107 = kernel_tracers(dev, grid, nt=107)
    torch.cuda.empty_cache()
    modes_nt107_m2 = kernel_tracers(dev, grid9, nt=107)
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
    launches4, mie_path, ms_step4 = slice4_phase(dev, card, args.steps)
    entries["mie_cheb_eval"]["config4_inputs"] = mie_path
    torch.cuda.empty_cache()
    launches8, numbers8 = slice8_phase(dev, card, ms_step4, args.steps)
    torch.cuda.empty_cache()
    cross_check(dev, _cfg4(nx=32, ny=8, nz=20, chem_s=6.0, rad_s=6.0,
                           start_date="2000-06-20_12:00:00"), _seed4, "config 4")
    torch.cuda.empty_cache()
    launches6, numbers6 = slice6_phase(dev, card, args.steps)
    entries["mie_cheb_eval"]["slice6_inputs"] = numbers6.pop("mie_by_bin")
    entries["advect_tracers"] = tracers_entry(modes_nt107_m2,
                                              {"modes_nt219": numbers6.pop("tracers_modes"),
                                               "modes_nt107_flat": modes_nt107,
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
    launches9, numbers9 = slice9_phase(dev, card, args.steps)
    torch.cuda.empty_cache()
    item9_cross_checks(dev)
    torch.cuda.empty_cache()
    modes_wide, launches_wide, mie_wide = wide_phase(dev, card)
    torch.cuda.empty_cache()
    entries["advect_tracers"]["seam_50x50_nt107"] = kernel_tracers_seams(dev, card)
    torch.cuda.empty_cache()
    launches10, numbers10 = slice10_phase(dev, card)
    numbers10["nccl_1x2"] = nccl_phase(dev)
    torch.cuda.empty_cache()
    launches11, numbers11 = slice11_phase(dev, card)
    torch.cuda.empty_cache()
    # config 5's block in a process of its own, with expandable segments
    # (`config5_block_rank`): the child takes the environment at its start
    sys.stdout.flush()
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        launches12, numbers12 = launch.spawn(config5_block_rank, 1, "gloo", ["cuda:0"],
                                             args=(card,), timeout_s=900.0)[0]
    finally:
        del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    for name, n in numbers12["dycore_on_path"]["calls"].items():
        ON_PATH[name]["config 5's block"] = n
    torch.cuda.empty_cache()
    numbers_items = {"item12": item12_card_checks(dev, card), "item11": mxu_card_check(dev, card)}
    entries["advect_tracers"]["modes_nt47_1000_wide"] = modes_wide
    entries["advect_tracers"]["max_abs_err"] = max(
        entries["advect_tracers"]["max_abs_err"], *(m["max_abs_err"] for m in modes_wide.values()))
    entries["mie_cheb_eval"]["config3_1000x100_inputs"] = mie_wide
    entries["mie_cheb_eval"]["max_abs_err"] = max(
        entries["mie_cheb_eval"]["max_abs_err"],
        *(b["max_abs_err"] for path in ("config4_inputs", "slice6_inputs",
                                        "config3_1000x100_inputs")
          for b in entries["mie_cheb_eval"][path]))
    for name, key in (("mie_cheb_eval", "mie_max_abs_err"),
                      ("ros2_integrate", "ros2_max_abs_err")):
        for label, numbers in (("slice10", numbers10), ("slice11", numbers11)):
            entries[name][f"{label}_on_path_max_abs_err"] = max(
                r["on_path"][key] for r in numbers["ranks"])
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                               entries[name][f"{label}_on_path_max_abs_err"])
    c5d, c5c = numbers12["dycore_on_path"], numbers12["chem_on_path"]
    entries["advect_scalar_5_3"]["config5_block"] = c5d["advect_scalar_5_3"]
    entries["advect_tracers"]["config5_block"] = {m: c5d[m] for m in ("no_limiter", "pd_clip")}
    entries["mie_cheb_eval"]["config5_block"] = c5c["mie_bins"]
    entries["ros2_integrate"]["config5_block"] = c5c["ros2"]
    entries["mie_cheb_eval"]["max_abs_err"] = max(entries["mie_cheb_eval"]["max_abs_err"],
                                                  *(b["max_abs_err"] for b in c5c["mie_bins"]))
    entries["ros2_integrate"]["max_abs_err"] = max(entries["ros2_integrate"]["max_abs_err"],
                                                   *(r["max_abs_err"] for r in c5c["ros2"]))
    for name, by_path in ON_PATH.items():
        entries[name]["bitwise_on_path_calls"] = by_path
    # "launches" is the count of this slice's main path, the window of
    # config 5's per-card block, which runs all four kernels; the earlier
    # paths' counts stand beside it
    for name, entry in entries.items():
        entry["launches"] = launches12[name]
        entry["launches_by_path"] = {"config5_block_window": launches12[name],
                                     "slice11_window_4_ranks": launches11[name],
                                     "slice11_window_by_rank_and_domain": [
                                         {w: r["launches"][w][name] for w in r["launches"]}
                                         for r in numbers11["ranks"]],
                                     "slice10_window_4_ranks": launches10[name],
                                     "slice10_window_by_rank": [
                                         r["launches"][name] for r in numbers10["ranks"]],
                                     "slice9_window": launches9[name],
                                     "slice8_window": launches8[name],
                                     "slice7_window": launches7[name],
                                     "slice6_window": launches6[name],
                                     "config4_window": launches4[name],
                                     "config3_window": launches3[name],
                                     "slice1_10_steps": launches1[name],
                                     "config3_1000x100_3_steps": launches_wide[name]}
        if (launches12[name] < 1 or launches9[name] < 1
                or min(entry["launches_by_path"]["slice10_window_by_rank"]) < 1
                or min(min(d.values()) for d in
                       entry["launches_by_path"]["slice11_window_by_rank_and_domain"]) < 1):
            raise RuntimeError(f"{name} was not launched on config 5's block, on slice 9's "
                               "path, on every rank of slice 10's or on both domains of "
                               "every rank of slice 11's")
    print(json.dumps({"slice6": numbers6, "slice7": numbers7, "slice8": numbers8,
                      "slice9": numbers9, "slice10": numbers10, "slice11": numbers11,
                      **numbers_items}))
    print(json.dumps({"config5_block": numbers12}))
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [_without_plans(e) for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
