"""The yardstick's counts: the least bytes and float operations that each of
the port's five kernels needs for a call, the published peaks of the card,
and the least time of a whole model step of a configuration.

Frozen here from the port's `chip_smoke.py` (`_bound`, `_adv_bound`,
`_mie_bound` with `MIE_OPS_PER_ELEMENT`, `_tracers_bound` with
`TRACER_OPS`, the ROS2 bytes of `kernel_ros2`, `_diffusion_bound`) and from
its `utils/device.py` (`PASS_ELEMENTS`, `pass_slices`: the diffusion's
passes) so that a later change to the program cannot change what its
kernels are measured against.  Every count is of what the algorithm needs
for the call's shapes: each input byte read once and each output byte
written once, whatever a kernel reads again.  Times are in seconds.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at its 700 W limit
F32_FLOP_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
F32 = 4                       # bytes of a float32

# float operations per (tracer, cell) of the multi-tracer stage update, each
# face counted once: 3 face fluxes (flux5 20, flux5 20, flux3 16),
# divergence 9, tendency 2, update 3; the limiter adds the low-order fluxes
# (8), two factors (~25 each), the renormalisation (6), phi_td (12), the
# antidiffusive fluxes (3), the limited fluxes (9) and the clip (1)
TRACER_OPS = {False: 70, True: 160}

# float operations per element of the Mie evaluator: 2 scalings, 4 hat
# weights of 4 operations, 4 weight products, the doubling of t, 90
# coefficients of 4 products and 3 sums, 90 Clenshaw steps of 3 and 3
# closing steps of 4
MIE_OPS_PER_ELEMENT = 2 + 16 + 4 + 1 + 90 * 7 + 90 * 3 + 3 * 4
MIE_BANDS = 30                # short-wave and long-wave bands of one evaluation

# the CBM-Z mechanism of the ROS2 solver: species, reactions, and float
# operations of one substep of one cell as the generated kernel counts them
ROS2_SPECIES = 55
ROS2_REACTIONS = 110
ROS2_FLOPS_PER_SUBSTEP = 7499
ROS2_SUBSTEP_S = 30.0         # n_sub = ceil(chemdt / 30 s)

PAD = 3                       # the scalars' halo in the padded stacks

# elements of the largest temporary of one pass of the scalars' diffusion:
# the stack of scalars goes through diffuse_scalars in passes of at most
# this many elements of the state (config 5's 500x500x60 block, 107
# scalars: 6 passes, 5 of 18 and one of 17)
DIFFUSION_PASS_ELEMENTS = 1 << 28


def bound(nbytes: float, ops: float) -> float:
    """Least time [s]: bytes over the HBM rate or float32 operations over
    the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def adv_scalar_bytes_ops(nz: int, ny: int, nx: int):
    """advect_scalar_5_3 on a flat grid: q, ru, rv padded and ww, rdnw read
    once, the tendency written once; ops per face: flux5 20, flux3 16; 9 a
    cell for the divergence."""
    padded = nz * (ny + 2 * PAD) * (nx + 2 * PAD)
    nbytes = F32 * (3 * padded + (nz + 1) * ny * nx + nz + nz * ny * nx)
    ops = (20 * (nz * ny * (nx + 1) + nz * (ny + 1) * nx)
           + 16 * (nz - 1) * ny * nx + 9 * nz * ny * nx)
    return nbytes, ops


def tracers_bytes_ops(nt: int, nz: int, ny: int, nx: int, pd: bool):
    """advect_tracers on a flat grid, one stage of `nt` tracers: q
    (padded), phi_old, pt, ru, rv (padded), ww, mu_full, mu_new, rdnw read
    once, q_new written once."""
    cells = nz * ny * nx
    padded = nz * (ny + 2 * PAD) * (nx + 2 * PAD)
    nbytes = F32 * (nt * padded + 3 * nt * cells + 2 * padded + (nz + 1) * ny * nx
                    + 2 * ny * nx + nz)
    return nbytes, TRACER_OPS[pd] * nt * cells


def mie_bytes_ops(elements: int):
    """mie_cheb_eval: 3 float32 inputs and 3 outputs per element."""
    return 6 * F32 * elements, MIE_OPS_PER_ELEMENT * elements


def ros2_n_sub(chemdt_s: float) -> int:
    """The solver's substeps in a chem call of `chemdt_s` seconds."""
    return max(1, -int(-chemdt_s // ROS2_SUBSTEP_S))


def ros2_bytes_ops(cells: int, n_sub: int):
    """ros2_integrate: conc and the rate constants read once, conc written
    once; the generated program's operations per substep."""
    return (F32 * (2 * ROS2_SPECIES + ROS2_REACTIONS) * cells,
            ROS2_FLOPS_PER_SUBSTEP * n_sub * cells)


def diffusion_bytes_ops(nt: int, nz: int, ny: int, nx: int, vdiff: bool):
    """diffuse_scalars, one pass of `nt` scalars: the padded slice and K
    read once, dz2 once with the vertical term (`vdiff`), the tendency
    written once; ~20 float operations a cell (the K faces 8, the
    Laplacian 11, the vertical term 5)."""
    padded = nz * (ny + 2 * PAD) * (nx + 2 * PAD)
    cells = nz * ny * nx
    nbytes = F32 * ((nt + 1) * padded + (cells if vdiff else 0) + nt * cells)
    return nbytes, (24 if vdiff else 19) * nt * cells


def diffusion_passes(scalars: int, cells: int) -> list:
    """The scalars of each pass of the diffusion's stack: as few passes as
    keep a pass within `DIFFUSION_PASS_ELEMENTS`, of equal length but the
    last."""
    passes = max(1, -(-scalars * cells // DIFFUSION_PASS_ELEMENTS))
    per = -(-scalars // passes)
    return [min(per, scalars - a) for a in range(0, scalars, per)]


def kernel_bounds(shape, scalars: int, bins: int, ros2_n_sub: int, steps: int,
                  chem_calls: int, vdiff: Optional[bool] = None) -> dict:
    """{kernel: least seconds} of the kernels' calls in `steps` main
    steps and `chem_calls` chem calls of a configuration at `shape` (nx,
    ny, nz) with `scalars` advected scalars and `bins` aerosol bins: per
    step three RK stages, each one K1 call (theta) and one K4 call over the
    scalars (the last stage with the positive-definite limiter); per chem
    call one Mie evaluation of every bin, band and cell and, with gas
    chemistry (`ros2_n_sub` substeps, 0 without), one ROS2 integration of
    every cell.  With `vdiff` given (the vertical term on or off), also the
    scalars' diffusion: per step one diffuse_scalars call a pass
    (`diffusion_passes`)."""
    nx, ny, nz = shape
    cells = nx * ny * nz
    out = {
        "advect_scalar_5_3": 3 * steps * bound(*adv_scalar_bytes_ops(nz, ny, nx)),
        "advect_tracers": steps * (2 * bound(*tracers_bytes_ops(scalars, nz, ny, nx, False))
                                   + bound(*tracers_bytes_ops(scalars, nz, ny, nx, True))),
        "mie_cheb_eval": chem_calls * bound(*mie_bytes_ops(bins * MIE_BANDS * cells)),
    }
    if ros2_n_sub:
        out["ros2_integrate"] = chem_calls * bound(*ros2_bytes_ops(cells, ros2_n_sub))
    if vdiff is not None:
        out["diffuse_scalars"] = steps * sum(
            bound(*diffusion_bytes_ops(nt, nz, ny, nx, vdiff))
            for nt in diffusion_passes(scalars, cells))
    return out


def window_least_s(shape, scalars: int, bins: int, ros2_n_sub: int, state_bytes: int,
                   steps: int, chem_calls: int, rad_calls: int) -> float:
    """The least time of a window's work, counted from the configuration
    and the window's alarms and never from the launches observed: the four
    kernels' bounds of PR 17's count (`kernel_bounds` without the
    diffusion, so that the readings stay comparable), the state read and
    written once a main step, and the state read once a rad call."""
    kernels = kernel_bounds(shape, scalars, bins, ros2_n_sub, steps, chem_calls)
    state = state_bytes / HBM_BYTES_PER_S
    return sum(kernels.values()) + steps * 2 * state + rad_calls * state
