"""What the port carries so far, and which slice brings the rest.

The port goes slice by slice (ROADMAP.md, Queue 1).  It carries every
physics and dycore option of the reference on a single device over an
ideal flat grid: the dycore with every advection order (WENO5 included),
the positive-definite and monotonic limiters, Smagorinsky or 1.5-order TKE
diffusion with the 6th-order filter, SPPT and SKEBS; Kessler, WSM6 and
Morrison microphysics with aerosol activation; the YSU and MYNN boundary
layers over the slab surface or the Noah land surface; BMJ, KF and Grell
cumulus; RRTMG or the simple radiation; the whole chem driver for every
package; and the run infrastructure (history, restart, auxhist, tslist,
the NaN guard, the emission stream); and real data and nesting: terrain,
map projections, specified lateral boundaries, the real.exe and WPS path,
analysis nudging, the polar filter, nests and ndown; and the domain
decomposition over a process mesh (`parallel`).  What is outside these
(a nest on a process mesh) raises `NotImplementedError` naming the slice
that brings it, so that nothing runs silently with a piece missing.
"""

from __future__ import annotations

from wrfchem_arc_interactions_tpu_torch.config import Config

SLICE_MESH = "a later slice (ROADMAP Queue 1 item 10b, sharded nests)"


def unported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with {where}")


def check_config(cfg: Config) -> None:
    """Raise `NotImplementedError` for any option the port does not carry."""
    if cfg.chem.aer_op_opt != 1:
        raise NotImplementedError(
            f"aer_op_opt={cfg.chem.aer_op_opt}: the reference reads this option nowhere "
            "and always mixes by volume (option 1); the port refuses other values "
            "rather than ignore them")

