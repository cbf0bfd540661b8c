"""Halo padding on a single device (port of the single-device branch of
the JAX package's `parallel/halo.py`).

On one device the halos are physical boundary conditions: periodic wraps
(``circular``), open replicates the edge (``replicate``), symmetric
reflects without repeating the edge (``reflect``, which is what ``jnp.pad``'s
``reflect`` does too).  A specified boundary replicates the edge like an
open one: its outermost rows are set to the boundary data after each step
(`models.lateral_bc`), so the halo beyond them only needs a consistent
extrapolation.  The X axis is padded first, then Y, as in the
reference; each mode is a separable index map, so the corners agree.
Decomposition over several GPUs comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind

_MODES = {BCKind.PERIODIC: "circular", BCKind.OPEN: "replicate",
          BCKind.SYMMETRIC: "reflect", BCKind.SPECIFIED: "replicate"}


@dataclasses.dataclass(frozen=True)
class HaloOps:
    """Boundary/halo context threaded through the dycore (single device)."""

    bc_x: BCKind = BCKind.PERIODIC
    bc_y: BCKind = BCKind.PERIODIC

    def pad(self, a: torch.Tensor, width: int = 3) -> torch.Tensor:
        """Pad the trailing (y, x) axes by `width` halo cells."""
        shape = a.shape
        a4 = a.reshape(-1, 1, shape[-2], shape[-1])
        a4 = F.pad(a4, (width, width, 0, 0), mode=_MODES[self.bc_x])
        a4 = F.pad(a4, (0, 0, width, width), mode=_MODES[self.bc_y])
        return a4.reshape(shape[:-2] + a4.shape[-2:])

    def pad_many(self, fields: Dict[str, torch.Tensor],
                 width: int = 3) -> Dict[str, torch.Tensor]:
        """Pad every field (the reference stacks same-shaped fields into one
        exchange; on one device there is no exchange to fuse)."""
        return {name: self.pad(a, width) for name, a in fields.items()}

    # global reductions (diagnostics, CFL guards): on one device the local
    # value is the global one; a device mesh makes them collectives
    def psum(self, x):
        return x

    def pmax(self, x):
        return x


def overlap_stencil(hx: HaloOps, fields: Dict[str, torch.Tensor], width: int,
                    fn: Callable, consts: Optional[Dict[str, torch.Tensor]] = None):
    """Evaluate a plus-shaped stencil ``fn(padded_fields, consts)``.  On one
    device there is no exchange to overlap, so this is one padded call (the
    reference's degenerate branch)."""
    return fn(hx.pad_many(fields, width), consts or {})
