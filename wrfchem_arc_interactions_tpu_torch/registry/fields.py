"""Declarative field-spec table — the WRF Registry equivalent (port of the
JAX package's `registry/fields.py`).

Only the table of the configurations this slice runs is ported: the
dynamical core state, the moist scalars and the two surface fields that
every configuration carries.  The chemistry, radiation, PBL, land-surface
and stochastic-physics entries come with their slices; a configuration that
needs them is refused by `utils.support.check_config` before any table is
built.

Layout: 3D fields are (z, y, x); "zs" is the staggered vertical axis of
length nz+1 (w levels).  Horizontal staggering does not change array sizes:
u[k, j, i] lives at the west face of mass cell i, v[k, j, i] at the south
face of cell j.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.utils.support import check_config

DIMS_ZYX = ("z", "y", "x")
DIMS_ZSYX = ("zs", "y", "x")
DIMS_YX = ("y", "x")

STAG_NONE = ""
STAG_X = "x"    # x-face point (u)
STAG_Y = "y"    # y-face point (v)
STAG_Z = "z"    # w-level point (w, ph)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    dims: Tuple[str, ...]
    stagger: str = STAG_NONE
    units: str = ""
    description: str = ""
    halo: int = 0            # halo width this field needs
    restart: bool = False    # Registry `r` flag
    history: bool = False    # Registry `h` flag
    advected: bool = False   # member of the scalar-advection set
    positive: bool = False   # PD limiter applies

    def shape(self, nz: int, ny: int, nx: int) -> Tuple[int, ...]:
        sizes = {"z": nz, "zs": nz + 1, "y": ny, "x": nx}
        return tuple(sizes[d] for d in self.dims)


def _dyn_fields() -> Tuple[FieldSpec, ...]:
    return (
        FieldSpec("u", DIMS_ZYX, STAG_X, "m s-1", "x-wind at west faces",
                  halo=3, restart=True, history=True),
        FieldSpec("v", DIMS_ZYX, STAG_Y, "m s-1", "y-wind at south faces",
                  halo=3, restart=True, history=True),
        FieldSpec("w", DIMS_ZSYX, STAG_Z, "m s-1", "z-wind at w-levels",
                  halo=2, restart=True, history=True),
        FieldSpec("ph", DIMS_ZSYX, STAG_Z, "m2 s-2",
                  "perturbation geopotential at w-levels",
                  halo=2, restart=True, history=True),
        FieldSpec("t", DIMS_ZYX, STAG_NONE, "K",
                  "perturbation potential temperature (theta - T0)",
                  halo=3, restart=True, history=True),
        FieldSpec("mu", DIMS_YX, STAG_NONE, "Pa",
                  "perturbation dry-air column mass",
                  halo=3, restart=True, history=True),
    )


def _moist_fields(cfg: Config) -> Tuple[FieldSpec, ...]:
    return tuple(
        FieldSpec(q, DIMS_ZYX, STAG_NONE,
                  "kg kg-1" if q.startswith("q") else "kg-1",
                  f"moist scalar {q} (mixing ratio / specific number)",
                  halo=3, restart=True, history=True, advected=True, positive=True)
        for q in cfg.moist_species()
    )


def _phys_fields() -> Tuple[FieldSpec, ...]:
    return (
        FieldSpec("tsk", DIMS_YX, STAG_NONE, "K", "surface skin temperature",
                  restart=True, history=True),
        FieldSpec("rainnc", DIMS_YX, STAG_NONE, "mm",
                  "accumulated grid-scale precipitation", restart=True, history=True),
    )


def field_table(cfg: Config) -> Tuple[FieldSpec, ...]:
    """The state table for this configuration (raises for configurations
    whose extra fields belong to a later slice)."""
    check_config(cfg)
    return _dyn_fields() + _moist_fields(cfg) + _phys_fields()
