"""Auxiliary input streams — emission files (port of the JAX package's
`io/auxinput.py`, the wrfchemi_* / auxinput5 analog).

An emission stream is a time-ordered list of files (native netCDF classic
or npz), each holding 2D surface-flux fields named after the chem species
(plus optional ``elev_*`` elevated sources and ``heat_mw`` for plume rise).
`EmissionStream.at_time` returns the snapshot valid at a model time, held
piecewise constant between file times (hourly wrfchemi semantics).
`models.driver.Simulation` moves every snapshot to the device once, when
it is built, and picks one per chem call by `EmissionStream.index_at`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from wrfchem_arc_interactions_tpu_torch.io import netcdf as ncio


def write_emissions(path: str, fields: Dict[str, np.ndarray],
                    time_s: float) -> None:
    """Write one emission snapshot (a wrfchemi_* file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".nc"):
        w = ncio.NetCDFWriter()
        for k, v in fields.items():
            w.put_var(k, np.asarray(v, np.float32))
        w.put_att("_time_s", float(time_s))
        w.write(path, async_write=False)
    else:
        data = {k: np.asarray(v, np.float32) for k, v in fields.items()}
        data["_time_s"] = np.float64(time_s)
        np.savez(path, **data)


def read_emissions(path: str) -> Tuple[Dict[str, np.ndarray], float]:
    if path.endswith(".nc"):
        f, attrs = ncio.read_netcdf(path)
        return dict(f), float(attrs["_time_s"])
    with np.load(path) as z:
        f = {k: z[k] for k in z.files}
    return f, float(f.pop("_time_s"))


@dataclasses.dataclass
class EmissionStream:
    """Piecewise-constant-in-time emission forcing from files."""

    times: List[float]
    snaps: List[Dict[str, np.ndarray]]

    @classmethod
    def from_files(cls, paths: Sequence[str]) -> "EmissionStream":
        pairs = sorted((read_emissions(p) for p in paths), key=lambda x: x[1])
        return cls(times=[t for _, t in pairs], snaps=[f for f, _ in pairs])

    def index_at(self, time_s: float) -> int:
        """Index of the snapshot valid at `time_s`: the last file at or
        before it; the first file before the stream starts."""
        idx = int(np.searchsorted(np.asarray(self.times), time_s, side="right")) - 1
        return max(idx, 0)

    def at_time(self, time_s: float) -> Dict[str, np.ndarray]:
        """The snapshot valid at `time_s`."""
        return self.snaps[self.index_at(time_s)]
