"""The benchmark's files, found by name.

Everything that belongs to one cell, one configuration or one per-layer
metric sits in files of its own; this module finds them from the names in
`BENCHMARK.json`, so that a later change adds a cell, a configuration or a
metric by adding files and entries, and edits no code:

- ``configs/<config>.json``: the namelist (its ``parallel`` group, where
  there is one, is the cell's mesh of cards: `mesh_shape`), the ideal
  case, the seeded fields, the allocator setting, and what was cut from
  the deployment;
- ``traffic/<traffic>.json``: the traffic mix: the warm-up, the alarm
  period, the steps the check follows, the seeded perturbation;
- ``limits/<cell>.json``: the limit of each number the check compares in
  the cell (a configuration under a traffic mix);
- ``metrics/<metric>.py``: a reader ``read(records) -> float | None``.

Only the standard library is imported here: the harness reads the files
before torch starts, since the allocator's setting has to be in the
environment by then.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: dict, name: str, here: str = HERE) -> dict:
    """The cell `name` of `bench`: its entry, with its configuration's file
    under ``config_spec``, its traffic's under ``traffic`` and its limits
    under ``limits``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(entry)
    cell["config_spec"] = config(entry["config"], here)
    cell["traffic"] = _load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    cell["limits"] = _load_json(os.path.join(here, "limits", f"{name}.json"))
    return cell


def mesh_shape(cell: dict) -> Tuple[int, int]:
    """(mesh_y, mesh_x) of the cell's configuration (its ``namelist``'s
    ``parallel`` group, 1 x 1 without one): one block a card, so the mesh
    has to hold exactly the cell's ``chips``."""
    par = cell["config_spec"]["namelist"].get("parallel", {})
    my, mx = int(par.get("mesh_y", 1)), int(par.get("mesh_x", 1))
    if my * mx != cell["chips"]:
        raise ValueError(f"{cell['name']}: the configuration's mesh is {my} x {mx} = "
                         f"{my * mx} blocks, but the cell asks for {cell['chips']} "
                         "card(s): one block a card")
    return my, mx


def config(name: str, here: str = HERE) -> dict:
    spec = _load_json(os.path.join(here, "configs", f"{name}.json"))
    spec["name"] = name
    return spec


def reader(name: str, here: str = HERE) -> Callable[[dict], Optional[float]]:
    """The `read` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: the per-layer ones with
    ``--trace 1``, the end-to-end ones without; a metric with a
    ``workloads`` list only in the cells it names."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(bench: dict, cell: str, trace: bool, records: dict,
                 here: str = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics a run reports; a reader
    that finds nothing to read returns None, and its metric is left out."""
    out = {}
    for m in metrics_for(bench, cell, trace):
        value = reader(m["name"], here)(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
