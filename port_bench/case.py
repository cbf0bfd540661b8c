"""The inputs that the benchmark makes and hands to both sides: the model
configuration built from a configuration's file, and the seeded
perturbation of the ideal case.

The same functions build the port's configuration (from the port's
`config.namelist`) and the reference's (from its frozen copy), so both run
the same namelist.  The seed changes the inputs and nothing else: the
shapes, the alarms and the sizes of every tensor are the configuration's.
"""

from __future__ import annotations

import dataclasses
import enum
import re

import torch


def build_config(namelist, spec: dict):
    """The `namelist.Config` of a configuration's ``namelist`` groups:
    each group's dataclass built from its keys, an option of an enum type
    from its value (``"morrison2"``)."""
    groups = {}
    for group, values in spec["namelist"].items():
        cls = type(getattr(namelist.Config(), group))
        defaults = {f.name: f.default for f in dataclasses.fields(cls)}
        kw = {}
        for key, value in values.items():
            if key not in defaults:
                raise KeyError(f"{spec['name']}: {group} has no option {key!r}")
            default = defaults[key]
            kw[key] = type(default)(value) if isinstance(default, enum.Enum) else value
        groups[group] = cls(**kw)
    return namelist.Config(**groups)


def aerosol_bins(spec: dict) -> int:
    """The sectional bins of the configuration's chem package (0 without)."""
    m = re.search(r"(\d+)bin", spec["namelist"].get("chem", {}).get("chem_opt", ""))
    return int(m.group(1)) if m else 0


def seeded_state(state: dict, spec: dict, traffic: dict, seed: int) -> dict:
    """The ideal case's state with the configuration's seeded fields set
    (``seed_fields``: uniform values) and the cell's perturbation drawn from
    `seed` on the state's device in a fixed order: theta's perturbation,
    uniform in +-``theta_amp_k``, then each seeded field scaled by a factor
    uniform in 1 +- ``seeded_rel``, cell by cell."""
    state = dict(state)
    t = state["t"]
    gen = torch.Generator(device=t.device)
    gen.manual_seed(int(seed))

    def uniform(amp):
        return (torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype)
                * 2.0 - 1.0) * amp

    state["t"] = t + uniform(traffic["theta_amp_k"])
    for name in sorted(spec["seed_fields"]):
        value = spec["seed_fields"][name]
        state[name] = torch.full_like(t, value) * (1.0 + uniform(traffic["seeded_rel"]))
    return state
