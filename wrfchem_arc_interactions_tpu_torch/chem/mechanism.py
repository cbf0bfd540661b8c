"""Mechanism toolchain: KPP-style .eqn files <-> solver tables, through the
native C++ compiler `tools/mechc/mechc.cpp` (the KPP analog; canonical:
chem/KPP's C lex/yacc generator).  The port's own copy of the JAX package's
`chem/mechanism.py`: numpy and the repo's `tools/mechc` only.

Roles:

- ``export_eqn(path)``  — serialize the built-in CBM-Z mechanism
  (chem/gas.py REACTIONS) to a .eqn file, so the mechanism's source of
  truth is reviewable in the reference's notation;
- ``compile_eqn(path)`` — run the native compiler (built on demand with
  g++, hash-cached) producing validated JSON;
- ``tables_from(mech)`` — stoichiometry/rate tables for the generic
  batched Rosenbrock solver from a compiled mechanism — byte-identical to
  the built-in tables for the exported CBM-Z (the round-trip test), and
  the entry point for USER mechanisms: write a .eqn, compile, integrate.
- ``use_tables(order, net, ...)`` — a context manager that points the
  solver (`chem.gas`) at a compiled mechanism's tables.  `gas._kinetics`
  keys its cache on the tables' content and `ops.ros2_kernel.register`
  names the generated CUDA kernel by a hash of the symbolic lists, so a
  compiled mechanism gets its own sparse-LU schedule and its own kernel
  build, and the exported CBM-Z shares the built-in one's.
"""

from __future__ import annotations

import hashlib
import contextlib
import json
import os
import subprocess
from typing import Dict

import numpy as np

from wrfchem_arc_interactions_tpu_torch.chem import gas

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "tools", "mechc",
                                     "mechc.cpp"))


def build_mechc() -> str:
    """Compile the native mechanism compiler (cached on a source hash)."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    exe = os.path.join(os.path.dirname(_SRC), f"mechc_{tag}")
    if not os.path.exists(exe):
        tmp = exe + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O2", "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, exe)
    return exe


def _fmt(x: float) -> str:
    return repr(float(x))


def export_eqn(path: str, species=None, reactions=None) -> None:
    """Write a mechanism in the .eqn notation (defaults: built-in CBM-Z)."""
    species = species or gas.GAS_SPECIES
    reactions = reactions or gas.REACTIONS
    lines = ["! CBM-Z mechanism exported from chem/gas.py",
             "! (KPP-style notation consumed by tools/mechc)", ""]
    row = "#SPECIES"
    for s in species:
        if len(row) + len(s) + 1 > 76:
            lines.append(row)
            row = "#SPECIES"
        row += " " + s
    lines.append(row)
    lines.append("")
    for reacts, prods, spec in reactions:
        lhs = " + ".join(reacts)
        rhs = " + ".join(
            (f"{_fmt(st)} {s}" if st != 1.0 else s)
            for prod in prods if prod for s, st in [prod])
        if spec[0] == "arr":
            rate = f"ARR({_fmt(spec[1])}, {_fmt(spec[2])}, {_fmt(spec[3])})"
        else:
            rate = f"PHOT({spec[1]}, {_fmt(spec[2])})"
        lines.append(f"{lhs} = {rhs} : {rate} ;")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def compile_eqn(path: str) -> Dict:
    """Run the native compiler on a .eqn file -> mechanism dict."""
    exe = build_mechc()
    r = subprocess.run([exe, path], capture_output=True, text=True)
    if r.returncode != 0:
        raise ValueError(f"mechc failed: {r.stderr.strip()}")
    return json.loads(r.stdout)


def tables_from(mech: Dict):
    """(species, order, net, rate_kind, rate_params) for the generic solver
    from a compiled mechanism."""
    species = tuple(mech["species"])
    idx = {s: i for i, s in enumerate(species)}
    reactions = []
    for r in mech["reactions"]:
        prods = tuple((p[0], float(p[1])) for p in r["products"]) or ((),)
        kind = r["rate"][0]
        if kind == "arr":
            spec = ("arr", float(r["rate"][1]), float(r["rate"][2]),
                    float(r["rate"][3]))
        else:
            spec = ("phot", str(r["rate"][1]), float(r["rate"][2]))
        reactions.append((tuple(r["reactants"]), prods, spec))
    order, net, rkind, rparams = gas.build_tables(reactions, idx, len(species))
    return species, order, net, rkind, rparams


@contextlib.contextmanager
def use_tables(order: np.ndarray, net: np.ndarray, rate_kind=None, rate_params=None):
    """Within the block, `chem.gas` integrates the mechanism given by these
    tables (as returned by `tables_from`) instead of the built-in CBM-Z."""
    saved = (gas._ORDER, gas._NET, gas._RKIND, gas._RPARAMS, gas.NS, gas.NR_RXN)
    try:
        gas._ORDER, gas._NET = np.asarray(order), np.asarray(net)
        if rate_kind is not None:
            gas._RKIND, gas._RPARAMS = list(rate_kind), list(rate_params)
        gas.NS, gas.NR_RXN = gas._ORDER.shape
        yield
    finally:
        gas._ORDER, gas._NET, gas._RKIND, gas._RPARAMS, gas.NS, gas.NR_RXN = saved
