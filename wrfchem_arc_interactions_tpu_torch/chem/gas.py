"""Gas-phase chemistry (port of the JAX package's `chem/gas.py`; canonical:
chem/module_cbmz.F and the KPP-generated Rosenbrock mechanisms).

The mechanism is data: the species list, the reaction table with Arrhenius
and photolysis rates, and the sparse stoichiometry.  One generic solver
consumes it: every grid cell is an independent stiff ODE, integrated with
fixed two-stage Rosenbrock (ROS2) substeps on the KPP-style symbolic sparse
LU of `_SparseKinetics`.

The species list, the reaction table, `J_CLEAR`, `build_tables`,
`_min_degree_perm` and `_SparseKinetics.__init__` are numpy-only and copied
from the reference, so both packages factor the same pattern in the same
order (the tests compare every table item by item).

Two solver paths:

- on a CUDA tensor `integrate` launches the generated Hopper kernel
  (`ops/ros2_kernel.py`), all substeps in one launch;
- on a CPU tensor it runs `_SparseKinetics.step_ros2`, the vectorised index
  form of the same step (one gather / outer product / scatter per pivot, one
  `index_add_` per triangular-solve level), chunked over cells.  This is the
  production CPU path and the oracle held against the reference's XLA path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# Transported gas species (ppmv in chem arrays). Order defines state layout.
GAS_SPECIES: Tuple[str, ...] = (
    # inorganic
    "o3", "no", "no2", "no3", "n2o5", "hno3", "hono", "hno4", "h2o2", "co",
    "so2", "h2so4", "nh3", "hcl", "h2",
    # organic (stable)
    "ch4", "c2h6", "par", "eth", "olet", "olei", "tol", "xyl", "cres",
    "hcho", "ald2", "aone", "mgly", "open", "isop", "isoprd", "onit", "pan",
    "rooh", "ch3ooh", "anol", "ch3oh", "hcooh", "rcooh",
    # marine sulfur
    "dms", "dmso", "msa",
    # radicals / operators
    "oh", "ho2", "ch3o2", "ethp", "c2o3", "ro2", "ano2", "to2", "cro",
    "xo2", "isopp", "isopn", "isopo2",
)
NS = len(GAS_SPECIES)
IDX = {s: i for i, s in enumerate(GAS_SPECIES)}

# Reaction table: (reactants, products-with-stoich, rate spec)
# rate spec: ("arr", A, n, E/R) -> k = A*(T/300)^n*exp(-E_R/T)  [cm3/molec/s]
#            ("phot", name, scale) -> k = scale * J_name
R = lambda *a: a
REACTIONS: List[tuple] = [
    # ---- inorganic NOx / O3 / HOx --------------------------------------
    R(("no2",), (("no", 1.0), ("o3", 1.0)), ("phot", "no2", 1.0)),
    R(("no", "o3"), (("no2", 1.0),), ("arr", 3.0e-12, 0.0, 1500.0)),
    R(("o3",), (("oh", 2.0 * 0.2),), ("phot", "o3_o1d", 1.0)),  # O1D+H2O->2OH (20% yield folded)
    R(("no2", "o3"), (("no3", 1.0),), ("arr", 1.2e-13, 0.0, 2450.0)),
    R(("no3",), (("no2", 1.0), ("o3", 1.0)), ("phot", "no3", 0.9)),
    R(("no3",), (("no", 1.0),), ("phot", "no3", 0.1)),
    R(("no3", "no"), (("no2", 2.0),), ("arr", 1.5e-11, 0.0, -170.0)),
    R(("no3", "no2"), (("no", 1.0), ("no2", 1.0)), ("arr", 4.5e-14, 0.0, 1260.0)),
    R(("no3", "no2"), (("n2o5", 1.0),), ("arr", 2.0e-12, 0.2, -700.0)),
    R(("no3", "no3"), (("no2", 2.0),), ("arr", 8.5e-13, 0.0, 2450.0)),
    R(("no3", "ho2"), (("no2", 0.7), ("oh", 0.7), ("hno3", 0.3)),
      ("arr", 3.5e-12, 0.0, 0.0)),
    R(("n2o5",), (("no3", 1.0), ("no2", 1.0)), ("arr", 6.0e-2, 0.0, 10840.0)),
    R(("n2o5",), (("hno3", 2.0),), ("arr", 2.5e-22, 0.0, 0.0)),  # het. hydrolysis (pseudo-1st w/ H2O)
    R(("o3", "ho2"), (("oh", 1.0),), ("arr", 1.0e-14, 0.0, 490.0)),
    R(("o3", "oh"), (("ho2", 1.0),), ("arr", 1.7e-12, 0.0, 940.0)),
    R(("oh", "no2"), (("hno3", 1.0),), ("arr", 1.1e-11, -0.6, 0.0)),
    R(("oh", "no"), (("hono", 1.0),), ("arr", 7.0e-12, 0.0, -250.0)),
    R(("hono",), (("oh", 1.0), ("no", 1.0)), ("phot", "hono", 1.0)),
    R(("oh", "hono"), (("no2", 1.0),), ("arr", 1.8e-11, 0.0, 390.0)),
    R(("ho2", "no"), (("oh", 1.0), ("no2", 1.0)), ("arr", 3.5e-12, 0.0, -250.0)),
    R(("ho2", "no2"), (("hno4", 1.0),), ("arr", 1.4e-12, 0.0, -340.0)),
    R(("hno4",), (("ho2", 1.0), ("no2", 1.0)), ("arr", 2.6e15, 0.0, 10900.0)),
    R(("hno4", "oh"), (("no2", 1.0),), ("arr", 1.3e-12, 0.0, -380.0)),
    R(("hno4",), (("ho2", 1.0), ("no2", 1.0)), ("phot", "hno4", 1.0)),
    R(("ho2", "ho2"), (("h2o2", 1.0),), ("arr", 2.9e-12, 0.0, -160.0)),
    R(("h2o2",), (("oh", 2.0),), ("phot", "h2o2", 1.0)),
    R(("h2o2", "oh"), (("ho2", 1.0),), ("arr", 1.8e-12, 0.0, 0.0)),
    R(("oh", "ho2"), ((),), ("arr", 4.8e-11, 0.0, -250.0)),
    R(("oh", "h2"), (("ho2", 1.0),), ("arr", 5.5e-12, 0.0, 2000.0)),
    R(("hno3", "oh"), (("no3", 1.0),), ("arr", 1.5e-13, 0.0, -360.0)),
    R(("hno3",), (("oh", 1.0), ("no2", 1.0)), ("phot", "hno3", 1.0)),
    R(("co", "oh"), (("ho2", 1.0),), ("arr", 2.4e-13, 0.0, 0.0)),
    R(("so2", "oh"), (("h2so4", 1.0), ("ho2", 1.0)), ("arr", 1.6e-12, 0.0, 0.0)),
    R(("oh", "hcl"), ((),), ("arr", 7.8e-13, 0.0, 0.0)),  # Cl chain not carried
    # ---- C1: methane / methanol / formaldehyde -------------------------
    R(("ch4", "oh"), (("ch3o2", 1.0),), ("arr", 2.45e-12, 0.0, 1775.0)),
    R(("ch3o2", "no"), (("hcho", 1.0), ("ho2", 1.0), ("no2", 1.0)),
      ("arr", 2.8e-12, 0.0, -300.0)),
    R(("ch3o2", "ho2"), (("ch3ooh", 1.0),), ("arr", 4.1e-13, 0.0, -790.0)),
    R(("ch3o2", "ch3o2"), (("hcho", 1.3), ("ho2", 0.7)),
      ("arr", 2.5e-13, 0.0, -190.0)),
    R(("ch3ooh",), (("hcho", 1.0), ("ho2", 1.0), ("oh", 1.0)),
      ("phot", "ch3ooh", 1.0)),
    R(("ch3ooh", "oh"), (("ch3o2", 0.7), ("hcho", 0.3), ("oh", 0.3)),
      ("arr", 3.8e-12, 0.0, -200.0)),
    R(("ch3oh", "oh"), (("hcho", 1.0), ("ho2", 1.0)), ("arr", 2.9e-12, 0.0, 345.0)),
    R(("hcho",), (("co", 1.0), ("ho2", 2.0)), ("phot", "hcho_r", 1.0)),
    R(("hcho",), (("co", 1.0),), ("phot", "hcho_m", 1.0)),
    R(("hcho", "oh"), (("co", 1.0), ("ho2", 1.0)), ("arr", 5.5e-12, 0.0, -125.0)),
    R(("hcho", "no3"), (("hno3", 1.0), ("co", 1.0), ("ho2", 1.0)),
      ("arr", 5.8e-16, 0.0, 0.0)),
    # ---- C2: ethane / ethene / ethanol ----------------------------------
    R(("c2h6", "oh"), (("ethp", 1.0),), ("arr", 8.7e-12, 0.0, 1070.0)),
    R(("ethp", "no"), (("ald2", 1.0), ("ho2", 1.0), ("no2", 1.0)),
      ("arr", 2.6e-12, 0.0, -365.0)),
    R(("ethp", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    R(("anol", "oh"), (("ald2", 1.0), ("ho2", 1.0)), ("arr", 3.2e-12, 0.0, 0.0)),
    R(("eth", "oh"), (("xo2", 1.0), ("hcho", 1.56), ("ald2", 0.22), ("ho2", 1.0)),
      ("arr", 1.96e-12, 0.0, -438.0)),
    R(("eth", "o3"), (("hcho", 1.0), ("co", 0.43), ("ho2", 0.26), ("oh", 0.12),
                      ("hcooh", 0.37)),
      ("arr", 9.1e-15, 0.0, 2580.0)),
    # ---- lumped alkanes (PAR) + generic RO2 -----------------------------
    R(("par", "oh"), (("xo2", 0.87), ("ho2", 0.11), ("ald2", 0.11), ("ro2", 0.76)),
      ("arr", 8.1e-13, 0.0, 0.0)),
    R(("ro2", "no"), (("no2", 0.96), ("ald2", 0.48), ("aone", 0.48),
                      ("ho2", 0.96), ("onit", 0.04)),
      ("arr", 2.7e-12, 0.0, -360.0)),
    R(("ro2", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    R(("rooh",), (("oh", 1.0), ("ho2", 1.0), ("ald2", 0.5), ("aone", 0.5)),
      ("phot", "rooh", 1.0)),
    R(("rooh", "oh"), (("ro2", 1.0),), ("arr", 3.8e-12, 0.0, -200.0)),
    # ---- olefins ---------------------------------------------------------
    R(("olet", "oh"), (("hcho", 1.0), ("ald2", 1.0), ("xo2", 1.0), ("ho2", 1.0)),
      ("arr", 5.2e-12, 0.0, -504.0)),
    R(("olei", "oh"), (("ald2", 2.0), ("xo2", 1.0), ("ho2", 1.0)),
      ("arr", 1.0e-11, 0.0, -550.0)),
    R(("olet", "o3"), (("hcho", 0.5), ("ald2", 0.5), ("co", 0.3), ("ho2", 0.2),
                       ("oh", 0.1), ("hcooh", 0.06)),
      ("arr", 1.4e-14, 0.0, 2105.0)),
    R(("olei", "o3"), (("ald2", 1.0), ("co", 0.3), ("ho2", 0.3), ("oh", 0.27),
                       ("rcooh", 0.06)),
      ("arr", 7.2e-15, 0.0, 1880.0)),
    R(("olet", "no3"), (("onit", 1.0),), ("arr", 1.0e-13, 0.0, 800.0)),
    R(("olei", "no3"), (("onit", 1.0),), ("arr", 2.5e-13, 0.0, 450.0)),
    # ---- aromatics -------------------------------------------------------
    R(("tol", "oh"), (("ho2", 0.44), ("xo2", 0.08), ("cres", 0.36), ("to2", 0.56)),
      ("arr", 1.8e-12, 0.0, -355.0)),
    R(("xyl", "oh"), (("to2", 0.7), ("ho2", 0.5), ("cres", 0.2), ("mgly", 0.8)),
      ("arr", 1.7e-11, 0.0, -116.0)),
    R(("to2", "no"), (("no2", 0.9), ("open", 0.9), ("ho2", 0.9), ("onit", 0.1)),
      ("arr", 8.1e-12, 0.0, 0.0)),
    R(("to2",), (("cres", 1.0), ("ho2", 1.0)), ("arr", 4.2, 0.0, 0.0)),
    R(("cres", "oh"), (("cro", 0.4), ("xo2", 0.6), ("open", 0.6), ("ho2", 0.6)),
      ("arr", 4.1e-11, 0.0, 0.0)),
    R(("cres", "no3"), (("cro", 1.0), ("hno3", 1.0)), ("arr", 2.2e-11, 0.0, 0.0)),
    R(("cro", "no2"), (("onit", 1.0),), ("arr", 1.4e-11, 0.0, 0.0)),
    R(("open",), (("c2o3", 1.0), ("co", 1.0), ("ho2", 1.0)), ("phot", "open", 1.0)),
    R(("open", "oh"), (("xo2", 1.0), ("co", 2.0), ("ho2", 2.0), ("mgly", 1.0)),
      ("arr", 3.0e-11, 0.0, 0.0)),
    R(("open", "o3"), (("c2o3", 0.62), ("hcho", 0.7), ("co", 0.69), ("oh", 0.08),
                       ("ho2", 0.76), ("mgly", 0.2)),
      ("arr", 5.4e-17, 0.0, 500.0)),
    R(("mgly",), (("c2o3", 1.0), ("co", 1.0), ("ho2", 1.0)), ("phot", "mgly", 1.0)),
    R(("mgly", "oh"), (("c2o3", 1.0), ("co", 1.0)), ("arr", 1.7e-11, 0.0, 0.0)),
    # ---- carbonyls -------------------------------------------------------
    R(("ald2", "oh"), (("c2o3", 1.0),), ("arr", 7.0e-12, 0.0, -250.0)),
    R(("ald2",), (("co", 1.0), ("ho2", 1.0), ("ch3o2", 1.0)), ("phot", "ald", 1.0)),
    R(("ald2", "no3"), (("c2o3", 1.0), ("hno3", 1.0)), ("arr", 1.4e-12, 0.0, 1900.0)),
    R(("aone",), (("c2o3", 1.0), ("ch3o2", 1.0)), ("phot", "aone", 1.0)),
    R(("aone", "oh"), (("ano2", 1.0),), ("arr", 8.8e-12, 0.0, 1320.0)),
    R(("ano2", "no"), (("no2", 1.0), ("c2o3", 1.0), ("hcho", 1.0)),
      ("arr", 2.8e-12, 0.0, -300.0)),
    R(("ano2", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    # ---- PAN chemistry ---------------------------------------------------
    R(("c2o3", "no"), (("no2", 1.0), ("ch3o2", 1.0)), ("arr", 8.1e-12, 0.0, -270.0)),
    R(("c2o3", "no2"), (("pan", 1.0),), ("arr", 9.7e-12, 0.0, 0.0)),
    R(("pan",), (("c2o3", 1.0), ("no2", 1.0)), ("arr", 9.4e16, 0.0, 14000.0)),
    R(("pan",), (("c2o3", 1.0), ("no2", 1.0)), ("phot", "pan", 1.0)),
    R(("c2o3", "ho2"), (("rooh", 0.75), ("rcooh", 0.25)), ("arr", 4.3e-13, 0.0, -1040.0)),
    R(("c2o3", "c2o3"), (("ch3o2", 2.0),), ("arr", 2.9e-12, 0.0, -500.0)),
    R(("c2o3", "ch3o2"), (("hcho", 1.0), ("ho2", 1.0), ("ch3o2", 0.5)),
      ("arr", 1.3e-12, 0.0, -640.0)),
    # ---- isoprene --------------------------------------------------------
    R(("isop", "oh"), (("isopp", 1.0),), ("arr", 2.5e-11, 0.0, -408.0)),
    R(("isop", "o3"), (("hcho", 0.6), ("isoprd", 0.65), ("oh", 0.27), ("co", 0.07),
                       ("hcooh", 0.2)),
      ("arr", 1.2e-14, 0.0, 2013.0)),
    R(("isop", "no3"), (("isopn", 1.0),), ("arr", 3.0e-12, 0.0, 450.0)),
    R(("isopp", "no"), (("no2", 0.91), ("ho2", 0.91), ("hcho", 0.63),
                        ("isoprd", 0.91), ("onit", 0.09)),
      ("arr", 4.0e-12, 0.0, 0.0)),
    R(("isopp", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    R(("isopn", "no"), (("no2", 1.0), ("onit", 1.0), ("ho2", 1.0)),
      ("arr", 4.0e-12, 0.0, 0.0)),
    R(("isoprd", "oh"), (("c2o3", 0.5), ("isopo2", 0.5)), ("arr", 3.3e-11, 0.0, 0.0)),
    R(("isoprd",), (("c2o3", 0.97), ("co", 0.33), ("hcho", 0.33), ("ho2", 1.0)),
      ("phot", "isoprd", 1.0)),
    R(("isoprd", "o3"), (("oh", 0.27), ("ho2", 0.1), ("mgly", 0.2), ("co", 1.0)),
      ("arr", 7.0e-18, 0.0, 0.0)),
    R(("isopo2", "no"), (("no2", 1.0), ("ho2", 1.0), ("co", 0.59), ("ald2", 0.55),
                         ("mgly", 0.25)),
      ("arr", 4.0e-12, 0.0, 0.0)),
    R(("isopo2", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    # ---- organic nitrate -------------------------------------------------
    R(("onit", "oh"), (("no2", 1.0), ("xo2", 1.0)), ("arr", 1.5e-12, 0.0, 0.0)),
    R(("onit",), (("no2", 1.0), ("ho2", 1.0), ("ald2", 1.0)), ("phot", "onit", 1.0)),
    # ---- XO2 operator ----------------------------------------------------
    R(("xo2", "no"), (("no2", 1.0),), ("arr", 2.8e-12, 0.0, -300.0)),
    R(("xo2", "ho2"), (("rooh", 1.0),), ("arr", 7.5e-13, 0.0, -700.0)),
    R(("xo2", "xo2"), ((),), ("arr", 6.8e-14, 0.0, 0.0)),
    # ---- organic acids ---------------------------------------------------
    R(("hcooh", "oh"), (("ho2", 1.0),), ("arr", 4.0e-13, 0.0, 0.0)),
    R(("rcooh", "oh"), (("ho2", 1.0),), ("arr", 1.2e-12, 0.0, 0.0)),
    # ---- DMS / marine sulfur --------------------------------------------
    R(("dms", "oh"), (("so2", 1.0), ("ch3o2", 1.0)), ("arr", 1.2e-11, 0.0, 260.0)),
    R(("dms", "oh"), (("so2", 0.6), ("dmso", 0.4)), ("arr", 3.0e-12, 0.0, -500.0)),
    R(("dms", "no3"), (("so2", 1.0), ("hno3", 1.0)), ("arr", 1.9e-13, 0.0, -520.0)),
    R(("dmso", "oh"), (("so2", 0.9), ("msa", 0.1)), ("arr", 6.1e-12, 0.0, -800.0)),
]
NR_RXN = len(REACTIONS)

# default clear-sky overhead-sun photolysis frequencies [1/s]
J_CLEAR = {
    "no2": 8.9e-3, "o3_o1d": 3.5e-5, "no3": 0.18, "hono": 1.7e-3,
    "h2o2": 7.0e-6, "hcho_r": 3.1e-5, "hcho_m": 4.5e-5, "ald": 5.0e-6,
    "hno3": 6.0e-7, "hno4": 5.0e-6, "ch3ooh": 5.5e-6, "rooh": 5.5e-6,
    "aone": 7.0e-7, "mgly": 1.2e-4, "open": 3.0e-4, "isoprd": 5.0e-5,
    "onit": 1.5e-6, "pan": 7.0e-7,
}
PHOT_NAMES = tuple(J_CLEAR.keys())


def build_tables(reactions, idx, ns):
    """Dense stoichiometry matrices: loss L (ns, nrxn) reactant orders and
    net production P (ns, nrxn). Shared by the built-in mechanism and
    mechanisms compiled from .eqn files (chem/mechanism.py, the KPP-analog
    toolchain)."""
    nr = len(reactions)
    order = np.zeros((ns, nr))
    net = np.zeros((ns, nr))
    rate_kind = []
    rate_params = []
    for j, (reacts, prods, spec) in enumerate(reactions):
        for s in reacts:
            order[idx[s], j] += 1.0
            net[idx[s], j] -= 1.0
        for prod in prods:
            if not prod:
                continue   # pure-loss reaction, e.g. OH + HO2 -> H2O
            s, st = prod
            net[idx[s], j] += st
        rate_kind.append(spec[0])
        rate_params.append(tuple(spec[1:]))
    return order, net, rate_kind, rate_params


_ORDER, _NET, _RKIND, _RPARAMS = build_tables(REACTIONS, IDX, NS)


def rate_constants(t_air: torch.Tensor, m_air: torch.Tensor, j_scale) -> torch.Tensor:
    """(nrxn, ...) rate constants.  t_air [K]; m_air [molec/cm3] (unused:
    the pseudo-first-order reactions have it folded in); j_scale: the
    photolysis scaling, either one gray field broadcastable to t_air
    (phot_opt=1) or a dict {phot_name: field} of per-reaction spectral
    scales from `chem.photolysis.j_scales` (phot_opt=2)."""
    ks = []
    ones = torch.ones_like(t_air)
    for kind, params in zip(_RKIND, _RPARAMS):
        if kind == "arr":
            a, n, e_r = params
            k = a * (t_air / 300.0) ** n * torch.exp(-e_r / t_air)
        elif kind == "phot":
            name, scale = params
            js = j_scale[name] if isinstance(j_scale, dict) else j_scale
            k = J_CLEAR[name] * scale * js * ones
        else:
            raise ValueError(kind)
        ks.append(k)
    return torch.stack(ks)


def _min_degree_perm(pattern: set, ns: int) -> list:
    """Greedy Markowitz/minimum-degree ordering of the (structural) matrix:
    at each step eliminate the node minimizing (row_nnz-1)*(col_nnz-1),
    tracking symbolic fill.  KPP achieves the same effect by hand-ordering
    species so the densely-coupled radicals eliminate last."""
    rows = [set() for _ in range(ns)]
    cols = [set() for _ in range(ns)]
    for (i, l) in pattern:
        rows[i].add(l)
        cols[l].add(i)
    for q in range(ns):
        rows[q].add(q)
        cols[q].add(q)
    remaining = set(range(ns))
    perm = []
    while remaining:
        best = min(
            remaining,
            key=lambda q: ((len(rows[q] & remaining) - 1)
                           * (len(cols[q] & remaining) - 1), q))
        perm.append(best)
        remaining.discard(best)
        rset = (cols[best] & remaining)
        cset = (rows[best] & remaining)
        for i in rset:
            new = cset - rows[i]
            rows[i] |= new
            for c in new:
                cols[c].add(i)
    return perm


class _SparseKinetics:
    """Precomputed sparse structure for one mechanism (order, net tables).

    All symbolic work (fill-reducing ordering, LU fill pattern, the
    per-pivot elimination schedule, triangular-solve level schedule, and
    every index array) happens once in numpy, exactly as the reference
    does it.  `step_ros2` is the vectorised index form: the LU values live
    in one (nnz + 1, ncell) tensor and each pivot step is a gather, an outer
    product and a scatter-add over that pivot's (padded) fill block, each
    solve level one gather and one `index_add_`."""

    def __init__(self, order: np.ndarray, net: np.ndarray):
        ns, nr = order.shape
        self.ns, self.nr = ns, nr
        dummy = ns                            # index of the all-ones row
        # reactant lists with integer powers
        self.rx = [[(i, int(round(order[i, j])))
                    for i in range(ns) if order[i, j] > 0]
                   for j in range(nr)]
        prod = [[(j, float(net[i, j])) for j in range(nr)
                 if net[i, j] != 0.0] for i in range(ns)]

        # --- reaction velocities: v = k * c1[r1] * c1[r2] ----------------
        r1 = np.full(nr, dummy, np.int32)
        r2 = np.full(nr, dummy, np.int32)
        for j, rs in enumerate(self.rx):
            flat = [m for (m, p) in rs for _ in range(p)]
            assert len(flat) <= 2, "only uni/bimolecular reactions supported"
            if len(flat) > 0:
                r1[j] = flat[0]
            if len(flat) > 1:
                r2[j] = flat[1]
        self.r1, self.r2 = r1, r2

        # --- production/loss scatter: f[i] += coef * v[j] ----------------
        f_tgt, f_rxn, f_coef = [], [], []
        for i in range(ns):
            for (j, nij) in prod[i]:
                f_tgt.append(i)
                f_rxn.append(j)
                f_coef.append(nij)
        self.f_tgt = np.asarray(f_tgt, np.int32)
        self.f_rxn = np.asarray(f_rxn, np.int32)
        self.f_coef = np.asarray(f_coef, np.float32)

        # --- dv_j/dc_l pairs: dv = coef * k[j] * c1[other] ---------------
        pairs = []                            # [(j, l)]
        pair_id = {}
        p_rxn, p_oth, p_coef = [], [], []
        for j, rs in enumerate(self.rx):
            for (l, p) in rs:
                pair_id[(j, l)] = len(pairs)
                pairs.append((j, l))
                p_rxn.append(j)
                if p == 2:                    # d(k c^2)/dc = 2 k c
                    p_oth.append(l)
                    p_coef.append(2.0)
                else:
                    others = [m for (m, q) in rs if m != l]
                    p_oth.append(others[0] if others else dummy)
                    p_coef.append(1.0)
        self.p_rxn = np.asarray(p_rxn, np.int32)
        self.p_oth = np.asarray(p_oth, np.int32)
        self.p_coef = np.asarray(p_coef, np.float32)

        # --- Jacobian entries: jacv[e] += nij * dv[pair] -----------------
        jac = {}                              # (i, l) -> entry id
        jc_tgt, jc_pair, jc_coef = [], [], []
        for i in range(ns):
            for (j, nij) in prod[i]:
                for (l, _p) in self.rx[j]:
                    e = jac.setdefault((i, l), len(jac))
                    jc_tgt.append(e)
                    jc_pair.append(pair_id[(j, l)])
                    jc_coef.append(nij)
        self.njac = len(jac)
        self.jc_tgt = np.asarray(jc_tgt, np.int32)
        self.jc_pair = np.asarray(jc_pair, np.int32)
        self.jc_coef = np.asarray(jc_coef, np.float32)

        # --- symbolic LU on the permuted pattern -------------------------
        perm = _min_degree_perm(set(jac.keys()), ns)
        self.perm = np.asarray(perm, np.int32)
        iperm = np.zeros(ns, np.int32)
        iperm[perm] = np.arange(ns, dtype=np.int32)
        self.iperm = iperm
        inv = {p: q for q, p in enumerate(perm)}
        pat = {(inv[i], inv[l]) for (i, l) in jac}
        pat |= {(q, q) for q in range(ns)}
        rows = [set(l for (i, l) in pat if i == r) for r in range(ns)]
        schedule = []                         # per pivot k: (below, right)
        for k in range(ns):
            below = sorted(i for i in range(k + 1, ns) if k in rows[i])
            right = sorted(j for j in rows[k] if j > k)
            for i in below:
                rows[i] |= set(right)
            schedule.append((below, right))
        lu_pat = sorted((i, j) for i in range(ns) for j in rows[i])
        pos = {e: q for q, e in enumerate(lu_pat)}
        self.nnz = len(lu_pat)
        self.n_fill_ops = sum(len(b) * len(r) for b, r in schedule)
        # scatter positions for assembly
        self.diag_pos = np.asarray([pos[(q, q)] for q in range(ns)], np.int32)
        jac_pos = np.zeros(self.njac, np.int32)
        for (i, l), e in jac.items():
            jac_pos[e] = pos[(inv[i], inv[l])]
        self.jac_pos = jac_pos

        # --- padded per-pivot stage index blocks (the reference's layout) -
        # Position `nnz` is a scratch row: every padded index reads/writes
        # it, so pad garbage stays confined there (it starts 0, so the
        # first padded products are exactly 0).
        scratch = self.nnz
        maxb = max((len(b) for b, _ in schedule if b), default=1)
        maxr = max((len(r) for _, r in schedule if r), default=1)
        self.maxb, self.maxr = maxb, maxr
        pkk, ikm, kjm, updm = [], [], [], []
        for k, (below, right) in enumerate(schedule):
            pkk.append(pos[(k, k)])
            ik = [pos[(i, k)] for i in below] + [scratch] * (maxb - len(below))
            kj = [pos[(k, j)] for j in right] + [scratch] * (maxr - len(right))
            upd = [[pos[(i, j)] for j in right] + [scratch] * (maxr - len(right))
                   for i in below]
            upd += [[scratch] * maxr] * (maxb - len(below))
            ikm.append(ik)
            kjm.append(kj)
            updm.append([e for row in upd for e in row])
        self.pkk = np.asarray(pkk, np.int32)
        self.ikm = np.asarray(ikm, np.int32)
        self.kjm = np.asarray(kjm, np.int32)
        self.updm = np.asarray(updm, np.int32)

        # --- triangular-solve level schedules (padded, scanned) ----------
        lower = [sorted(l for l in range(q) if (q, l) in pos)
                 for q in range(ns)]
        upper = [sorted(l for l in range(q + 1, ns) if (q, l) in pos)
                 for q in range(ns)]

        def levels(adj, order_):
            depth = [0] * ns
            for q in order_:
                depth[q] = 1 + max((depth[l] for l in adj[q]), default=-1)
            out = {}
            for q in range(ns):
                if adj[q]:
                    out.setdefault(depth[q], []).append(q)
            lvls = [[(pos[(q, l)], l, q) for q in out[d] for l in adj[q]]
                    for d in sorted(out)]
            width = max(len(lv) for lv in lvls)
            # pad: read vals scratch row, y/x scratch row ns, write row ns
            ep = np.full((len(lvls), width), scratch, np.int32)
            ec = np.full((len(lvls), width), ns, np.int32)
            er = np.full((len(lvls), width), ns, np.int32)
            for li, lv in enumerate(lvls):
                for e, (p, c, r) in enumerate(lv):
                    ep[li, e], ec[li, e], er[li, e] = p, c, r
            return ep, ec, er

        self.fw_ep, self.fw_ec, self.fw_er = levels(lower, range(ns))
        self.bw_ep, self.bw_ec, self.bw_er = levels(upper,
                                                    range(ns - 1, -1, -1))

    # --- numerics (batched over the trailing cell axis) -------------------
    def _idx(self, device):
        """The index tables as int64 tensors on `device` (cached)."""
        cache = self.__dict__.setdefault("_idx_cache", {})   # per device
        key = str(device)
        if key not in cache:
            names = ("r1", "r2", "f_tgt", "f_rxn", "p_rxn", "p_oth", "jc_tgt", "jc_pair",
                     "diag_pos", "jac_pos", "pkk", "ikm", "kjm", "updm", "fw_ep", "fw_ec",
                     "fw_er", "bw_ep", "bw_ec", "bw_er", "perm", "iperm")
            t = {n: torch.from_numpy(getattr(self, n).astype(np.int64)).to(device)
                 for n in names}
            for n in ("f_coef", "p_coef", "jc_coef"):
                t[n] = torch.from_numpy(getattr(self, n)).to(device)[:, None]
            cache[key] = t
        return cache[key]

    @staticmethod
    def _with_ones(cmat):
        return torch.cat([cmat, torch.ones_like(cmat[:1])], dim=0)

    def prod_rates(self, cmat, k):
        """dc/dt (ns, ncell) and velocities v (nr, ncell)."""
        ix = self._idx(cmat.device)
        c1 = self._with_ones(cmat)
        v = k * c1[ix["r1"]] * c1[ix["r2"]]
        f = torch.zeros_like(cmat).index_add_(
            0, ix["f_tgt"], ix["f_coef"].to(cmat.dtype) * v[ix["f_rxn"]])
        return f, v

    def step_ros2(self, conc, k, dt, return_err: bool = False):
        """One 2-stage Rosenbrock step, (ns, ncell) -> (ns, ncell): the
        sparse LU factored once, two level-scheduled triangular solve pairs.

        `dt` is a float or a per-cell (ncell,) tensor (the adaptive
        integrator steps every cell with its own dt).  With `return_err`,
        also returns the embedded first-order error estimate
        0.5*dt*(k1+k2), evaluated before the positivity clip."""
        ns = self.ns
        gamma = 1.0 + 1.0 / np.sqrt(2.0)
        dtype = conc.dtype
        ix = self._idx(conc.device)
        cells = conc.shape[1:]
        gdt = gamma * dt if isinstance(dt, torch.Tensor) else float(np.float32(gamma * dt))
        f0, _v0 = self.prod_rates(conc, k)

        # dv_j/dc_l and the Jacobian entry values
        c1 = self._with_ones(conc)
        dv = ix["p_coef"].to(dtype) * k[ix["p_rxn"]] * c1[ix["p_oth"]]
        jacv = torch.zeros((self.njac,) + cells, dtype=dtype, device=conc.device)
        jacv.index_add_(0, ix["jc_tgt"], ix["jc_coef"].to(dtype) * dv[ix["jc_pair"]])

        # assemble A = I - gamma dt J on the LU pattern (permuted), plus the
        # scratch row at index nnz that absorbs all padded reads and writes
        vals = torch.zeros((self.nnz + 1,) + cells, dtype=dtype, device=conc.device)
        vals[ix["diag_pos"]] = 1.0
        vals.index_add_(0, ix["jac_pos"], -gdt * jacv)

        # sparse LU with diagonal pivots, one gather / outer product /
        # scatter-add per pivot over its padded fill block
        invd = []
        for kk in range(ns):
            idk = 1.0 / vals[ix["pkk"][kk]]
            ik, kj, upd = ix["ikm"][kk], ix["kjm"][kk], ix["updm"][kk]
            lik = vals[ik] * idk
            vals[ik] = lik
            outer = (lik[:, None] * vals[kj][None, :]).reshape(
                (self.maxb * self.maxr,) + cells)
            vals.index_add_(0, upd, -outer)
            invd.append(idk)
        invd = torch.stack(invd)
        invd_p = torch.cat([invd, torch.zeros((1,) + cells, dtype=dtype,
                                              device=conc.device)])

        def solve(b):
            y = torch.cat([b[ix["perm"]], torch.zeros((1,) + cells, dtype=dtype,
                                                      device=conc.device)])
            for ep, ec, er in zip(ix["fw_ep"], ix["fw_ec"], ix["fw_er"]):
                y.index_add_(0, er, -vals[ep] * y[ec])
            # backward: z_q = y_q - sum_{l>q} u_ql x_l with x_l = z_l/d_l;
            # the levels guarantee z_l is final before it is read
            for ep, ec, er in zip(ix["bw_ep"], ix["bw_ec"], ix["bw_er"]):
                y.index_add_(0, er, -vals[ep] * y[ec] * invd_p[ec])
            return (y[:ns] * invd)[ix["iperm"]]

        k1 = solve(f0)
        conc1 = torch.clamp(conc + dt * k1, min=0.0)
        f1, _ = self.prod_rates(conc1, k)
        k2 = solve(f1 - 2.0 * k1)
        out = torch.clamp(conc + 1.5 * dt * k1 + 0.5 * dt * k2, min=0.0)
        if return_err:
            return out, 0.5 * dt * (k1 + k2)
        return out


_KIN_CACHE: Dict[Tuple[bytes, bytes], _SparseKinetics] = {}


def _kinetics() -> _SparseKinetics:
    """Sparse solver for the CURRENT module tables (a compiled user
    mechanism may replace _ORDER/_NET; the cache is keyed on content)."""
    key = (_ORDER.tobytes(), _NET.tobytes())
    kin = _KIN_CACHE.get(key)
    if kin is None:
        kin = _SparseKinetics(np.asarray(_ORDER), np.asarray(_NET))
        _KIN_CACHE[key] = kin
    return kin


# cells per batch of the vectorised path: it holds ~nnz live (ncell,) rows
CELL_CHUNK = 65536

# ROS2 substep target [s]: n_sub = ceil(dt_total / 30)
SUBSTEP_TARGET_S = 30.0


def integrate(conc: torch.Tensor, k: torch.Tensor, dt_total: float,
              n_sub: Optional[int] = None) -> torch.Tensor:
    """Integrate the mechanism over dt_total with fixed ROS2 substeps:
    conc (ns, ncell) [molec/cm3], k (nrxn, ncell) -> (ns, ncell).

    CUDA tensors go through the generated kernel (`ops.ros2_kernel`), all
    substeps in one launch; CPU tensors through the vectorised
    `_SparseKinetics.step_ros2`, `CELL_CHUNK` cells at a time."""
    if n_sub is None:
        n_sub = max(1, int(np.ceil(dt_total / SUBSTEP_TARGET_S)))
    kin = _kinetics()
    if conc.device.type != "cpu":
        from wrfchem_arc_interactions_tpu_torch.ops.ros2_kernel import ros2_integrate
        return ros2_integrate(kin, conc, k, dt_total, n_sub)
    dt = dt_total / n_sub
    out = torch.empty_like(conc)
    for lo in range(0, conc.shape[-1], CELL_CHUNK):
        c, kk = conc[:, lo:lo + CELL_CHUNK], k[:, lo:lo + CELL_CHUNK]
        for _ in range(n_sub):
            c = kin.step_ros2(c, kk, dt)
        out[:, lo:lo + CELL_CHUNK] = c
    return out


def integrate_adaptive(conc: torch.Tensor, k: torch.Tensor, dt_total: float,
                       rtol: float = 1e-3, atol: float = 1e3,
                       dt_init: Optional[float] = None, dt_min: float = 0.25,
                       max_steps: int = 512, return_stats: bool = False):
    """Error-controlled Rosenbrock integration (the KPP accept/reject loop,
    batched): every cell carries its own (t, dt); each iteration takes one
    trial ROS2 step per cell at its own dt, accepts where the embedded-error
    norm E <= 1, and rescales dt with the 0.9*E^(-1/2) controller clipped to
    [0.2, 2].  Finished cells are masked.  Plain PyTorch on every device
    (the vectorised `step_ros2`); the loop ends when every cell is done or
    after `max_steps`, and reads one flag from the device per iteration."""
    kin = _kinetics()
    dtype, dev = conc.dtype, conc.device
    ncell = conc.shape[-1]
    dt_tot = float(dt_total)
    t = torch.zeros((ncell,), dtype=dtype, device=dev)
    dt = torch.full((ncell,), dt_init or min(SUBSTEP_TARGET_S, dt_total),
                    dtype=dtype, device=dev)
    eps = 1e-6 * dt_total
    c = conc
    it = 0
    n_rej = torch.zeros((), dtype=torch.int64, device=dev)
    while it < max_steps and bool((t < dt_tot - eps).any()):
        active = t < dt_tot - eps
        dt_eff = torch.where(active, torch.minimum(dt, dt_tot - t), dt_min)
        cn, err = kin.step_ros2(c, k, dt_eff, return_err=True)
        sc = atol + rtol * torch.maximum(c.abs(), cn.abs())
        E = (err.abs() / sc).amax(dim=0)
        accept = (E <= 1.0) | (dt_eff <= dt_min)
        take = active & accept
        c = torch.where(take[None], cn, c)
        t = torch.where(take, t + dt_eff, t)
        fac = torch.clamp(0.9 / torch.sqrt(torch.clamp(E, min=1e-12)), 0.2, 2.0)
        dt = torch.where(active, torch.clamp(dt_eff * fac, dt_min, dt_tot), dt)
        n_rej = n_rej + (active & ~accept).sum()
        it += 1
    if return_stats:
        return c, {"iterations": it, "rejected_steps": int(n_rej),
                   "all_finished": bool((t >= dt_tot - eps).all())}
    return c
