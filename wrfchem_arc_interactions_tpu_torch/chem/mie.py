"""Exact Mie scattering (Bohren & Huffman series) and the Chebyshev tables
of the fast path (a numpy copy of the JAX package's `chem/mie.py`;
canonical: the Ghan et al. Chebyshev-expansion fast Mie of
chem/module_optical_averaging.F `mieaer`/`binterp`).

- `bhmie`: the exact series in host numpy float64, the generator of the
  tables.
- `build_cheb_tables`: per refractive-index grid point, Chebyshev
  coefficients of ln Q_ext, ln Q_sca and g as functions of ln(size
  parameter).
- `build_grid_matrix`: the three tables stacked as one float32 (90, 80)
  matrix, evaluated at run time by `chem.optics` with the bilinear hat
  weights over the (8, 10) refractive-index grid (the Mie kernel,
  `ops/mie_kernel.py`, keeps it in shared memory).

Both are built once per process on the host (about a second) and cached.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Chebyshev fit configuration (Ghan et al. use order ~30 over the bin range)
NCHEB = 30
X_MIN, X_MAX = 1e-3, 60.0          # size-parameter range covered by the fit
NR_GRID = np.linspace(1.25, 2.1, 8)          # uniform -> arithmetic indexing
NI_GRID = np.logspace(-9.0, 0.0, 10)         # uniform in log10, 1 decade steps


def bhmie(x: float, m: complex):
    """Mie efficiencies (q_ext, q_sca, g) for size parameter x and
    refractive index m (Bohren & Huffman downward recurrence, float64)."""
    x = float(x)
    if x <= 0:
        return 0.0, 0.0, 0.0
    nstop = int(x + 4.0 * x ** (1.0 / 3.0) + 2.0)
    nmx = int(max(nstop, abs(m * x)) + 16)
    y = m * x
    # logarithmic derivative D by downward recurrence
    d = np.zeros(nmx + 1, dtype=complex)
    for n in range(nmx, 0, -1):
        d[n - 1] = n / y - 1.0 / (d[n] + n / y)
    # Riccati-Bessel by upward recurrence
    psi0, psi1 = np.cos(x), np.sin(x)
    chi0, chi1 = -np.sin(x), np.cos(x)
    xi1 = complex(psi1, -chi1)
    qsca = 0.0
    qext = 0.0
    gsum = 0.0
    an_prev = bn_prev = 0j
    for n in range(1, nstop + 1):
        psi = (2.0 * n - 1.0) * psi1 / x - psi0
        chi = (2.0 * n - 1.0) * chi1 / x - chi0
        xi = complex(psi, -chi)
        dn = d[n]
        an = ((dn / m + n / x) * psi - psi1) / ((dn / m + n / x) * xi - xi1)
        bn = ((dn * m + n / x) * psi - psi1) / ((dn * m + n / x) * xi - xi1)
        qsca += (2.0 * n + 1.0) * (abs(an) ** 2 + abs(bn) ** 2)
        qext += (2.0 * n + 1.0) * (an + bn).real
        if n > 1:
            nm1 = n - 1
            gsum += (nm1 * (nm1 + 2.0) / n) * (an_prev * np.conj(an)
                                               + bn_prev * np.conj(bn)).real
            gsum += ((2.0 * nm1 + 1.0) / (nm1 * (nm1 + 1.0))) * (
                an_prev * np.conj(bn_prev)).real
        an_prev, bn_prev = an, bn
        psi0, psi1 = psi1, psi
        chi0, chi1 = chi1, chi
        xi1 = xi
    qsca *= 2.0 / (x * x)
    qext *= 2.0 / (x * x)
    g = 4.0 / (x * x * max(qsca, 1e-12)) * gsum
    return qext, qsca, float(np.clip(g, -1.0, 1.0))


def _cheb_nodes(n: int):
    return np.cos(np.pi * (np.arange(n) + 0.5) / n)


def _cheb_fit(f_vals: np.ndarray, n: int) -> np.ndarray:
    """Chebyshev coefficients from values at the n Chebyshev nodes."""
    k = np.arange(n)
    theta = np.pi * (k + 0.5) / n
    T = np.cos(np.outer(np.arange(n), theta))     # (ncoef, nnodes)
    return (2.0 / n) * T @ f_vals


@dataclasses.dataclass(frozen=True)
class MieTables:
    """Chebyshev coefficient tables over the (nr, ni) refractive-index grid:
    ln Q_ext and ln Q_sca fitted in log space, g raw; one table serves every
    band (the band enters through x = pi D / lambda)."""
    coef_qext: np.ndarray                 # (n_nr, n_ni, NCHEB) of ln(Q_ext)
    coef_qsca: np.ndarray                 # ln(Q_sca)
    coef_g: np.ndarray                    # raw g
    lnx_min: float
    lnx_max: float


@functools.lru_cache(maxsize=1)
def build_cheb_tables() -> MieTables:
    lnx_min, lnx_max = np.log(X_MIN), np.log(X_MAX)
    nodes_t = _cheb_nodes(NCHEB)
    lnx_nodes = 0.5 * (nodes_t + 1.0) * (lnx_max - lnx_min) + lnx_min
    x_nodes = np.exp(lnx_nodes)
    shape = (len(NR_GRID), len(NI_GRID), NCHEB)
    cq = np.zeros(shape)
    cs = np.zeros(shape)
    cg = np.zeros(shape)
    for inr, nr in enumerate(NR_GRID):
        for ini, ni in enumerate(NI_GRID):
            m = complex(nr, ni)
            qe = np.zeros(NCHEB)
            qs = np.zeros(NCHEB)
            gg = np.zeros(NCHEB)
            for j, x in enumerate(x_nodes):
                qe[j], qs[j], gg[j] = bhmie(x, m)
            cq[inr, ini] = _cheb_fit(np.log(np.maximum(qe, 1e-30)), NCHEB)
            cs[inr, ini] = _cheb_fit(np.log(np.maximum(qs, 1e-30)), NCHEB)
            cg[inr, ini] = _cheb_fit(gg, NCHEB)
    return MieTables(coef_qext=cq, coef_qsca=cs, coef_g=cg,
                     lnx_min=lnx_min, lnx_max=lnx_max)


@functools.lru_cache(maxsize=1)
def build_grid_matrix() -> np.ndarray:
    """(3*NCHEB, n_nr*n_ni) float32 stacked grid tables: row k of block i
    is Chebyshev coefficient k of table i (ln Q_ext, ln Q_sca, g) at the 80
    grid nodes, node index a*n_ni + b for (NR_GRID[a], NI_GRID[b])."""
    tabs = build_cheb_tables()

    def flat(c):                              # (8, 10, NCHEB) -> (NCHEB, 80)
        return c.reshape(-1, NCHEB).T
    return np.concatenate([flat(tabs.coef_qext), flat(tabs.coef_qsca),
                           flat(tabs.coef_g)]).astype(np.float32)
