"""Analytic base-state soundings for the ideal cases (canonical: the
hard-wired soundings of dyn_em/module_initialize_<case>.F)."""

from __future__ import annotations

import numpy as np

from wrfchem_arc_interactions_tpu_torch.utils import constants as c


def isothermal_theta(t_iso: float = 250.0):
    """theta(z) of an isothermal atmosphere (analytic; good for wave tests)."""

    def theta(z):
        return t_iso * np.exp(c.G * np.asarray(z, np.float64) / (c.CP * t_iso))

    return theta


def constant_n2_theta(theta0: float = 300.0, n2: float = 1.0e-4):
    """Constant Brunt-Vaisala frequency squared."""

    def theta(z):
        return theta0 * np.exp(n2 * np.asarray(z, np.float64) / c.G)

    return theta


def weisman_klemp_theta(theta0: float = 300.0, theta_tr: float = 343.0,
                        z_tr: float = 12000.0, t_tr: float = 213.0):
    """Weisman-Klemp (1982) squall-line/supercell sounding potential
    temperature (canonical module_initialize_squall2d_x.F analytic profile)."""

    def theta(z):
        z = np.asarray(z, np.float64)
        trop = theta0 + (theta_tr - theta0) * (np.maximum(z, 0.0) / z_tr) ** 1.25
        strat = theta_tr * np.exp(c.G * (z - z_tr) / (c.CP * t_tr))
        return np.where(z <= z_tr, trop, strat)

    return theta


def weisman_klemp_rh(z_tr: float = 12000.0):
    """Relative-humidity profile of the WK sounding."""

    def rh(z):
        z = np.asarray(z, np.float64)
        return np.where(z <= z_tr, 1.0 - 0.75 * (z / z_tr) ** 1.25, 0.25)

    return rh


def qv_from_rh(theta: np.ndarray, p: np.ndarray, rh: np.ndarray,
               qv_max: float = 0.014) -> np.ndarray:
    """Water-vapor mixing ratio from RH w.r.t. liquid (Bolton formula),
    capped at qv_max like the WK initialisation."""
    t = theta * (p / c.P0) ** c.RCP
    es = 611.2 * np.exp(c.SVP2 * (t - c.SVPT0) / (t - c.SVP3))
    qvs = c.EP_2 * es / np.maximum(p - es, 1.0)
    return np.minimum(rh * qvs, qv_max)
