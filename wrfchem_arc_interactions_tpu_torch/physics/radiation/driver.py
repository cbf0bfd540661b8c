"""Radiation driver (port of the JAX package's
`physics/radiation/driver.py`; canonical: phys/module_radiation_driver.F):
column inputs, the solar zenith angle, the RRTMG SW/LW solvers (or the
simple broadband scheme, `radiation.simple`) on the radt alarm, the flux
divergence as held theta tendencies (the grid%rthraten pattern), and the aerosol optical properties from chem when
``aer_ra_feedback`` is on — the aerosol-radiation (ARC direct effect)
coupling point.

The RRTMG solvers run over chunks of at most `COL_CHUNK` columns, as
the reference's `_map_col_chunks` runs them, which bounds the live
(ngpt, nz, chunk) temporaries.  Every result is column-independent (the
McICA deviates hash only the g-point, the layer and the seed), so a chunked
call equals an unchunked one bit for bit; the last chunk is the shorter
one, where the reference pads it by edge replication.  `chip_smoke.py`
prints the peak device memory of one call at 10,000 and at 100,000 columns.
"""

from __future__ import annotations

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.config import Config
from wrfchem_arc_interactions_tpu_torch.config.namelist import RAScheme
from wrfchem_arc_interactions_tpu_torch.dycore.diagnostics import diagnose
from wrfchem_arc_interactions_tpu_torch.grid import Grid
from wrfchem_arc_interactions_tpu_torch.physics.radiation import mcica
from wrfchem_arc_interactions_tpu_torch.physics.radiation.rrtmg_lw import lw_fluxes
from wrfchem_arc_interactions_tpu_torch.physics.radiation.rrtmg_sw import sw_fluxes
from wrfchem_arc_interactions_tpu_torch.physics.radiation.simple import lw_simple, sw_simple
from wrfchem_arc_interactions_tpu_torch.registry.state import State
from wrfchem_arc_interactions_tpu_torch.utils import constants as c
from wrfchem_arc_interactions_tpu_torch.utils import trace

ALBEDO = 0.2
JULIAN_DAY = 172.0   # near-solstice default for ideal runs
# Columns per solver call.  One call peaks at 8.89 GiB for 10,000 columns
# at nz = 50 (NVIDIA H100 80GB HBM3, chip_smoke.py), ~0.95 MB a column, so
# a chunk of 10,240 keeps a call near 9 GiB at any domain size while
# config 3's and config 4's 100x100 domains stay one call, with the same
# launches as unchunked: the step is bound by the host's launch rate, and
# the reference's 2,048 would make their rad call five calls of launches.
COL_CHUNK = 10240


def _map_col_chunks(fn, ncol: int, *args, **kwargs):
    """`fn(*args, **kwargs)` over chunks of at most `COL_CHUNK` columns: a
    tensor argument whose last axis has `ncol` entries is sliced on it,
    anything else is passed whole; the outputs (a dict of tensors whose
    last axis is the column) are joined again."""
    if ncol <= COL_CHUNK:
        with trace.span("chunk"):
            return fn(*args, **kwargs)

    def part(a, lo, hi):
        if isinstance(a, torch.Tensor) and a.dim() and a.shape[-1] == ncol:
            return a[..., lo:hi].contiguous()
        return a

    outs = []
    for lo in range(0, ncol, COL_CHUNK):
        hi = min(lo + COL_CHUNK, ncol)
        with trace.span("chunk"):
            outs.append(fn(*(part(a, lo, hi) for a in args),
                           **{k: part(v, lo, hi) for k, v in kwargs.items()}))
    return {k: torch.cat([o[k] for o in outs], dim=-1) for k in outs[0]}


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A time or a day number as a float32 tensor on `like`'s device (the
    reference carries both as float32)."""
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def cos_zenith(time_s, xlat, xlong, julian_day=JULIAN_DAY):
    """Cosine of the solar zenith angle (fixed declination by julian day,
    hour angle from UTC time + longitude), in float32."""
    time_s, julian_day = _f32(time_s, xlat), _f32(julian_day, xlat)
    decl = -23.45 * c.DEG2RAD * torch.cos(2.0 * torch.pi * (julian_day + 10.0) / 365.0)
    # time is never negative, so fmod is the reference's remainder (exact)
    hour = torch.fmod(time_s / 3600.0, 24.0)
    ha = (hour - 12.0) * 15.0 * c.DEG2RAD + xlong * c.DEG2RAD
    lat = xlat * c.DEG2RAD
    mu = torch.sin(lat) * torch.sin(decl) + torch.cos(lat) * torch.cos(decl) * torch.cos(ha)
    return torch.clamp(mu, min=0.0)


def _columns(state: State, grid: Grid, cfg: Config):
    """Flatten (nz, ny, nx) state to radiation columns (nz, ncol)."""
    diag = diagnose(state, grid, cfg.moist_species())
    nz, ny, nx = diag.theta.shape
    ncol = ny * nx

    def flat(a):
        return a.reshape(a.shape[:-2] + (ncol,))

    p_lay = flat(diag.p_full)
    exner = (p_lay / c.P0) ** c.RCP
    t_lay = flat(diag.theta) * exner
    qtot_fac = 1.0 / flat(diag.eps_ratio)
    dp_lay = flat(diag.mu_full)[None] * (-grid.dnw.reshape(-1, 1)) * qtot_fac
    qv = flat(state["qv"]) if "qv" in state else torch.zeros_like(p_lay)
    qc = flat(state.get("qc", torch.zeros_like(diag.theta)))
    qcond = qc
    if "qi" in state:
        qcond = qcond + flat(state["qi"])
    if "qs" in state:
        qcond = qcond + 0.5 * flat(state["qs"])   # snow is partly radiatively active
    lwp = qcond * dp_lay / c.G
    t_sfc = flat(state["tsk"].reshape(1, ny, nx))[0]
    return p_lay, t_lay, dp_lay, qv, lwp, qcond, t_sfc, exner, (nz, ny, nx)


def radiation_driver(state: State, grid: Grid, cfg: Config, time_s,
                     julian_day=JULIAN_DAY) -> State:
    """RRTMG (or simple) SW + LW on the current state: returns the state with the held
    heating rates (rthraten_sw/lw), the surface and TOA fluxes and, with
    ``icloud=1``, the diagnosed cloud fraction.  `time_s` (seconds of UTC
    time since the run's day start) and `julian_day` are taken as float32."""
    phys = cfg.physics
    p_lay, t_lay, dp_lay, qv, lwp, qcond, t_sfc, exner, (nz, ny, nx) = \
        _columns(state, grid, cfg)
    ncol = ny * nx

    def unflat(a):
        return a.reshape(a.shape[:-1] + (ny, nx))

    aer_sw = aer_lw = None
    if cfg.chem.aer_ra_feedback and "tau_aer_sw" in state:
        def flatb(a):
            return a.reshape(a.shape[0], nz, ncol)
        aer_sw = (flatb(state["tau_aer_sw"]), flatb(state["ssa_aer_sw"]),
                  flatb(state["asy_aer_sw"]))
        aer_lw = flatb(state["tau_aer_lw"])

    # partial cloudiness (icloud=1): Xu-Randall fraction + McICA sampling,
    # seeded by the radiation-call time (float32 truncated to an integer)
    cf = seed = None
    if phys.icloud == 1:
        cf = mcica.xu_randall_cldfra(p_lay, t_lay, qv, qcond)
        seed = _f32(time_s, p_lay).to(torch.int64)

    out = dict(state)
    if cf is not None and "cldfra" in state:
        out["cldfra"] = unflat(cf)
    if phys.ra_lw_physics != RAScheme.NONE:
        with trace.span("lw"):
            if phys.ra_lw_physics == RAScheme.SIMPLE:
                lw = lw_simple(p_lay, t_lay, dp_lay, qv, lwp, t_sfc)
                out["rthraten_lw"] = unflat(lw["heating"] / exner)
                out["glw"] = unflat(lw["glw"])
                out["olr"] = unflat(lw["olr"])
            elif phys.ra_lw_physics == RAScheme.RRTMG:
                kw = {}
                if aer_lw is not None:
                    kw["tau_aer_lw"] = aer_lw
                if cf is not None:
                    kw["cldfra"], kw["mcica_seed"] = cf, seed
                lw = _map_col_chunks(lw_fluxes, ncol, p_lay, t_lay, dp_lay, qv, lwp, t_sfc, **kw)
                out["rthraten_lw"] = unflat(lw["heating"] / exner)
                out["glw"] = unflat(lw["glw"])
                out["olr"] = unflat(lw["olr"])
    if phys.ra_sw_physics != RAScheme.NONE:
        with trace.span("sw"):
            mu0 = cos_zenith(time_s, grid.xlat, grid.xlong,
                             julian_day=julian_day).reshape(ncol)
            albedo = torch.full((ncol,), ALBEDO, dtype=p_lay.dtype, device=p_lay.device)
            if phys.ra_sw_physics == RAScheme.SIMPLE:
                sw = sw_simple(p_lay, t_lay, dp_lay, qv, lwp, mu0, albedo)
                out["rthraten_sw"] = unflat(sw["heating"] / exner)
                out["swdown"] = unflat(sw["swdown"])
                out["swupt"] = unflat(sw["swup_toa"])
            elif phys.ra_sw_physics == RAScheme.RRTMG:
                kw = {}
                if aer_sw is not None:
                    kw["tau_aer_sw"], kw["ssa_aer_sw"], kw["asy_aer_sw"] = aer_sw
                if cf is not None:
                    kw["cldfra"], kw["mcica_seed"] = cf, seed
                # Twomey / first-indirect pathway: prognostic droplet number sets
                # the cloud effective radius re = k_disp (3 qc / (4 pi rho_w
                # Nc))^(1/3) (qc and Nc both per kg air, so the air density
                # cancels), clipped to the 2.5-50 um validity range of the
                # geometric-optics cloud tau
                if phys.progn and "nc" in state and "qc" in state:
                    qc_f = state["qc"].reshape(nz, ncol)
                    nc_f = torch.clamp(state["nc"].reshape(nz, ncol), min=1.0e3)
                    rvol = (3.0 * torch.clamp(qc_f, min=0.0)
                            / (4.0 * np.pi * 1000.0 * nc_f)) ** (1.0 / 3.0)
                    kw["re_liq"] = torch.clamp(1.1 * rvol, 2.5e-6, 50.0e-6)
                sw = _map_col_chunks(sw_fluxes, ncol, p_lay, t_lay, dp_lay, qv, lwp, mu0, albedo,
                                      **kw)
                out["rthraten_sw"] = unflat(sw["heating"] / exner)
                out["swdown"] = unflat(sw["swdown"])
                out["swupt"] = unflat(sw["swup_toa"])
    return out
