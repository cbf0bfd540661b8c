"""Run-time configuration tree — the `namelist.input` equivalent.

A verbatim copy of the JAX package's `config/namelist.py` (the port keeps
its own copy and imports nothing of that package), so that one set of
option values means the same thing to both.  The reference parses
`namelist.input` into a Registry-generated `model_config_rec` (canonical
WRF: `frame/module_configure.F`) with groups &time_control, &domains,
&physics, &dynamics, &chem; here the same role is played by a tree of
frozen (hashable) dataclasses.  Options that the port does not carry yet
raise `NotImplementedError` where the port reads them
(`utils/support.py`).

Option values deliberately mirror the reference's namelist vocabulary
(e.g. ``mp_physics``, ``ra_sw_physics``, ``aer_ra_feedback``, ``chem_opt``,
``diff_opt``/``km_opt``, ``moist_adv_opt``) so a WRF-Chem user can map their
namelist onto this config one field at a time; integer option codes are
replaced by enums/strings.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class BCKind(str, enum.Enum):
    """Lateral boundary condition kind per axis (share/module_bc.F analog)."""

    PERIODIC = "periodic"
    OPEN = "open"          # radiative outflow / zero-gradient inflow
    SYMMETRIC = "symmetric"
    SPECIFIED = "specified"  # Davies spec+relax zones fed by boundary data
                             # (models/lateral_bc.py; halo fill is edge-
                             # replicated, the forcing is post-step)


class MPScheme(str, enum.Enum):
    """Microphysics option (`mp_physics`)."""

    NONE = "none"
    KESSLER = "kessler"            # warm rain (mp_physics=1)
    WSM6 = "wsm6"                  # single-moment 6-class (mp_physics=6)
    MORRISON2 = "morrison2"        # 2-moment, prognostic Nc for ARC (mp_physics=10)


class RAScheme(str, enum.Enum):
    """Radiation option (`ra_sw_physics` / `ra_lw_physics`)."""

    NONE = "none"
    RRTMG = "rrtmg"                # ra_*_physics=4
    SIMPLE = "simple"              # Dudhia-SW / gray-LW style cheap scheme


class PBLScheme(str, enum.Enum):
    NONE = "none"
    YSU = "ysu"                    # bl_pbl_physics=1
    MYNN = "mynn"                  # bl_pbl_physics=5 (level-2.5 TKE)


class CUScheme(str, enum.Enum):
    NONE = "none"                  # convection-permitting (cu_physics=0)
    BMJ = "bmj"                    # Betts-Miller-Janjic adjustment (cu_physics=2)
    GRELL = "grell"                # Grell-Devenyi-style ensemble (cu_physics=3/5)
    KF = "kf"                      # Kain-Fritsch-style mass flux (cu_physics=1)


class SFScheme(str, enum.Enum):
    NONE = "none"
    REVISED_MM5 = "revised_mm5"    # sf_sfclay_physics=1 analog + slab LSM


class SFSurface(str, enum.Enum):
    """Land-surface model (`sf_surface_physics`)."""

    SLAB = "slab"                  # thermal-slab skin (sf_surface_physics=1)
    NOAH = "noah"                  # 4-layer soil T/moisture + canopy
                                   # resistance (sf_surface_physics=2 analog)


class AdvOrder(int, enum.Enum):
    """Horizontal advection order (h_sca_adv_order / h_mom_adv_order)."""

    SECOND = 2
    THIRD = 3
    FOURTH = 4
    FIFTH = 5
    SIXTH = 6
    WENO5 = 7                      # 5th-order WENO (advect_weno*; *_adv_opt=3)


class AdvLimiter(str, enum.Enum):
    """Scalar advection limiter (moist_adv_opt / chem_adv_opt analog)."""

    NONE = "none"
    POSITIVE_DEFINITE = "pd"       # moist_adv_opt=1
    MONOTONIC = "mono"             # moist_adv_opt=2


class DiffOpt(str, enum.Enum):
    NONE = "none"
    SIMPLE = "simple"              # diff_opt=1: 2nd order on coordinate surfaces
    FULL = "full"                  # diff_opt=2: physical-space


class KMOpt(str, enum.Enum):
    CONSTANT = "constant"          # km_opt=1
    SMAGORINSKY_3D = "smag3d"      # km_opt=3
    SMAGORINSKY_2D = "smag2d"      # km_opt=4 (horizontal only; PBL does vertical)
    TKE_15 = "tke"                 # km_opt=2: 1.5-order TKE closure


class ChemOpt(str, enum.Enum):
    """Chemistry package (`chem_opt`)."""

    NONE = "none"
    MOSAIC_4BIN = "mosaic_4bin"        # aerosol-only MOSAIC, 4 sectional bins
    MOSAIC_8BIN = "mosaic_8bin"
    CBMZ_MOSAIC_4BIN = "cbmz_mosaic_4bin"  # gas-phase CBMZ + 4-bin MOSAIC
    CBMZ_MOSAIC_8BIN = "cbmz_mosaic_8bin"


@dataclasses.dataclass(frozen=True)
class TimeControl:
    """&time_control analog."""

    dt: float = 6.0                    # model timestep [s] (time_step)
    run_seconds: float = 3600.0
    history_interval_s: float = 600.0
    restart_interval_s: float = 0.0    # 0 => no restart writes
    auxhist_interval_s: float = 0.0    # pressure-level diag stream (io/diags)
    restart: bool = False
    # calendar start (start_year/month/... collapsed to one WRF ISO
    # timestamp; drives the solar ephemeris + history timestamps via
    # utils/clock.py — the ESMF-time analog).  Midnight default keeps the
    # ideal cases' legacy "time_s == UTC hour" convention, and June 20
    # makes julian_day() == the radiation driver's near-solstice default
    # (172), so default configs trace the byte-identical legacy program
    # and keep hitting the persistent compile cache.
    start_date: str = "2000-06-20_00:00:00"
    # tslist analog (canonical share/wrf_timeseries.F): ((label, j, i), ...)
    # grid points whose surface time series are recorded every step
    ts_points: tuple = ()


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """&domains analog: grid dimensions and spacing (single domain; nesting
    is out of scope per SURVEY.md §2.5 'Nest concurrency')."""

    nx: int = 64                       # mass points west-east  (e_we-1)
    ny: int = 64                       # mass points south-north (e_sn-1)
    nz: int = 40                       # mass levels             (e_vert-1)
    dx: float = 1000.0                 # [m]
    dy: float = 1000.0                 # [m]
    ztop: float = 20000.0              # model top height for ideal eta levels [m]
    p_top: float = 5000.0              # pressure at model top [Pa]


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """&physics analog."""

    mp_physics: MPScheme = MPScheme.KESSLER
    ra_sw_physics: RAScheme = RAScheme.NONE
    ra_lw_physics: RAScheme = RAScheme.NONE
    radt_s: float = 600.0              # radiation call interval [s] (radt, in s not min)
    icloud: int = 1                    # 0: overcast where lwp>0; 1: Xu-Randall
                                       # cloud fraction + McICA subcolumn overlap
    bl_pbl_physics: PBLScheme = PBLScheme.NONE
    sf_sfclay_physics: SFScheme = SFScheme.NONE
    sf_surface_physics: SFSurface = SFSurface.SLAB
    cu_physics: CUScheme = CUScheme.NONE
    progn: bool = False                # prognostic droplet number (ARC indirect effect)
    num_land_cat: int = 2
    tke_heat_flux: float = 0.0         # LES: imposed kinematic surface heat
                                       # flux [K m/s] (em_les's tke_heat_flux)


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """&dynamics analog."""

    rk_order: int = 3
    time_step_sound: int = 4           # acoustic substeps per dt (0 => auto)
    # overlap acoustic-loop halo exchanges with interior compute (the
    # RSL_LITE latency-hiding analog); False = blocking exchange-then-
    # compute, the A/B lever for measuring the overlap win
    overlap_halo: bool = True
    h_mom_adv_order: AdvOrder = AdvOrder.FIFTH
    v_mom_adv_order: AdvOrder = AdvOrder.THIRD
    h_sca_adv_order: AdvOrder = AdvOrder.FIFTH
    v_sca_adv_order: AdvOrder = AdvOrder.THIRD
    moist_adv_opt: AdvLimiter = AdvLimiter.POSITIVE_DEFINITE
    chem_adv_opt: AdvLimiter = AdvLimiter.POSITIVE_DEFINITE
    # advect scalars as ONE stacked (n_tracers, nz, ny, nx) pass when at
    # least this many are carried.  Measured on the v5e the per-tracer
    # loop is FASTER at every tested tracer count (3 tracers: 44 vs 77 ms;
    # 47 tracers: 44 vs 70 ms — XLA's 4D-batched stencil layouts lose more
    # than the op-count win), so the default effectively disables stacking;
    # the stacked path remains available (and equivalence-tested) for
    # configs where program size matters more than step time.
    stack_tracer_min: int = 1_000_000
    # lax.scan over the stacked tracers: the per-tracer advection body is
    # traced ONCE, so the HLO stays O(1) in tracer count (the 3-stage x
    # n-tracer instantiation blowup was the 200x200 cold-compile killer)
    # AND it measured FASTER than the unrolled loop on the v5e at 44
    # tracers (5.7 vs 6.2 ms plain stage, 7.8 vs 10.4 ms PD stage —
    # round-5 A/B).  Tracers carrying physics tendencies stay on the
    # unrolled path; below this count the loop is used (scan overhead
    # dominates at moist-only counts).
    scan_tracer_min: int = 8
    # Canonical chem-scalar treatment (solve_em.F: chem/tracer arrays are
    # advected ONLY on the final RK3 stage, as one flux-form update from
    # the step-start value with the time-averaged acoustic mass fluxes and
    # the chem_adv_opt limiter; moist + TKE ride every stage because the
    # stage diagnostics consume them).  Cuts chem advection work AND the
    # stage-0/1 scalar halo traffic by 3x; set False to advect every
    # tracer in every stage.
    chem_adv_final_only: bool = True
    diff_opt: DiffOpt = DiffOpt.SIMPLE
    km_opt: KMOpt = KMOpt.SMAGORINSKY_3D
    khdif: float = 0.0                 # background horizontal diffusivity [m2/s]
    kvdif: float = 0.0
    smdiv: float = 0.1                 # divergence damping coefficient
    emdiv: float = 0.01                # external-mode filter coefficient
    epssm: float = 0.1                 # acoustic time off-centering beta
    w_damping: bool = True
    damp_opt: int = 3                  # 3: Rayleigh w-damping layer (implicit)
    zdamp: float = 5000.0              # depth of damping layer [m]
    dampcoef: float = 0.2
    diff_6th_opt: int = 0              # 0 off, 1 on, 2 monotonic
    diff_6th_factor: float = 0.12
    # polar Fourier filtering for global lat-lon runs (canonical
    # &dynamics fft_filter_lat + dyn_em/module_polar_fft.F): rows poleward
    # of this latitude are zonally truncated each RK stage so the pole
    # rows' collapsing dx*cos(lat) doesn't set the domain CFL.  > 90
    # disables (limited-area default); requires the x axis unsharded.
    fft_filter_lat: float = 91.0
    mix_full_fields: bool = True
    bc_x: BCKind = BCKind.PERIODIC
    bc_y: BCKind = BCKind.PERIODIC
    spec_zone: int = 1             # &bdy_control spec_zone (specified rows)
    relax_zone: int = 4            # &bdy_control relax_zone (Davies nudging)
    sppt_amp: float = 0.0          # &stoch sppt analog: tendency perturbation
    skebs_amp: float = 0.0         # &stoch skebs analog: KE backscatter [m/s2]


@dataclasses.dataclass(frozen=True)
class ChemConfig:
    """&chem analog — the knobs the ARC-Interactions scenario repo varies
    between paired runs (SURVEY.md §0.1, §5.6)."""

    chem_opt: ChemOpt = ChemOpt.NONE
    chemdt_s: float = 60.0             # chemistry call interval [s]
    aer_ra_feedback: bool = False      # aerosol direct effect on radiation
    wetscav_onoff: bool = False
    cldchem_onoff: bool = False
    vertmix_onoff: bool = True
    gaschem_onoff: bool = True
    aerchem_onoff: bool = True
    phot_opt: int = 2                  # 1: bulk gray scaling; 2: Fast-J spectral
    drydep_opt: bool = True
    emiss_opt: bool = False
    aer_op_opt: int = 1                # 1: volume-mixing Mie; 2: Maxwell-Garnett; 3: core-shell
    # KPP-style adaptive error control in the gas solver (per-cell
    # accept/reject Rosenbrock stepping, gas.integrate_adaptive); the
    # fixed-substep path is the faster production default
    gas_adaptive: bool = False
    gas_rtol: float = 1e-3
    gas_atol: float = 1e3              # [molec/cm3] (~4e-14 ppmv)


@dataclasses.dataclass(frozen=True)
class FDDAConfig:
    """Analysis (grid) nudging — the &fdda namelist group (canonical:
    phys/module_fdda_psufddagd.F; grid_fdda=1).  Interior relaxation of
    u, v, theta, qv toward a time-interpolated analysis with the standard
    WRF coefficients [1/s]; `k_start` masks nudging below that level (the
    if_no_pbl_nudging analog, as a sharp level cutoff)."""

    grid_fdda: bool = False
    guv: float = 3.0e-4               # wind nudging coefficient [1/s]
    gt: float = 3.0e-4                # potential-temperature coefficient
    gq: float = 3.0e-5                # moisture coefficient
    k_start: int = 0                  # lowest nudged level (0 = all levels)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (the RSL_LITE `nproc_x`/`nproc_y` analog)."""

    mesh_x: int = 1                    # devices along west-east
    mesh_y: int = 1                    # devices along south-north
    halo_fuse: bool = True             # pack same-shape fields into one exchange


@dataclasses.dataclass(frozen=True)
class Config:
    time_control: TimeControl = TimeControl()
    domain: DomainConfig = DomainConfig()
    physics: PhysicsConfig = PhysicsConfig()
    dynamics: DynamicsConfig = DynamicsConfig()
    chem: ChemConfig = ChemConfig()
    fdda: FDDAConfig = FDDAConfig()
    parallel: ParallelConfig = ParallelConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def n_acoustic(self) -> int:
        """Acoustic substeps per RK step (time_step_sound; auto = 4 like WRF's
        default guidance dt[s] <= 6*dx[km] with 4 sound steps).

        Additionally bound the substep by the explicit buoyancy coupling of
        the split scheme, N*dtau <~ 0.2 (tropospheric N ~ 0.012 1/s):
        synoptic configurations with large absolute dt (e.g. dt=120 s at
        dx=60 km) are acoustically lazy but BUOYANCY-unstable at dtau=30 s —
        observed as a slow gravity-mode blowup after ~40 steps; dtau <= 16 s
        keeps N*dtau < 0.2 with margin."""
        ns = self.dynamics.time_step_sound
        if ns <= 0:
            ns = max(4, 2 * int(self.time_control.dt / (self.domain.dx / 1000.0) / 2 + 1))
            # buoyancy bound applies only on the auto path: an explicit
            # namelist time_step_sound is honored verbatim (the reference
            # never overrides an explicit setting either)
            ns = max(ns, int(self.time_control.dt / 16.0) + 1)
        # forward-backward acoustic integration needs an even count on the
        # full-dt stage so the 3-stage RK divides it as ns/3(>=1), ns/2, ns
        return ns + (ns % 2)

    def moist_species(self) -> Tuple[str, ...]:
        mp = self.physics.mp_physics
        if mp == MPScheme.NONE:
            return ("qv",)
        if mp == MPScheme.KESSLER:
            return ("qv", "qc", "qr")
        if mp == MPScheme.WSM6:
            return ("qv", "qc", "qr", "qi", "qs", "qg")
        if mp == MPScheme.MORRISON2:
            # mass: vapor, cloud, rain, ice, snow, graupel; number: cloud (if
            # progn), rain, ice, snow, graupel — Morrison 2-moment set.
            # qgv: prognostic graupel (rime) VOLUME mixing ratio [m3/kg],
            # giving a variable bulk rime density rho_g = qg/qgv (canonical:
            # the rime-density/wet-growth physics of
            # module_mp_morr_two_moment.F, in the P3-style bulk-volume form).
            return ("qv", "qc", "qr", "qi", "qs", "qg", "nc", "nr", "ni",
                    "ns", "ng", "qgv")
        raise ValueError(mp)
