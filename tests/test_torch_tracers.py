"""The port's fused multi-tracer stage update against the JAX package, on
identical seeded inputs (both on the CPU): its plain version against the
TPU kernel `advect_tracers_fused` run in interpret mode (periodic
boundaries, with and without the PD limiter and the clip), and, with a
physics-tendency stack, against the reference's scan body (the per-tracer
chain of `dycore/solve.py`) on periodic, open and symmetric boundaries.
Tolerance: 1e-5 of max |q| (float32; the same operations in the same
order, up to the TPU kernel's in-kernel factor recomputation).  The same
comparison with the scan body at the small shapes that stress the CUDA
kernel's tile and its ring of planes (1 to 5 levels, one row, rows that do
not fill the last tile, rows narrower and wider than a warp), and on a row
of 1,000 cells, which the kernel splits into x tiles.  The
wrapper's input checks, and on the CUDA card the kernel against its plain
version at all of these shapes (skipped without one).  The dycore's one
route for a stack of scalars (`solve._advance_stack`) row by row equal to
the per-scalar update of each row.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.config.namelist import BCKind as JBC  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import advection as jadv  # noqa: E402
from wrfchem_arc_interactions_tpu.grid import make_grid as jmake_grid  # noqa: E402
from wrfchem_arc_interactions_tpu.models import soundings  # noqa: E402
from wrfchem_arc_interactions_tpu.ops.pallas_adv_multi import advect_tracers_fused  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch.config.namelist import AdvLimiter  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind as TBC  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import adv_kernel, tracers_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps as THalo  # noqa: E402

from test_torch_slice import jax_grid_to_port  # noqa: E402

NT, NZ, NY, NX = 2, 6, 8, 12
DTS = 6.0
# (nz, ny, nx) that stress the CUDA kernel's ring of planes (fewer levels than
# the ring holds), its tile (one row; rows that do not fill the last tile)
# and its slots (rows narrower and wider than a warp; a row wider than one
# tile spans, in x tiles)
SHAPES = ((1, 1, 13), (2, 5, 33), (3, 9, 13), (5, 17, 33), (2, 4, 300))


def _boundary_cases():
    """(nz, ny, nx, bc_x, bc_y) over SHAPES and the three lateral boundary
    kinds.  A boundary's halo of 3 needs 3 rows (periodic) or 4 (symmetric);
    a single row is open in y and takes each kind in x."""
    cases = []
    for nz, ny, nx in SHAPES:
        for bc in ("open", "symmetric", "periodic"):
            need = {"open": 1, "periodic": 3, "symmetric": 4}[bc]
            cases.append((nz, ny, nx, bc, bc if ny >= need else "open"))
    return cases


@functools.lru_cache(maxsize=None)
def _grids(nz, ny, nx):
    cfg = jcfg.Config(domain=jcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0,
                                               dy=800.0, ztop=17000.0,
                                               p_top=8000.0))
    jg = jmake_grid(cfg, soundings.weisman_klemp_theta())
    return jg, jax_grid_to_port(jg)


@pytest.fixture(scope="module")
def grids():
    return _grids(NZ, NY, NX)


def _max_rel(ref, out, q):
    d = np.abs(np.asarray(ref, np.float64) - np.asarray(out, np.float64)).max()
    return float(d / np.abs(np.asarray(q)).max())


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _inputs(grid, seed=0, nt=NT):
    """Interior fields on `grid`: sparse tracers (half the cells empty, so
    the PD limiter acts), coupled winds of ~20 m/s and vertical Courant
    ~0.3, the stage and new column masses, physics tendencies."""
    rng = np.random.default_rng(seed)
    mub = np.asarray(grid.mub.numpy(), np.float64)
    NZ, (NY, NX) = grid.nz, mub.shape
    NT = nt
    q = rng.uniform(0.0, 2.0, (NT, NZ, NY, NX)) * (rng.uniform(size=(NT, NZ, NY, NX)) > 0.5)
    mu0 = mub * rng.uniform(0.995, 1.005, mub.shape)
    mu_full = mub * rng.uniform(0.995, 1.005, mub.shape)
    mu_new = mub * rng.uniform(0.995, 1.005, mub.shape)
    ru = mu_full * rng.normal(0.0, 20.0, (NZ, NY, NX))
    rv = mu_full * rng.normal(0.0, 20.0, (NZ, NY, NX))
    ww = rng.normal(0.0, 100.0, (NZ + 1, NY, NX))
    ww[0] = ww[-1] = 0.0
    pt = rng.normal(0.0, 1e-3, (NT, NZ, NY, NX))
    f = {"q": q, "phi": mu0 * q, "ru": ru, "rv": rv, "ww": ww, "mu_full": mu_full,
         "mu_new": mu_new, "pt": pt}
    return {k: v.astype(np.float32) for k, v in f.items()}


def _port(tg, f, bc, pd, clip, pt=True, bc_y=None):
    hx = THalo(bc_x=TBC(bc), bc_y=TBC(bc_y or bc))
    ru_pad, rv_pad = hx.pad(_t(f["ru"]), 3), hx.pad(_t(f["rv"]), 3)
    return tracers_kernel.advect_tracers(
        hx.pad(_t(f["q"]), 3), _t(f["phi"]), ru_pad, rv_pad, _t(f["ww"]),
        _t(f["mu_full"]), _t(f["mu_new"]), tg, hx, DTS,
        pt=_t(f["pt"]) if pt else None, pd=pd, clip=clip)


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_plain_matches_pallas_interpret(grids, pd, clip):
    jg, tg = grids
    f = _inputs(tg, seed=1)
    hx = JHalo()
    out = _port(tg, f, "periodic", pd, clip, pt=False)
    want = advect_tracers_fused(
        hx.pad(jnp.asarray(f["q"]), 4), hx.pad(jnp.asarray(f["phi"]), 2),
        hx.pad(jnp.asarray(f["ru"]), 4), hx.pad(jnp.asarray(f["rv"]), 4),
        hx.pad(jnp.asarray(f["ww"]), 2), jnp.asarray(f["mu_new"]), jg.rdnw,
        tg.rdx, tg.rdy, DTS, pd=pd, clip=clip, interpret=True)
    assert want.shape == tuple(out.shape)
    assert _max_rel(want, out, f["q"]) <= 1e-5
    if pd:      # the inputs are strong enough for the limiter to act
        assert _max_rel(_port(tg, f, "periodic", False, clip, pt=False), out, f["q"]) > 1e-3
    if clip:
        assert float(out.min()) >= 0.0
    elif pd:
        assert float(out.min()) >= -1e-6 * float(np.abs(f["q"]).max())


def _scan_body(jg, f, bc, pd, clip, bc_y=None):
    """The reference's scan body (solve.py), tracer by tracer."""
    hx = JHalo(bc_x=JBC(bc), bc_y=JBC(bc_y or bc))
    q_pad = hx.pad(jnp.asarray(f["q"]), 3)
    ru, rv, ww = hx.pad(jnp.asarray(f["ru"]), 3), hx.pad(jnp.asarray(f["rv"]), 3), \
        jnp.asarray(f["ww"])
    mu_full, mu_new = jnp.asarray(f["mu_full"]), jnp.asarray(f["mu_new"])
    out = []
    for i in range(f["q"].shape[0]):
        phi_q, pt_q = jnp.asarray(f["phi"][i]), jnp.asarray(f["pt"][i])
        fx, fy, fz = jadv.scalar_fluxes(q_pad[i], ru, rv, ww, 5, 3)
        if pd:
            fx, fy, fz = jadv.pd_limit(q_pad[i], phi_q, fx, fy, fz, ru, rv, ww, DTS,
                                       jg, hx)
        tend = jadv.flux_div(fx, fy, fz, jg) + mu_full[None] * pt_q
        qn = (phi_q + DTS * tend) / mu_new[None]
        out.append(jnp.maximum(qn, 0.0) if clip else qn)
    return np.stack([np.asarray(a) for a in out])


@pytest.mark.parametrize("bc", ["periodic", "open", "symmetric"])
@pytest.mark.parametrize("pd", [False, True])
def test_plain_with_tendencies_matches_scan_body(grids, bc, pd):
    jg, tg = grids
    f = _inputs(tg, seed=2)
    want = _scan_body(jg, f, bc, pd, clip=pd)
    out = _port(tg, f, bc, pd, clip=pd)
    assert _max_rel(want, out, f["q"]) <= 1e-5


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", _boundary_cases(), ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_scan_body_at_tile_and_ring_shapes(case, pd):
    """What the CUDA kernel is held to, against the reference, where the
    kernel's ring (nz below its depth), tile (ny = 1, a ragged last tile)
    and slots (nx = 13, 33) are stressed, on every boundary kind."""
    nz, ny, nx, bc_x, bc_y = case
    jg, tg = _grids(nz, ny, nx)
    f = _inputs(tg, seed=4 + nz)
    assert f["q"].shape == (NT, nz, ny, nx)
    want = _scan_body(jg, f, bc_x, pd, clip=pd, bc_y=bc_y)
    out = _port(tg, f, bc_x, pd, clip=pd, bc_y=bc_y)
    assert tuple(out.shape) == want.shape
    assert _max_rel(want, out, f["q"]) <= 1e-5
    if pd:
        assert float(out.min()) >= 0.0


@pytest.mark.parametrize("msf", [False, True], ids=["flat", "m2"])
@pytest.mark.parametrize("limiter", ["none", "pd", "mono"])
def test_stack_route_equals_per_scalar_updates(grids, limiter, msf):
    """`solve._advance_stack`, the update of every scalar stack in a step,
    equals the per-scalar update of each of its rows bit for bit, on a
    flat grid and with m2 = msft^2: without a limiter the scalar kernel's
    tendency and the inline coupled update, under the PD or the monotonic
    limiter `_plain_update` on the row alone.  The second row has no
    physics tendency: the stack carries a row of zeros for it, a scalar
    alone carries none."""
    _, tg = grids
    if msf:
        msft = np.random.default_rng(5).uniform(0.95, 1.05, tuple(tg.mub.shape))
        tg = dataclasses.replace(tg, msft=_t(msft), curvature=True)
    m2 = tracers_kernel.map_factor_sq(tg)
    f = {k: _t(v) for k, v in _inputs(tg, seed=3, nt=3).items()}
    f["pt"][1] = 0.0
    hx = THalo()
    q_pad, ru, rv = (hx.pad(f[k], 3) for k in ("q", "ru", "rv"))
    phi, pt, ww, mu_full, mu_new = (f[k] for k in ("phi", "pt", "ww", "mu_full", "mu_new"))
    args = (ru, rv, ww, mu_full, mu_new, DTS, tg, hx, 5, 3)
    lim = AdvLimiter(limiter)
    stack = tsolve._advance_stack(q_pad, phi, pt, lim, *args, m2=m2)
    assert stack.shape == f["q"].shape
    for i in range(stack.shape[0]):
        pt_i = None if i == 1 else pt[i]
        if lim == AdvLimiter.NONE:
            tend = (adv_kernel.advect_scalar_5_3(q_pad[i], ru, rv, ww, tg.rdnw, tg.rdx, tg.rdy,
                                                 m2=m2)
                    + mu_full[None] * (0.0 if pt_i is None else pt_i))
            row = (phi[i] + DTS * tend) / mu_new[None]
        else:
            row = tsolve._plain_update(q_pad[i], phi[i], pt_i, lim, *args, m2=m2)
        assert torch.equal(stack[i], row), i
    if lim != AdvLimiter.NONE:      # the limiter acts on these inputs
        free = tsolve._advance_stack(q_pad, phi, pt, AdvLimiter.NONE, *args, m2=m2)
        assert float((free - stack).abs().max()) > 1e-3 * float(f["q"].abs().max())
        assert float(stack.min()) >= 0.0


@pytest.mark.parametrize("bad", ["dtype", "phi_shape", "ww_shape", "pt_shape",
                                  "contiguous", "rank", "msf"])
def test_wrapper_rejects_bad_inputs(grids, bad):
    _, tg = grids
    f = {k: _t(v) for k, v in _inputs(tg).items()}
    hx = THalo()
    q_pad, ru, rv = hx.pad(f["q"], 3), hx.pad(f["ru"], 3), hx.pad(f["rv"], 3)
    phi, ww, pt, grid = f["phi"], f["ww"], f["pt"], tg
    if bad == "dtype":
        phi = phi.double()
    elif bad == "phi_shape":
        phi = phi[:, 1:].contiguous()
    elif bad == "ww_shape":
        ww = ww[:-1].contiguous()
    elif bad == "pt_shape":
        pt = pt[:1].contiguous()
    elif bad == "contiguous":
        ru = ru.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "rank":
        q_pad = q_pad[0]
    elif bad == "msf":
        # a projected grid whose map factor does not match the tracers' grid
        grid = dataclasses.replace(tg, msft=tg.msft[:-1].contiguous(), curvature=True)
    with pytest.raises((TypeError, ValueError)):
        tracers_kernel.advect_tracers(q_pad, phi, ru, rv, ww, f["mu_full"],
                                      f["mu_new"], grid, hx, DTS, pt=pt, pd=True,
                                      clip=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(NZ, NY, NX, bc, bc) for bc in ("periodic", "open", "symmetric")]
                         + _boundary_cases(), ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_gpu(case):
    """The CUDA kernel against its plain version on the card, with and
    without the limiter: the build uses --fmad=false, so the two round
    alike; the bound is 1e-5 of max |q|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    nz, ny, nx, bc_x, bc_y = case
    _, tg = _grids(nz, ny, nx)
    dev = torch.device("cuda")
    g = tg.to(dev)
    hx = THalo(bc_x=TBC(bc_x), bc_y=TBC(bc_y))
    f = {k: _t(v).to(dev) for k, v in _inputs(tg, seed=3, nt=3).items()}
    args = (hx.pad(f["q"], 3), f["phi"], hx.pad(f["ru"], 3), hx.pad(f["rv"], 3),
            f["ww"], f["mu_full"], f["mu_new"], g, hx, DTS)
    grids = {False: tracers_kernel.GRIDS_PLAIN, True: tracers_kernel.GRIDS_LIMITED}
    for pd in (False, True):
        n0 = tracers_kernel.advect_tracers.launches
        out = tracers_kernel.advect_tracers(*args, pt=f["pt"], pd=pd, clip=pd)
        ref = tracers_kernel.advect_tracers_reference(*args, pt=f["pt"], pd=pd, clip=pd)
        torch.cuda.synchronize()
        assert tracers_kernel.advect_tracers.launches == n0 + grids[pd]
        assert float((out - ref).abs().max() / f["q"].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_rejects_a_row_too_wide_on_gpu():
    """No row is too wide: a row of 1,200 cells, which the kernel refused
    before it split rows into x tiles, matches its plain version on the
    card, with and without the limiter, on each boundary kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    nz, ny, nx = 2, 4, 1200
    assert nx > tracers_kernel.widest_row(False) >= tracers_kernel.widest_row(True)
    _, tg = _grids(nz, ny, nx)
    dev = torch.device("cuda")
    g = tg.to(dev)
    f = {k: _t(v).to(dev) for k, v in _inputs(tg, seed=8).items()}
    for bc in ("periodic", "open", "symmetric"):
        hx = THalo(bc_x=TBC(bc), bc_y=TBC(bc))
        args = (hx.pad(f["q"], 3), f["phi"], hx.pad(f["ru"], 3), hx.pad(f["rv"], 3),
                f["ww"], f["mu_full"], f["mu_new"], g, hx, DTS)
        for pd in (False, True):
            out = tracers_kernel.advect_tracers(*args, pt=f["pt"], pd=pd, clip=pd)
            ref = tracers_kernel.advect_tracers_reference(*args, pt=f["pt"], pd=pd, clip=pd)
            assert torch.equal(out, ref), (bc, pd)


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("bc", ["periodic", "open", "symmetric"])
def test_plain_matches_scan_body_on_a_row_wider_than_a_tile(bc, pd):
    """At nx = 1000 (the CUDA kernel splits such a row into x tiles; the
    reference's scan body runs any nx), nz 2, ny 4, against the scan body."""
    nz, ny, nx = 2, 4, 1000
    jg, tg = _grids(nz, ny, nx)
    f = _inputs(tg, seed=9)
    bc_y = "open" if bc == "symmetric" else bc
    want = _scan_body(jg, f, bc, pd, clip=pd, bc_y=bc_y)
    out = _port(tg, f, bc, pd, clip=pd, bc_y=bc_y)
    assert _max_rel(want, out, f["q"]) <= 1e-5
