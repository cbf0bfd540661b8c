"""The port's hand-written CUDA sources, run on the CPU.

There is no CUDA compiler beside the CPU tests, so what a kernel's source
computes is otherwise checked only on the card.  Here a host C++ compiler
builds the source itself against a stand-in for ``cuda_runtime.h``
(``tests/cuda_emulation/cuda_runtime.h``: one host thread per CUDA thread,
a barrier for ``__syncthreads()``, shared memory filled with NaNs before
each block, a warp shuffle as a block-wide exchange), after the few
constructs it cannot parse are rewritten: the
``<<<...>>>`` launch becomes a call, a ``cp.async`` copy an assignment (its
commit and wait a no-op), the ``extern __shared__`` array a pointer.  Built
with ``-ffp-contract=off`` the float arithmetic rounds as the card's does
under ``--fmad=false``, so a kernel built with that flag is held *bitwise*
to its plain PyTorch version:

- ``csrc/advect_scalar_5_3.cu`` at small shapes that stress its z chunks
  (ragged ones among them), its warps of 31 cells and the x faces they pass
  by shuffle, and the rows a thread owns, on rows whose starts fall off 16
  bytes, on a flat grid and with a map factor;
- ``csrc/advect_tracers.cu`` at the small shapes that stress its tile, its
  rings of planes and its slots, and at rows wider than one tile (its x
  tiles), on every lateral boundary kind (specified too), with and without
  the limiter, on a flat grid and with a map factor, and on the shapes
  whose launch plans the test of its plans names (a 500-cell row at 16
  rows, 100 and 50 cells); the limited grid also on tiles of several rows
  and x tiles whose 2-cell ring crosses a periodic edge (and its fourth
  ring of q, which the wrapped cells give), with and without a tendency
  stack and the clip; its plans themselves; and on the blocks of process
  meshes, with seams on one to four sides and x tiles, against the plain
  version on the whole domain;
- the ROS2 gas kernel that ``ops/ros2_kernel.py`` generates, for one and two
  substeps over a few blocks of its persistent grid;
- ``csrc/diffuse_scalars.cu`` inside `diffusion_tendencies` on a squall-line
  case, with and without the vertical term and the 6th-order filter, on
  slices of 1, 3 and 18 scalars, with K from the Smagorinsky closure and
  from the TKE closure, on a domain whose tiles end ragged in x and y;
- ``csrc/advance_w.cu`` inside `solve.step`, on every acoustic substep's
  own inputs: on a flat grid with and without the damping profile, over
  terrain (the kinematic surface row), with a map factor and with both, at
  11, 51 and 61 w-levels, on column counts that end ragged against its
  blocks of 32; and on a block cut from a domain against the same columns
  of the whole.

``csrc/mie_cheb_eval.cu`` is built with multiply-add contraction
(``-ffp-contract=fast``, as ``ops/build.py`` builds it without
``--fmad=false``) and held to its plain version within 1e-5 on random,
warp-coherent and edge inputs.

What this cannot see: races (the host threads are few at a time), the
card's alignment rules, and whether ``nvcc`` accepts the source.
Registers, spills and blocks an SM are the card's:
the stand-in reports none, and blocks an SM by threads and shared memory
alone.  Skipped where no host C++ compiler is installed.
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import gas as tgas  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind, KMOpt  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import diffusion as tdiff  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import solve as tsolve  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import projection as tproj  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import ideal as tideal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models import real as treal  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import (  # noqa: E402
    adv_kernel, advance_w_kernel, build, diffusion_kernel, mie_kernel, ros2_kernel,
    tracers_kernel,
)
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.mesh import Mesh  # noqa: E402

from test_torch_gas import polluted_start  # noqa: E402
from test_torch_tracers import _boundary_cases, _grids, _inputs, _t  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

_REWRITES = (
    (r"extern __shared__ (?:__align__\(16\) )?(float4?) (\w+)\[\];",
     r"\1* \2 = reinterpret_cast<\1*>(emu_smem);"),
    (r"^.*__cvta_generic_to_shared.*$", ""),
    (r"^.*cp\.async\.ca\.shared\.global.*$", "  *dst = *src;"),
    (r"^.*cp\.async\.cg\.shared\.global.*$", "  for (int e_ = 0; e_ < 4; ++e_) dst[e_] = src[e_];"),
    (r"^.*cp\.async\.(?:wait_all|wait_group|commit_group).*$", "  ;"),
    (r"([\w<>, ]+?)<<<([^,]+), ([^,]+), ([^,]+), \w+>>>\((.*)\);", r"emu_launch(\1, \2, \3, \4, \5);"),
)


def _emulated(text: str, name: str, tmp, contract: str = "off") -> ctypes.CDLL:
    """Rewrite CUDA source `text` for a host compiler, build and load it;
    `contract` is the host compiler's -ffp-contract setting."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    for pat, rep in _REWRITES:
        text, n = re.subn(pat, rep, text, flags=re.M)
    assert "<<<" not in text and "emu_launch(" in text
    src, lib = os.path.join(tmp, f"{name}.cpp"), os.path.join(tmp, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([cxx, "-std=c++17", "-O1", f"-ffp-contract={contract}", "-fPIC", "-shared",
                    "-pthread", f"-I{os.path.join(HERE, 'cuda_emulation')}", "-o", lib, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def tracers_lib(tmp_path_factory):
    with open(build._source("advect_tracers")) as f:
        lib = _emulated(f.read(), "advect_tracers", str(tmp_path_factory.mktemp("emu")))
    lib.advect_tracers.argtypes = tracers_kernel._ARGTYPES
    lib.advect_tracers.restype = ctypes.c_int
    return lib


# the shapes of `test_emulated_tracer_kernel_plans_cover_the_cases`: a
# 500-cell row at 16 rows (one tile of two rows at eight slots a thread
# before; x tiles now), a 100-cell row (one tile of eight rows, as before)
# and a 50-cell row
PLAN_CASES = ((2, 16, 500, "open", "open"), (2, 16, 500, "periodic", "symmetric"),
              (2, 16, 100, "periodic", "periodic"), (3, 10, 50, "symmetric", "open"))
# the limited grid's tiles of several rows: x tiles (2 x 8 of 20 x 38 cells;
# 5 x 2 of 12 x 60) and one tile over the row (2 of 12 and 11 rows; 7 of
# 10), whose 2-cell rings cross periodic edges in x, y and both, or meet
# every other kind; a sixth element drops the tendency stack (no_pt) or the
# clip (no_clip)
RING_CASES = ((2, 40, 300, "periodic", "periodic"), (2, 60, 120, "symmetric", "specified", "no_pt"),
              (3, 23, 45, "open", "symmetric", "no_clip"), (3, 70, 70, "specified", "periodic"),
              (2, 40, 300, "open", "periodic", "no_pt"))


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", _boundary_cases() + list(PLAN_CASES) + list(RING_CASES),
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_tracer_kernel_is_bitwise_its_plain_version(tracers_lib, case, pd):
    out, ref, q = _emulated_tracers(tracers_lib, case, pd, 7 + case[0])
    assert float((ref - q).abs().max()) > 1e-3            # the stage does something
    assert torch.equal(out, ref)


def _projected(tg, seed):
    """`tg` as a projected grid: map factors of a Lambert domain's spread
    (0.95-1.05), different in every cell so that a factor read at the wrong
    cell shows."""
    rng = np.random.default_rng(seed)
    msft = _t(rng.uniform(0.95, 1.05, tuple(tg.mub.shape)))
    return dataclasses.replace(tg, msft=msft, curvature=True)


# the tracer kernel with a map factor: the small shapes on the open,
# periodic and specified boundaries, rows in x tiles, and one row
MSF_CASES = ((3, 9, 13, "specified", "specified"), (5, 17, 33, "periodic", "periodic"),
             (2, 5, 33, "symmetric", "specified"), (50, 9, 13, "specified", "open"),
             (1, 1, 13, "periodic", "open"), (2, 3, 1000, "specified", "specified"),
             (2, 4, 1000, "periodic", "periodic"), (2, 16, 500, "specified", "periodic"),
             (2, 40, 300, "periodic", "periodic"), (3, 70, 70, "symmetric", "periodic"))


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", MSF_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_tracer_kernel_with_map_factor_is_bitwise(tracers_lib, case, pd):
    """With m2 = msft^2 on every divergence and outflow sum, bitwise as the
    plain version on a projected grid, including rows of 1,000 cells in x
    tiles (wider than the 255 cells one tile spans)."""
    out, ref, q = _emulated_tracers(tracers_lib, case, pd, 31 + case[2], msf=True)
    assert float((ref - q).abs().max()) > 1e-3
    assert torch.equal(out, ref)


def _emulated_tracers(lib, case, pd, seed, msf=False):
    """(kernel output, plain output, stage input) of the emulated kernel on
    seeded inputs at case (nz, ny, nx, bc_x, bc_y[, "no_pt" or "no_clip"]),
    on a projected grid with `msf`; the clip is on with the limiter unless
    the case drops it.  The limited grid gets no r_hi scratch."""
    nz, ny, nx, bc_x, bc_y = case[:5]
    pt_on, clip = "no_pt" not in case[5:], pd and "no_clip" not in case[5:]
    _, tg = _grids(nz, ny, nx)
    if msf:
        tg = _projected(tg, seed)
    f = {k: _t(v) for k, v in _inputs(tg, seed=seed).items()}
    pt = f["pt"] if pt_on else None
    hx = HaloOps(bc_x=BCKind(bc_x), bc_y=BCKind(bc_y))
    q_pad, ru, rv = (hx.pad(f[k], 3).contiguous() for k in ("q", "ru", "rv"))
    ref = tracers_kernel.advect_tracers_reference(
        q_pad, f["phi"], ru, rv, f["ww"], f["mu_full"], f["mu_new"], tg, hx, 6.0,
        pt=pt, pd=pd, clip=clip)
    out = torch.full_like(ref, float("nan"))
    m2 = tracers_kernel.map_factor_sq(tg)
    err = lib.advect_tracers(
        q_pad.data_ptr(), f["phi"].data_ptr(), None if pt is None else pt.data_ptr(),
        ru.data_ptr(), rv.data_ptr(), f["ww"].data_ptr(), f["mu_full"].data_ptr(),
        f["mu_new"].data_ptr(), tg.rdnw.data_ptr(), None if m2 is None else m2.data_ptr(),
        None, out.data_ptr(), *ref.shape, float(tg.rdx),
        float(tg.rdy), 6.0, int(pd), int(clip), *tracers_kernel.edge_codes(hx), None)
    assert err == 0
    if pd and not clip:
        assert float(ref.min()) < 0.0              # the clip would act
    return out, ref, f["q"]


def test_emulated_tracer_kernel_refuses_a_row_too_wide(tracers_lib):
    """No row is too wide any more: without the limiter one tile spans 255
    cells at two rows and 340 at one (four slots a thread; until eight slots
    a thread went, 469 and 511 at two rows, 572 and 681 at one); the
    limited grid, whose slots carry a 2-cell ring, takes one tile up to 170
    cells at two rows and 203 at one, and at 100 rows up to 8 (a row of 9
    takes x tiles of 100 x 5 cells, 500 a block, over one tile of 50 x 9);
    and a row of 1,200 cells, which the kernel refused before it split rows
    into x tiles, runs bitwise as its plain version."""
    tracers_lib.advect_tracers_widest_row.restype = ctypes.c_int
    widest = {(pd, ny): tracers_lib.advect_tracers_widest_row(pd, ny)
              for pd in (0, 1) for ny in (1, 2, 100)}
    assert widest == {(0, 1): 340, (0, 2): 255, (0, 100): 255,
                      (1, 1): 203, (1, 2): 170, (1, 100): 8}
    out, ref, _ = _emulated_tracers(tracers_lib, (1, 2, 1200, "periodic", "open"), True, 5)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("bc", ["periodic", "open", "symmetric"])
@pytest.mark.parametrize("width", ["W+1", "2W+5", "1000"])
def test_emulated_tracer_kernel_x_tiles_are_bitwise_its_plain_version(tracers_lib, width, bc,
                                                                       pd):
    """Rows wider than one tile (W = the widest row the one-tile grid
    spans, by mode) take x tiles: the faces at the tiles' edges read the
    factors of the tiles' halo columns, and the domain's x edges map them
    through the boundary.  At nz 2, ny 3 (open in y: symmetric needs 4
    rows), bitwise."""
    tracers_lib.advect_tracers_widest_row.restype = ctypes.c_int
    w = tracers_lib.advect_tracers_widest_row(int(pd), 3)
    nx = {"W+1": w + 1, "2W+5": 2 * w + 5, "1000": 1000}[width]
    bc_y = "periodic" if bc == "periodic" else "open"
    out, ref, q = _emulated_tracers(tracers_lib, (2, 3, nx, bc, bc_y), pd, 17 + nx)
    assert float((ref - q).abs().max()) > 1e-3
    assert torch.equal(out, ref)


# blocks of a process mesh (nz, ny, nx, bc_x, bc_y, mesh_y, mesh_x): one
# seam a block (1, 2); three (x periodic over two blocks, and one y seam);
# two, three and four on a 3 x 3 mesh with specified and open outer sides;
# four everywhere (periodic over 2 x 2); blocks of 500 cells, wider than
# one tile holds (x tiles); and slice 10's 50 x 50 block shape
SEAM_CASES = ((3, 10, 12, "open", "open", 1, 2), (3, 10, 12, "periodic", "symmetric", 2, 2),
              (2, 15, 18, "specified", "open", 3, 3), (2, 12, 12, "periodic", "periodic", 2, 2),
              (2, 3, 1000, "open", "periodic", 1, 2), (2, 50, 100, "periodic", "open", 1, 2))


@pytest.mark.parametrize("msf", [False, True], ids=["flat", "m2"])
@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", SEAM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_tracer_kernel_at_block_seams_is_bitwise(tracers_lib, case, pd, msf):
    """Every block of a mesh, its halos the true images of its neighbours'
    cells (the window of the global pad), bitwise as the plain version on
    the whole domain: without the limiter through `advect_tracers` with
    the blocks' edge codes; with it through `advect_tracers_seam`'s two
    grids, phi_old, ww and m2 with their one-cell ring, and r_hi's ring
    exchanged between the grids (here cut from the global r_hi)."""
    nz, ny, nx, bc_x, bc_y, my, mx = case
    _, tg = _grids(nz, ny, nx)
    if msf:
        tg = _projected(tg, 3 + nx)
    f = {k: _t(v) for k, v in _inputs(tg, seed=11 + nx).items()}
    hx = HaloOps(bc_x=BCKind(bc_x), bc_y=BCKind(bc_y))
    g3 = {k: hx.pad(f[k], 3) for k in ("q", "ru", "rv")}
    ref = tracers_kernel.advect_tracers_reference(
        g3["q"].contiguous(), f["phi"], g3["ru"].contiguous(), g3["rv"].contiguous(),
        f["ww"], f["mu_full"], f["mu_new"], tg, hx, 6.0, pt=f["pt"], pd=pd, clip=pd)
    m2 = tracers_kernel.map_factor_sq(tg)
    ring = {"phi": hx.pad(f["phi"], 1), "ww": hx.pad(f["ww"], 1),
            "m2": None if m2 is None else hx.pad(m2, 1)}
    by, bx = ny // my, nx // mx
    lib = tracers_lib
    lib.advect_tracers_seam.argtypes = tracers_kernel._SEAM_ARGTYPES
    lib.advect_tracers_seam.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    blocks = []
    for rank in range(my * mx):
        mesh = Mesh(my, mx, rank, None, torch.device("cpu"), "gloo")
        edges = tracers_kernel.edge_codes(dataclasses.replace(hx, mesh=mesh))
        y0, x0 = mesh.iy * by, mesh.ix * bx

        def cut(a, h=0):
            return a[..., y0:y0 + by + 2 * h, x0:x0 + bx + 2 * h].contiguous()

        b = {k: cut(v, 3) for k, v in g3.items()}
        b.update({k: cut(f[k]) for k in ("phi", "ww", "mu_full", "mu_new", "pt")})
        b.update({f"{k}_r": None if v is None else cut(v, 1) for k, v in ring.items()})
        b["m2"] = None if m2 is None else cut(m2)
        b["out"] = torch.full((2, nz, by, bx), float("nan"))
        b["r_hi"] = torch.full_like(b["out"], float("nan"))
        if pd:
            assert tracers_kernel.SEAM in edges or my * mx == 1
        blocks.append((mesh, edges, b))

    def seam_grid(g, b, edges, r_ring):
        return lib.advect_tracers_seam(
            g, b["q"].data_ptr(), b["phi_r"].data_ptr(), b["pt"].data_ptr(),
            b["ru"].data_ptr(), b["rv"].data_ptr(), b["ww_r"].data_ptr(),
            b["mu_full"].data_ptr(), b["mu_new"].data_ptr(), tg.rdnw.data_ptr(),
            ptr(b["m2_r"]), b["r_hi"].data_ptr(), ptr(r_ring), b["out"].data_ptr(), 2, nz,
            by, bx, float(tg.rdx), float(tg.rdy), 6.0, int(pd), *edges, None)

    for mesh, edges, b in blocks:
        if pd:
            assert seam_grid(tracers_kernel.FACTOR, b, edges, None) == 0
        else:
            assert lib.advect_tracers(
                b["q"].data_ptr(), b["phi"].data_ptr(), b["pt"].data_ptr(),
                b["ru"].data_ptr(), b["rv"].data_ptr(), b["ww"].data_ptr(),
                b["mu_full"].data_ptr(), b["mu_new"].data_ptr(), tg.rdnw.data_ptr(),
                ptr(b["m2"]), None, b["out"].data_ptr(), 2, nz, by, bx, float(tg.rdx),
                float(tg.rdy), 6.0, 0, 0, *edges, None) == 0
    if pd:
        # the FACTOR grids' r_hi, assembled and padded by one: each block's
        # ring is what the exchange brings
        r_all = torch.empty_like(ref)
        for mesh, _, b in blocks:
            r_all[..., mesh.iy * by:(mesh.iy + 1) * by, mesh.ix * bx:(mesh.ix + 1) * bx] = \
                b["r_hi"]
        r_ring = hx.pad(r_all, 1)
        for mesh, edges, b in blocks:
            y0, x0 = mesh.iy * by, mesh.ix * bx
            ring_b = r_ring[..., y0:y0 + by + 2, x0:x0 + bx + 2].contiguous()
            assert seam_grid(tracers_kernel.LIMITED, b, edges, ring_b) == 0
    assert float((ref - f["q"]).abs().max()) > 1e-3
    for mesh, _, b in blocks:
        want = ref[..., mesh.iy * by:(mesh.iy + 1) * by, mesh.ix * bx:(mesh.ix + 1) * bx]
        assert torch.equal(b["out"], want), f"block {mesh.iy, mesh.ix}"


def test_emulated_tracer_kernel_refuses_a_seam_in_the_one_call_interface(tracers_lib):
    """With the limiter a seam's factors come from the neighbouring block,
    so `advect_tracers` refuses seam edge codes with pd on (the wrapper
    takes `advect_tracers_seam` there) and inconsistent periodic codes."""
    z = torch.zeros(1)
    args = [z.data_ptr()] * 12 + [1, 1, 4, 4, 1.0, 1.0, 1.0]
    seam = tracers_kernel.SEAM
    assert tracers_lib.advect_tracers(*args, 1, 1, seam, 1, 1, 1, None) == 1
    assert tracers_lib.advect_tracers(*args, 1, 1, 0, 1, 1, 1, None) == 1


@pytest.fixture(scope="module")
def ros2_lib(tmp_path_factory):
    src = ros2_kernel.generate_source(tgas._kinetics())
    lib = _emulated(src["text"], "ros2", str(tmp_path_factory.mktemp("emu")))
    lib.ros2_integrate.argtypes = ros2_kernel._ARGTYPES
    lib.ros2_integrate.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("ncell,n_sub", [(70, 1), (70, 2), (5 * ros2_kernel.THREADS + 7, 2)])
def test_emulated_ros2_kernel_is_bitwise_its_plain_version(ros2_lib, ncell, n_sub):
    """The last case gives the persistent grid (2 blocks per "SM" of the
    stand-in's 2) more chunks of cells than blocks, and a ragged last one."""
    kin = tgas._kinetics()
    conc, k, *_ = polluted_start(ncell, 8)
    conc, k = _t(conc), _t(k)
    ref = ros2_kernel.integrate_reference(kin, conc, k, 60.0, n_sub)
    out = torch.full_like(conc, float("nan"))
    dt, gdt = ros2_kernel._step_scalars(60.0, n_sub)
    err = ros2_lib.ros2_integrate(conc.data_ptr(), k.data_ptr(), out.data_ptr(), ncell, n_sub,
                                  float(dt), float(gdt), None)
    assert err == 0
    assert float((ref - conc).abs().max()) > 1e6               # the step does something
    assert np.array_equal(out.numpy(), ref.numpy())


# the Mie kernel's tile paths: as built (a tile is sorted by floor cell when
# enough of its warp-runs are mixed), every tile sorted, none sorted
MIE_PATHS = {"as_built": None, "sorted": -1, "unsorted": 1 << 20}


@pytest.fixture(scope="module")
def mie_libs(tmp_path_factory):
    """The Mie evaluator as its library is built: with multiply-add
    contraction (``-ffp-contract=fast``; its recurrences call fmaf); also
    with its tile sort forced on and off (`MIE_PATHS`)."""
    with open(build._source("mie_cheb_eval")) as f:
        text = f.read()
    tmp = str(tmp_path_factory.mktemp("emu"))
    libs = {}
    for path, sort_min in MIE_PATHS.items():
        src = text
        if sort_min is not None:
            src, n = re.subn(r"constexpr int SORT_MIN = [^;]+;",
                             f"constexpr int SORT_MIN = {sort_min};", text)
            assert n == 1
        lib = _emulated(src, f"mie_cheb_eval_{path}", tmp, contract="fast")
        lib.mie_cheb_eval.argtypes = mie_kernel._ARGTYPES
        lib.mie_cheb_eval.restype = ctypes.c_int
        libs[path] = lib
    return libs


def _mie_case(kind, nband=3, n=700):
    """Inputs of the Mie evaluator: `random` (every element anywhere on the
    grid), `coherent` (runs of 32 elements, a warp's worth, in one floor
    cell) or `edges` (chip_smoke.py's edge elements: u = 0, nr_n = 1, u = 1,
    t = -1 and 1, among random ones)."""
    rng = np.random.default_rng({"random": 11, "coherent": 12, "edges": 13}[kind])
    shape = (nband, n)
    nr_n, u = rng.uniform(0, 1, shape), rng.uniform(0, 1, shape)
    t = rng.uniform(-1, 1, shape)
    if kind == "coherent":
        runs = -(-n // 32)
        cell_nr = np.repeat(rng.integers(0, 7, (nband, runs)), 32, axis=1)[:, :n]
        cell_u = np.repeat(rng.integers(0, 9, (nband, runs)), 32, axis=1)[:, :n]
        nr_n = (cell_nr + rng.uniform(0, 1, shape)) / 7.0
        u = (cell_u + rng.uniform(0, 1, shape)) / 9.0
    elif kind == "edges":
        u[:, :10] = 0.0
        nr_n[:, 10:20] = 1.0
        u[:, 15:25] = 1.0
        t[:, 30] = -1.0
        t[:, 31] = 1.0
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (nr_n, u, t))


@pytest.mark.parametrize("path", list(MIE_PATHS))
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("kind", ["random", "coherent", "edges"])
def test_emulated_mie_kernel_matches_its_plain_version(mie_libs, kind, blocks, path):
    """Within 1e-5 in ln Q and g, not bitwise: the kernel fuses multiply-adds
    and forms each coefficient from its four corners in another order than
    the plain version's matrix product.  2,100 elements are three tiles of
    1,024, the last one ragged: 3 blocks take one each, 1 block walks all
    three.  Random and edge inputs take the sorted path as built, coherent
    ones the unsorted path."""
    lib = mie_libs[path]
    nr_n, u, t = _mie_case(kind)
    shape = mie_kernel.launch_shape(lib)
    assert shape["tile"] == 1024
    ref = mie_kernel.cheb_eval_reference(nr_n, u, t)
    outs = tuple(torch.full_like(t, float("nan")) for _ in range(3))
    table = mie_kernel.packed_table(torch.device("cpu"), shape["cell_stride"])
    err = lib.mie_cheb_eval(table.data_ptr(), nr_n.data_ptr(), u.data_ptr(), t.data_ptr(),
                            *(o.data_ptr() for o in outs), t.numel(), blocks, None)
    assert err == 0
    for name, o, r in zip(("ln_qext", "ln_qsca", "g"), outs, ref):
        d = float((o - r).abs().max())
        assert d <= 1e-5, (name, d)


def test_emulated_mie_library_shape(mie_libs):
    """The layout and launch constants the library exports: each cell of
    the packed table an odd count of float4s past G's 90 rows (neighbouring
    cells then fall in different 16-byte bank groups), and the blocks an SM
    is to hold fit its 228 KB of shared memory with the table and a tile's
    staging each (1 KB a block is the runtime's own)."""
    shape = mie_kernel.launch_shape(mie_libs["as_built"])
    stride = shape["cell_stride"]
    assert stride % 2 == 1 and stride > 90
    table = mie_kernel.packed_table(torch.device("cpu"), stride)
    assert shape["smem_bytes"] > table.numel() * table.element_size()
    assert shape["blocks_per_sm"] * (shape["smem_bytes"] + 1024) <= 228 * 1024
    assert shape["tile"] % shape["threads"] == 0


@pytest.fixture(scope="module")
def adv_lib(tmp_path_factory):
    with open(build._source("advect_scalar_5_3")) as f:
        lib = _emulated(f.read(), "advect_scalar_5_3", str(tmp_path_factory.mktemp("emu")))
    lib.advect_scalar_5_3.argtypes = adv_kernel._ARGTYPES
    lib.advect_scalar_5_3.restype = ctypes.c_int
    return lib


# (nz, ny, nx) that stress the scalar kernel on the stand-in's 2 SMs: 1, 2,
# 3 and 5 levels; z chunks that do not divide nz; an odd ny (a thread's
# second row past the last) and a single row; warps whose 31 cells end
# mid-row and rows that end mid-warp; rows of 19, 39 and 33 floats, whose
# starts fall off 16 bytes, and of 16; the main path's width of 100
ADV_SHAPES = ((1, 3, 13), (2, 11, 13), (3, 11, 33), (5, 11, 13), (2, 1, 13), (3, 6, 10),
              (9, 5, 27), (5, 17, 100), (7, 9, 300), (50, 9, 13), (4, 2, 40), (23, 9, 40))


def test_emulated_scalar_kernel_plans_cover_the_cases(adv_lib):
    """The plans of `ADV_SHAPES` include ragged z chunks, several chunks
    and several blocks of a plane at once, and warps of a plane that do not
    fill their last block."""
    plans = {s: adv_kernel.plan(adv_lib, *s, sms=2) for s in ADV_SHAPES}
    for (nz, ny, nx), p in plans.items():
        slots = -(-ny // p["rows_per_thread"]) * (nx + 1)
        assert 31 * p["warps_per_plane"] >= slots - 1 > 31 * (p["warps_per_plane"] - 1)
        assert p["blocks_per_plane"] == -(-p["warps_per_plane"] // (p["threads"] // 32))
        assert p["chunks"] * p["kc"] >= nz > (p["chunks"] - 1) * p["kc"]
    assert any(nz % p["kc"] for (nz, _, _), p in plans.items())
    assert any(ny % p["rows_per_thread"] for (_, ny, _), p in plans.items())
    assert any(p["blocks_per_plane"] > 1 and p["chunks"] > 2 for p in plans.values())
    assert any(p["warps_per_plane"] % (p["threads"] // 32) for p in plans.values())
    # the main path's grid on 132 SMs
    assert adv_kernel.plan(adv_lib, 50, 100, 100, 132) == {
        "rows_per_thread": 2, "warps_per_plane": 163, "blocks_per_plane": 41, "kc": 4,
        "chunks": 13, "threads": 128, "blocks": 533}


def test_emulated_tracer_kernel_plans_cover_the_cases(tracers_lib):
    """Without the limiter the launch plan takes one tile over the row where
    one spans it (`widest_row`), else x tiles: at config 5's block (107
    scalars, 500x500x60) and at 16 rows of 500 cells x tiles of eight rows
    and 100 cells, three blocks an SM; at 100 and 50 cells one tile over
    the row.  The limited grid's slots are its tile with a 2-cell ring (one
    tile over the row needs no x ring), and its plan is the tile that holds
    the most cells at two blocks an SM: x tiles of 28 x 28 at config 5's
    block, of 20 x 34 at 100x100 (680 cells; one tile over the row, 6 x 100),
    one tile over the row at 50 cells (13 rows).  Each grid's slots cover
    its tile, its tiles the block, and the blocks an SM fit its shared
    memory; the seam grids take the x tiles' sizing without the limiter's."""
    tracers_lib.advect_tracers_widest_row.restype = ctypes.c_int

    def grids(pd, shape, seam=False):
        return tracers_kernel.plan(tracers_lib, pd, *shape, seam=seam)

    def tile(p):
        return p["x_tiles"], p["tile_rows"], p["tile_cells"], p["tiles_y"], p["tiles_x"]

    for shape in ((107, 60, 500, 500), (2, 2, 16, 500)):
        nt, nz, ny, nx = shape
        (p,) = grids(False, shape)
        assert tile(p)[:3] == (True, 8, 100) and p["resident"] == 3
        assert p["blocks"] == nt * -(-ny // 8) * 5
        for p in grids(True, shape, seam=True):
            assert tile(p)[:3] == (True, 8, 100) and p["resident"] == 2
    assert [tile(p) for p in grids(True, (107, 60, 500, 500))] == [(True, 28, 28, 18, 18)]
    assert [tile(p) for p in grids(True, (2, 2, 16, 500))] == [(True, 16, 46, 1, 11)]
    for shape, rows in (((107, 50, 100, 100), 8), ((2, 3, 10, 50), 5), ((107, 50, 50, 50), 8)):
        (p,) = grids(False, shape)
        assert not p["x_tiles"]
        assert (p["tile_rows"], p["tile_cells"], p["tiles_x"]) == (rows, shape[3], 1)
    assert [tile(p) for p in grids(True, (107, 50, 100, 100))] == [(True, 20, 34, 5, 3)]
    assert [tile(p) for p in grids(True, (2, 3, 10, 50))] == [(False, 10, 50, 1, 1)]
    assert [tile(p) for p in grids(True, (107, 50, 50, 50))] == [(False, 13, 50, 4, 1)]
    for shape in ((107, 50, 100, 100), (107, 60, 500, 500), (2, 2, 16, 500), (2, 3, 10, 50),
                  (107, 50, 50, 50), (2, 2, 4, 300), (2, 2, 3, 1000), (2, 2, 4, 255),
                  (2, 2, 40, 300), (2, 3, 70, 70)):
        nt, nz, ny, nx = shape
        widest = tracers_lib.advect_tracers_widest_row(0, ny)
        for pd in (False, True):
            for p in grids(pd, shape):
                ring = 2 if pd else 1
                halo = 2 * ring if p["x_tiles"] else 1
                assert pd or p["x_tiles"] == (nx > widest)
                assert (p["tile_rows"] + 2 * ring) * (p["tile_cells"] + halo) <= \
                    p["threads"] * p["slots_per_thread"]
                assert (p["threads"], p["slots_per_thread"]) == ((512, 2) if pd else (256, 4))
                assert p["tiles_y"] * p["tile_rows"] >= ny > (p["tiles_y"] - 1) * p["tile_rows"]
                assert p["tiles_x"] * p["tile_cells"] >= nx
                assert p["x_tiles"] or p["tiles_x"] == 1
                assert p["blocks"] == nt * p["tiles_y"] * p["tiles_x"]
                assert 1 <= p["resident"] and p["resident"] * (p["smem_bytes"] + 1024) <= 233472
    # the seam grids: x tiles where the flat grids take one tile
    for p in grids(True, (107, 50, 50, 50), seam=True):
        assert p["x_tiles"] and (p["tile_rows"], p["tile_cells"], p["tiles_x"]) == (8, 50, 1)


def _emulated_scalar(adv_lib, shape, msf):
    """(kernel output, plain output) of the emulated scalar kernel on seeded
    inputs at `shape`, with a map factor m2 (0.9-1.1) if `msf`."""
    nz, ny, nx = shape
    rng = np.random.default_rng(nz * 1000 + ny * 10 + nx)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    q = put(300.0 + rng.normal(size=(nz, ny + 6, nx + 6)))
    ru, rv = (put(1e6 * rng.normal(size=(nz, ny + 6, nx + 6))) for _ in range(2))
    ww = put(1e3 * rng.normal(size=(nz + 1, ny, nx)))
    rdnw = put(rng.uniform(-60, -40, nz))
    m2 = put(rng.uniform(0.9, 1.1, (ny, nx))) if msf else None
    ref = adv_kernel.advect_scalar_5_3_reference(q, ru, rv, ww, rdnw, 1e-3, 2e-3, m2)
    out = torch.full_like(ref, float("nan"))
    err = adv_lib.advect_scalar_5_3(q.data_ptr(), ru.data_ptr(), rv.data_ptr(), ww.data_ptr(),
                                    rdnw.data_ptr(), None if m2 is None else m2.data_ptr(),
                                    out.data_ptr(), nz, ny, nx, 1e-3, 2e-3, None)
    assert err == 0
    assert float(ref.abs().max()) > 1.0
    return out, ref


@pytest.mark.parametrize("shape", ADV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_scalar_kernel_is_bitwise_its_plain_version(adv_lib, shape):
    """ww is random at the model top and the surface too: the kernel must
    zero those faces itself, as the plain version does."""
    out, ref = _emulated_scalar(adv_lib, shape, msf=False)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", ADV_SHAPES[::2], ids=lambda s: "x".join(map(str, s)))
def test_emulated_scalar_kernel_with_map_factor_is_bitwise(adv_lib, shape):
    """With m2 on the horizontal divergence: bitwise as the plain version,
    and not the flat result."""
    out, ref = _emulated_scalar(adv_lib, shape, msf=True)
    assert torch.equal(out, ref)
    assert not torch.equal(out, _emulated_scalar(adv_lib, shape, msf=False)[1])


@pytest.fixture(scope="module")
def diffusion_lib(tmp_path_factory):
    with open(build._source("diffuse_scalars")) as f:
        return _emulated(f.read(), "diffuse_scalars", str(tmp_path_factory.mktemp("emu")))


# the diffusion case: 40 columns (x tiles of 32 and 8) by 37 rows (y tiles
# of 16, 16 and 5, the last lane's two rows cut after one), 6 levels; on
# the stand-in's 2 SMs slices of 1 and 3 scalars march in z chunks of 1 and
# 3 levels (a chunk starts above the surface), 18 scalars in one chunk
DIFF_SHAPE = (6, 37, 40)
DIFF_SCALARS = 18


def _diffusion_cfg(**dyn):
    nz, ny, nx = DIFF_SHAPE
    c = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                             ztop=17000.0, p_top=8000.0),
                    time_control=tcfg.TimeControl(dt=6.0))
    return c.replace(dynamics=dataclasses.replace(c.dynamics, **dyn))


@pytest.fixture(scope="module")
def diffusion_case():
    """The squall line with a sheared, perturbed flow (so that K varies from
    cell to cell), a TKE field, and 18 scalars s0 .. s17 of structure on
    every scale."""
    grid, state = tideal.make_case(_diffusion_cfg(), "squall2d_x", device="cpu",
                                   bubble_amp=3.0)
    rng = np.random.default_rng(19)
    state = dict(state)
    for k in ("u", "v"):
        state[k] = state[k] + _t(rng.normal(scale=2.0, size=tuple(state[k].shape)))
    state["tke"] = _t(rng.uniform(0.05, 2.0, tuple(state["t"].shape)))
    for n in range(DIFF_SCALARS):
        smooth = np.cumsum(rng.normal(size=tuple(state["t"].shape)), axis=-1)
        state[f"s{n}"] = _t(10.0 ** rng.uniform(-3, 3) * (1.0 + 0.1 * smooth
                                                          + rng.uniform(size=smooth.shape)))
    return grid, state


@pytest.mark.parametrize("km", ["smag3d", "tke"])
@pytest.mark.parametrize("nt", [1, 3, DIFF_SCALARS])
@pytest.mark.parametrize("diff_6th_opt", [0, 1, 2])
@pytest.mark.parametrize("kvdif", [0.0, 30.0])
def test_emulated_diffusion_kernel_is_bitwise_its_plain_version(
        diffusion_lib, diffusion_case, monkeypatch, kvdif, diff_6th_opt, nt, km):
    """`diffusion_tendencies` with the scalars' pass through the emulated
    kernel, bitwise as with the plain version, on a slice of `nt` scalars
    with K from the closure `km`; the pass is one launch."""
    grid, state = diffusion_case
    cfg = _diffusion_cfg(kvdif=kvdif, diff_6th_opt=diff_6th_opt, diff_6th_factor=0.12,
                         km_opt=KMOpt(km))
    names = tuple(f"s{n}" for n in range(nt))
    ref = tdiff.diffusion_tendencies(state, grid, cfg, HaloOps(), 6.0, names)
    calls = []

    def emulated(sc_pad, k_pad, grid, dz2=None, kvdif=0.0, filter6=None):
        diffusion_kernel._check(sc_pad, k_pad, dz2)
        assert (dz2 is not None) == (cfg.dynamics.kvdif > 0.0)
        assert (filter6 is not None) == bool(diff_6th_opt)
        out = torch.full((sc_pad.shape[0], sc_pad.shape[1], *DIFF_SHAPE[1:]), float("nan"))
        assert diffusion_kernel.launch(diffusion_lib, sc_pad, k_pad, dz2, out, grid, kvdif,
                                       filter6, None) == 0
        calls.append(tuple(sc_pad.shape))
        return out

    monkeypatch.setattr(diffusion_kernel, "diffuse_scalars", emulated)
    out = tdiff.diffusion_tendencies(state, grid, cfg, HaloOps(), 6.0, names)
    assert calls == [(nt, DIFF_SHAPE[0], DIFF_SHAPE[1] + 6, DIFF_SHAPE[2] + 6)]
    assert set(out) == set(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    for k in names:
        assert float(ref[k].abs().max()) > 0.0


def test_emulated_diffusion_kernel_plans(diffusion_lib):
    """The launch plan: one z chunk at config 5's block (a pass of 18
    scalars on 16 x 32 tiles of 32 x 16); z chunks where a slice gives few
    tiles for the card's SMs, as in the bitwise cases above."""
    def chunks(*shape, sms):
        p = diffusion_kernel.plan(diffusion_lib, *shape, sms=sms)
        return p["tiles_x"], p["tiles_y"], p["kc"], p["chunks"], p["blocks"]

    assert chunks(18, 60, 500, 500, sms=132) == (16, 32, 60, 1, 9216)
    assert chunks(47, 50, 100, 100, sms=132) == (4, 7, 25, 2, 2632)
    assert chunks(1, *DIFF_SHAPE, sms=2) == (2, 3, 1, 6, 36)
    assert chunks(3, *DIFF_SHAPE, sms=2) == (2, 3, 3, 2, 36)
    assert chunks(DIFF_SCALARS, *DIFF_SHAPE, sms=2) == (2, 3, 6, 1, 108)
    p = diffusion_kernel.plan(diffusion_lib, 1, 1, 1, 1, sms=132)
    assert (p["threads"], p["tile_x"], p["tile_y"], p["blocks"]) == (256, 32, 16, 1)


@pytest.fixture(scope="module")
def advance_w_lib(tmp_path_factory):
    with open(build._source("advance_w")) as f:
        return _emulated(f.read(), "advance_w", str(tmp_path_factory.mktemp("emu")))


def _acoustic_case(kind, nz, ny, nx):
    """(cfg, grid, state, halo, dt) of a small case whose acoustic loop
    exercises `kind`: "flat" (the squall line with a perturbed flow, damp_opt
    3's damping profile), "flat_nodamp" (the same without it: w_damp is one
    value), "msf" (a warm bubble on a Lambert grid), "terrain" (flow over a
    300-m hill) or "terrain_msf" (a real case over 1,000-m terrain on a
    Lambert grid, specified boundaries)."""
    dyn = {"damp_opt": 0} if kind == "flat_nodamp" else {}
    if kind in ("flat", "flat_nodamp", "terrain"):
        cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=1000.0,
                                                   ztop=17000.0, p_top=8000.0),
                          time_control=tcfg.TimeControl(dt=6.0),
                          dynamics=tcfg.DynamicsConfig(kvdif=30.0, **dyn))
        if kind == "terrain":
            grid, state = tideal.make_case(cfg, "hill2d_x", device="cpu", hm=300.0,
                                           a_half=4000.0, u0=10.0)
        else:
            grid, state = tideal.make_case(cfg, "squall2d_x", device="cpu", bubble_amp=3.0)
            rng = np.random.default_rng(nz)
            state = dict(state)
            for k, amp in (("u", 2.0), ("v", 2.0), ("w", 0.5)):
                state[k] = state[k] + _t(amp * rng.normal(size=tuple(state[k].shape)))
        return cfg, grid, state, HaloOps(), 6.0
    b = {"bc_x": BCKind.SPECIFIED, "bc_y": BCKind.SPECIFIED} if kind == "terrain_msf" else {}
    cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=12e3, dy=12e3,
                                               ztop=16000.0, p_top=10000.0),
                      time_control=tcfg.TimeControl(dt=60.0),
                      dynamics=tcfg.DynamicsConfig(kvdif=0.0, time_step_sound=6, epssm=0.3,
                                                   **b))
    lambert = tproj.Projection(kind="lambert", ref_lat=40.0)
    if kind == "msf":
        grid = tideal.make_grid(cfg, tideal.soundings.constant_n2_theta(), "cpu",
                                projection=lambert)
        state = tideal.warm_bubble(cfg, grid, amplitude=2.0, zc=1500.0, xr=40e3, zr=1200.0,
                                   three_d=True)
        return cfg, grid, state, HaloOps(), 60.0
    snaps = treal.synthetic_analysis(cfg, [0.0], terrain_amp=1000.0)
    grid, state, _ = treal.real_init(cfg, snaps, projection=lambert, device="cpu")
    return cfg, grid, state, HaloOps(BCKind.SPECIFIED, BCKind.SPECIFIED), 60.0


def _emulated_advance_w(lib, w, ph, th, mu, om, p_now, rw, rph, ac, dtau, epssm, wsfc=None):
    """The emulated kernel's (w, ph) into NaN-filled outputs."""
    advance_w_kernel._check(w, ph, th, mu, om, p_now, rw, rph, ac, wsfc)
    w_out, ph_out = torch.full_like(w, float("nan")), torch.full_like(ph, float("nan"))
    assert advance_w_kernel.launch(lib, w, ph, th, mu, om, p_now, rw, rph, ac, dtau, epssm,
                                   wsfc, w_out, ph_out, None) == 0
    return w_out, ph_out


def _step_through_emulated(lib, monkeypatch, kind, nz, ny, nx):
    """One `solve.step` of the case with every substep's update run by the
    emulated kernel and by the plain version on the same inputs; the step
    goes on with the plain version's result.  Returns each call's inputs
    and whether the two agreed bit for bit."""
    cfg, grid, state, hx, dt = _acoustic_case(kind, nz, ny, nx)
    calls = []

    def both(*args):
        out = _emulated_advance_w(lib, *args)
        ref = advance_w_kernel.advance_w_reference(*args)
        calls.append((args, torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                      ref))
        return ref

    monkeypatch.setattr(advance_w_kernel, "advance_w", both)
    tsolve.step(state, grid, cfg, hx, dt)
    return cfg, grid, calls


# (kind, nz, ny, nx): 11, 51 and 61 w-levels; 63, 15, 60, 192 and 140
# columns, so that every case's last block of 32 columns is ragged but the
# 192 columns' (6 whole blocks)
ACOUSTIC_CASES = (("flat", 10, 7, 9), ("flat", 10, 3, 5), ("flat", 50, 7, 9),
                  ("flat", 60, 7, 9), ("flat_nodamp", 10, 7, 9), ("terrain", 10, 4, 15),
                  ("msf", 8, 12, 16), ("terrain_msf", 8, 10, 14))


@pytest.mark.parametrize("kind,nz,ny,nx", ACOUSTIC_CASES)
def test_emulated_advance_w_is_bitwise_its_plain_version(advance_w_lib, monkeypatch, kind, nz,
                                                         ny, nx):
    """Every acoustic substep of one `solve.step`: the emulated kernel
    bitwise as the plain version on the substep's own inputs, with the
    case's surface row, map factor and damping profile."""
    cfg, grid, calls = _step_through_emulated(advance_w_lib, monkeypatch, kind, nz, ny, nx)
    assert len(calls) == (1 + 2 + 4 if cfg.dynamics.time_step_sound == 4 else 1 + 3 + 6)
    assert all(ok for _, ok, _ in calls), [ok for _, ok, _ in calls]
    args, _, (w_new, _) = calls[-1]
    ac, wsfc = args[8], args[11]
    assert (wsfc is not None) == grid.has_terrain == kind.startswith("terrain")
    assert ("msft" in ac) == kind.endswith("msf")
    assert (ac["w_damp"].numel() == 1) == (kind == "flat_nodamp")
    assert float(w_new[1:].abs().max()) > 0.0
    if wsfc is not None:
        assert float(wsfc.abs().max()) > 0.0 and torch.equal(w_new[0], wsfc)
    else:
        assert float(w_new[0].abs().max()) == 0.0


def test_emulated_advance_w_on_a_block_is_the_whole_domain_s_columns(advance_w_lib,
                                                                      monkeypatch):
    """The update is column-local: on a block cut from the domain (as a
    process mesh cuts it; terrain and a map factor) the emulated kernel
    gives the whole domain's result on those columns bit for bit."""
    _, grid, calls = _step_through_emulated(advance_w_lib, monkeypatch, "terrain_msf", 8, 10,
                                            14)
    args, ok, (w_ref, ph_ref) = calls[-1]
    assert ok
    ny, nx = grid.ny, grid.nx
    rows, cols = slice(3, 8), slice(5, 12)

    def cut(t):
        if isinstance(t, torch.Tensor) and tuple(t.shape[-2:]) == (ny, nx):
            return t[..., rows, cols].contiguous()
        return t

    block = [cut(a) for a in args]
    block[8] = {k: cut(v) for k, v in args[8].items()}
    w_blk, ph_blk = _emulated_advance_w(advance_w_lib, *block)
    assert torch.equal(w_blk, w_ref[:, rows, cols])
    assert torch.equal(ph_blk, ph_ref[:, rows, cols])


def test_emulated_advance_w_plan_and_level_limit(advance_w_lib):
    """Blocks of one warp, 3 x (nz+1) floats a thread of shared memory: at
    config 5's block 7,813 blocks of 23,424 bytes, 9 an SM (the stand-in
    counts threads and shared memory only); a column of more w-levels than
    a block's 227 KB hold (605) is refused, 605 are taken."""
    p = advance_w_kernel.plan(advance_w_lib, 60, 500 * 500)
    assert (p["threads"], p["blocks"], p["shared_bytes"], p["blocks_per_sm"]) == (
        32, 7813, 23424, 9)
    fn = advance_w_lib.advance_w
    fn.argtypes = advance_w_kernel._ARGTYPES
    fn.restype = ctypes.c_int
    null = [None] * 8 + [0] + [None] * 12
    assert fn(*null, 605, 1, 1, *[0.0] * 6, None) == 1          # cudaErrorInvalidValue
    assert fn(*null, 0, 1, 1, *[0.0] * 6, None) == 1
    assert advance_w_kernel.plan(advance_w_lib, 604, 1)["shared_bytes"] == 232320


def test_kernel_flags_enter_the_library_name(monkeypatch):
    """The Mie evaluator is built with multiply-add contraction, every other
    kernel without; a library built with other flags has another name, so
    it is never loaded in place of the right one."""
    assert "--fmad=false" not in build.nvcc_flags("mie_cheb_eval")
    for name in ("advect_scalar_5_3", "advect_tracers", "diffuse_scalars", "advance_w"):
        assert "--fmad=false" in build.nvcc_flags(name)
    paths = {name: build.lib_path(name) for name in build.SOURCES}
    monkeypatch.setitem(build.DROPPED_FLAGS, "mie_cheb_eval", ())
    assert "--fmad=false" in build.nvcc_flags("mie_cheb_eval")
    assert build.lib_path("mie_cheb_eval") != paths["mie_cheb_eval"]
    monkeypatch.setitem(build.DROPPED_FLAGS, "advect_scalar_5_3", ("--fmad=false",))
    assert build.lib_path("advect_scalar_5_3") != paths["advect_scalar_5_3"]
    assert build.lib_path("advect_tracers") == paths["advect_tracers"]
