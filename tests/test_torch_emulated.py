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
  rows, 100 and 50 cells); its plans themselves; and on the blocks of process meshes,
  with seams on one to four sides and x tiles, against the plain version
  on the whole domain;
- the ROS2 gas kernel that ``ops/ros2_kernel.py`` generates, for one and two
  substeps over a few blocks of its persistent grid.

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

from wrfchem_arc_interactions_tpu_torch.chem import gas as tgas  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config.namelist import BCKind  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import (  # noqa: E402
    adv_kernel, build, mie_kernel, ros2_kernel, tracers_kernel,
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


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", _boundary_cases() + list(PLAN_CASES),
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
             (2, 4, 1000, "periodic", "periodic"), (2, 16, 500, "specified", "periodic"))


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
    seeded inputs at case (nz, ny, nx, bc_x, bc_y), on a projected grid with
    `msf`."""
    nz, ny, nx, bc_x, bc_y = case
    _, tg = _grids(nz, ny, nx)
    if msf:
        tg = _projected(tg, seed)
    f = {k: _t(v) for k, v in _inputs(tg, seed=seed).items()}
    hx = HaloOps(bc_x=BCKind(bc_x), bc_y=BCKind(bc_y))
    q_pad, ru, rv = (hx.pad(f[k], 3).contiguous() for k in ("q", "ru", "rv"))
    ref = tracers_kernel.advect_tracers_reference(
        q_pad, f["phi"], ru, rv, f["ww"], f["mu_full"], f["mu_new"], tg, hx, 6.0,
        pt=f["pt"], pd=pd, clip=pd)
    out, r_hi = torch.full_like(ref, float("nan")), torch.full_like(ref, float("nan"))
    m2 = tracers_kernel.map_factor_sq(tg)
    err = lib.advect_tracers(
        q_pad.data_ptr(), f["phi"].data_ptr(), f["pt"].data_ptr(), ru.data_ptr(),
        rv.data_ptr(), f["ww"].data_ptr(), f["mu_full"].data_ptr(), f["mu_new"].data_ptr(),
        tg.rdnw.data_ptr(), None if m2 is None else m2.data_ptr(), r_hi.data_ptr(),
        out.data_ptr(), *ref.shape, float(tg.rdx),
        float(tg.rdy), 6.0, int(pd), int(pd), *tracers_kernel.edge_codes(hx), None)
    assert err == 0
    return out, ref, f["q"]


def test_emulated_tracer_kernel_refuses_a_row_too_wide(tracers_lib):
    """No row is too wide any more: the one-tile grid spans 255 cells at two
    rows and 340 at one, with the limiter and without (four slots a thread;
    until eight slots a thread went, 469 and 511 at two rows, 572 and 681 at
    one), and a row of 1,200 cells, which the kernel refused before it
    split rows into x tiles, runs bitwise as its plain version."""
    tracers_lib.advect_tracers_widest_row.restype = ctypes.c_int
    widest = {(pd, ny): tracers_lib.advect_tracers_widest_row(pd, ny)
              for pd in (0, 1) for ny in (1, 2, 100)}
    assert widest == {(0, 1): 340, (0, 2): 255, (0, 100): 255,
                      (1, 1): 340, (1, 2): 255, (1, 100): 255}
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
    """The launch plan takes one tile over the row where one spans it
    (`widest_row`), else x tiles.  At config 5's block (107 scalars,
    500x500x60) and at 16 rows of 500 cells, which one tile spanned before
    only at two rows and eight slots a thread (one block an SM by its 142 KB
    of shared memory, a q plane of 8 rows for 2 rows of cells): x tiles of
    eight rows and 100 cells, three blocks an SM without the limiter, two
    with it.  At 100 and 50 cells one tile over the row, as before.  Each
    grid's slots cover its tile, its tiles the block, and the blocks an SM
    fit its shared memory; the seam grids take the x tiles' sizing."""
    tracers_lib.advect_tracers_widest_row.restype = ctypes.c_int

    def grids(pd, shape, seam=False):
        return tracers_kernel.plan(tracers_lib, pd, *shape, seam=seam)

    for shape in ((107, 60, 500, 500), (2, 2, 16, 500)):
        nt, nz, ny, nx = shape
        for pd in (False, True):
            for p in grids(pd, shape):
                assert p["x_tiles"] and (p["tile_rows"], p["tile_cells"]) == (8, 100)
                assert p["slots_per_thread"] == 4 and p["resident"] == (2 if pd else 3)
                assert p["blocks"] == nt * -(-ny // 8) * 5
        assert grids(True, shape, seam=True) == grids(True, shape)
    for shape, rows in (((107, 50, 100, 100), 8), ((2, 3, 10, 50), 5), ((107, 50, 50, 50), 8)):
        for pd in (False, True):
            for p in grids(pd, shape):
                assert not p["x_tiles"] and p["slots_per_thread"] == 4
                assert (p["tile_rows"], p["tile_cells"], p["tiles_x"]) == (rows, shape[3], 1)
    for shape in ((107, 50, 100, 100), (107, 60, 500, 500), (2, 2, 16, 500), (2, 3, 10, 50),
                  (107, 50, 50, 50), (2, 2, 4, 300), (2, 2, 3, 1000), (2, 2, 4, 255)):
        nt, nz, ny, nx = shape
        for pd in (False, True):
            widest = tracers_lib.advect_tracers_widest_row(int(pd), ny)
            for p in grids(pd, shape):
                assert p["x_tiles"] == (nx > widest)
                halo = 2 if p["x_tiles"] else 1
                assert (p["tile_rows"] + 2) * (p["tile_cells"] + halo) <= \
                    256 * p["slots_per_thread"]
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


def test_kernel_flags_enter_the_library_name(monkeypatch):
    """The Mie evaluator is built with multiply-add contraction, every other
    kernel without; a library built with other flags has another name, so
    it is never loaded in place of the right one."""
    assert "--fmad=false" not in build.nvcc_flags("mie_cheb_eval")
    for name in ("advect_scalar_5_3", "advect_tracers"):
        assert "--fmad=false" in build.nvcc_flags(name)
    paths = {name: build.lib_path(name) for name in build.SOURCES}
    monkeypatch.setitem(build.DROPPED_FLAGS, "mie_cheb_eval", ())
    assert "--fmad=false" in build.nvcc_flags("mie_cheb_eval")
    assert build.lib_path("mie_cheb_eval") != paths["mie_cheb_eval"]
    monkeypatch.setitem(build.DROPPED_FLAGS, "advect_scalar_5_3", ("--fmad=false",))
    assert build.lib_path("advect_scalar_5_3") != paths["advect_scalar_5_3"]
    assert build.lib_path("advect_tracers") == paths["advect_tracers"]
