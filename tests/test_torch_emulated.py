"""The port's hand-written CUDA sources, run on the CPU.

There is no CUDA compiler beside the CPU tests, so what a kernel's source
computes is otherwise checked only on the card.  Here a host C++ compiler
builds the source itself against a stand-in for ``cuda_runtime.h``
(``tests/cuda_emulation/cuda_runtime.h``: one host thread per CUDA thread,
a barrier for ``__syncthreads()``, shared memory filled with NaNs before
each block), after the few constructs it cannot parse are rewritten: the
``<<<...>>>`` launch becomes a call, a ``cp.async`` copy an assignment, the
``extern __shared__`` array a pointer.  Built with ``-ffp-contract=off`` the
float arithmetic rounds as the card's does under ``--fmad=false``, so each
kernel is held *bitwise* to its plain PyTorch version:

- ``csrc/advect_tracers.cu`` at the small shapes that stress its tile, its
  rings of planes and its slots, on every lateral boundary kind, with and
  without the limiter;
- the ROS2 gas kernel that ``ops/ros2_kernel.py`` generates, for one and two
  substeps over a few blocks of its persistent grid.

What this cannot see: races (the host threads are few at a time), the
card's alignment rules, and whether ``nvcc`` accepts the source.  Skipped
where no host C++ compiler is installed.
"""

import ctypes
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
from wrfchem_arc_interactions_tpu_torch.ops import build, ros2_kernel, tracers_kernel  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps  # noqa: E402

from test_torch_gas import polluted_start  # noqa: E402
from test_torch_tracers import _boundary_cases, _grids, _inputs, _t  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

_REWRITES = (
    (r"extern __shared__ (?:__align__\(16\) )?float (\w+)\[\];", r"float* \1 = emu_smem;"),
    (r"^.*__cvta_generic_to_shared.*$", ""),
    (r"^.*cp\.async\.ca\.shared\.global.*$", "  *dst = *src;"),
    (r"^.*cp\.async\.cg\.shared\.global.*$", "  for (int e_ = 0; e_ < 4; ++e_) dst[e_] = src[e_];"),
    (r"^.*cp\.async\.wait_all.*$", "  ;"),
    (r"([\w<>, ]+?)<<<([^,]+), ([^,]+), ([^,]+), \w+>>>\((.*)\);", r"emu_launch(\1, \2, \3, \4, \5);"),
)


def _emulated(text: str, name: str, tmp) -> ctypes.CDLL:
    """Rewrite CUDA source `text` for a host compiler, build and load it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    for pat, rep in _REWRITES:
        text, n = re.subn(pat, rep, text, flags=re.M)
    assert "<<<" not in text and "emu_launch(" in text
    src, lib = os.path.join(tmp, f"{name}.cpp"), os.path.join(tmp, f"{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
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


@pytest.mark.parametrize("pd", [False, True])
@pytest.mark.parametrize("case", _boundary_cases(), ids=lambda c: "-".join(map(str, c)))
def test_emulated_tracer_kernel_is_bitwise_its_plain_version(tracers_lib, case, pd):
    nz, ny, nx, bc_x, bc_y = case
    _, tg = _grids(nz, ny, nx)
    f = {k: _t(v) for k, v in _inputs(tg, seed=7 + nz).items()}
    hx = HaloOps(bc_x=BCKind(bc_x), bc_y=BCKind(bc_y))
    q_pad, ru, rv = (hx.pad(f[k], 3).contiguous() for k in ("q", "ru", "rv"))
    ref = tracers_kernel.advect_tracers_reference(
        q_pad, f["phi"], ru, rv, f["ww"], f["mu_full"], f["mu_new"], tg, hx, 6.0,
        pt=f["pt"], pd=pd, clip=pd)
    out, r_hi = torch.full_like(ref, float("nan")), torch.full_like(ref, float("nan"))
    code = tracers_kernel._BC_CODE
    err = tracers_lib.advect_tracers(
        q_pad.data_ptr(), f["phi"].data_ptr(), f["pt"].data_ptr(), ru.data_ptr(),
        rv.data_ptr(), f["ww"].data_ptr(), f["mu_full"].data_ptr(), f["mu_new"].data_ptr(),
        tg.rdnw.data_ptr(), r_hi.data_ptr(), out.data_ptr(), *ref.shape, float(tg.rdx),
        float(tg.rdy), 6.0, int(pd), int(pd), code[hx.bc_x], code[hx.bc_y], None)
    assert err == 0
    assert float((ref - f["q"]).abs().max()) > 1e-3            # the stage does something
    assert torch.equal(out, ref)


def test_emulated_tracer_kernel_refuses_a_row_too_wide(tracers_lib):
    nz, ny, nx = 1, 2, 1200
    z = torch.zeros((1, nz, ny + 6, nx + 6))
    c = torch.zeros((1, nz, ny, nx))
    err = tracers_lib.advect_tracers(
        z.data_ptr(), c.data_ptr(), None, z.data_ptr(), z.data_ptr(), c.data_ptr(),
        c.data_ptr(), c.data_ptr(), c.data_ptr(), c.data_ptr(), c.data_ptr(), 1, nz, ny, nx,
        1.0, 1.0, 6.0, 1, 1, 0, 0, None)
    assert err == tracers_kernel._ROW_TOO_WIDE


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
