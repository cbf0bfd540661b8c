"""The scalars' diffusion pass (`ops/diffusion_kernel.py`): the wrapper's
routes and checks on the CPU, and on the card the CUDA kernel bitwise
against its plain version, on one pass's slice at config 5's per-card
block (18 scalars, 60 levels, 500x500 columns padded to 506x506) and on
every pass of one main step of config 3 and of config 4 at 100x100x50,
with the launch count rising by one a pass.  The kernel itself runs on
the CPU through the CUDA emulation in `test_torch_emulated.py`.  This file
imports no JAX: the card's tests compare with the plain PyTorch version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.config import namelist as nl  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid import make_grid  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.soundings import constant_n2_theta  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import diffusion_kernel as dk  # noqa: E402

# bench.py's seeds: config 3's aerosol in bins 1-2, and config 4's gases [ppmv]
AEROSOL_SEED = (("so4", 2.0), ("oc", 1.0), ("num", 2e9))
GAS_SEED = (("o3", 0.04), ("no2", 2e-3), ("no", 1e-3), ("co", 0.12), ("so2", 2e-3),
            ("h2o2", 1e-3))


def _main_path_cfg(config):
    """bench.py's config 3 (Kessler, RRTMG, MOSAIC 4-bin optics, 47
    scalars) or config 4 (Morrison, RRTMG, CBM-Z + MOSAIC 4-bin, 107) at
    100x100x50 from noon, both alarms every 2 steps."""
    physics = (tcfg.PhysicsConfig(mp_physics=nl.MPScheme.KESSLER,
                                  ra_sw_physics=nl.RAScheme.RRTMG,
                                  ra_lw_physics=nl.RAScheme.RRTMG, radt_s=12.0)
               if config == "config3" else
               tcfg.PhysicsConfig(mp_physics=nl.MPScheme.MORRISON2, progn=True,
                                  ra_sw_physics=nl.RAScheme.RRTMG,
                                  ra_lw_physics=nl.RAScheme.RRTMG, radt_s=12.0))
    chem = (tcfg.ChemConfig(chem_opt=nl.ChemOpt.MOSAIC_4BIN, chemdt_s=12.0,
                            aer_ra_feedback=True, gaschem_onoff=False, aerchem_onoff=False)
            if config == "config3" else
            tcfg.ChemConfig(chem_opt=nl.ChemOpt.CBMZ_MOSAIC_4BIN, chemdt_s=12.0,
                            aer_ra_feedback=True))
    return tcfg.Config(
        domain=tcfg.DomainConfig(nx=100, ny=100, nz=50, dx=1000.0, dy=1000.0,
                                 ztop=17000.0, p_top=8000.0),
        time_control=tcfg.TimeControl(dt=6.0, start_date="2000-06-20_12:00:00"),
        dynamics=tcfg.DynamicsConfig(kvdif=30.0), physics=physics, chem=chem)


def _grid(nz, ny, nx, device="cpu"):
    cfg = tcfg.Config(domain=tcfg.DomainConfig(nx=nx, ny=ny, nz=nz, dx=1000.0, dy=800.0,
                                               ztop=17000.0, p_top=8000.0))
    return make_grid(cfg, constant_n2_theta(), torch.device(device))


def _inputs(nt, nz, ny, nx, dtype=torch.float32, device="cpu", seed=0):
    """A padded slice of scalars of every magnitude, K of ~10-300 m2/s and
    dz^2 of layers of 100-600 m."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, dtype=dtype, device=device)

    sc_pad = 10.0 ** (6.0 * u(nt, 1, 1, 1) - 3.0) * (1.0 + u(nt, nz, ny + 6, nx + 6))
    k_pad = 10.0 + 290.0 * u(nz, ny + 6, nx + 6)
    dz2 = (100.0 + 500.0 * u(nz, ny, nx)) ** 2
    return sc_pad, k_pad, dz2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("vdiff", [False, True], ids=["h", "h+v"])
@pytest.mark.parametrize("filter6", [None, (0.12, 6.0)], ids=["plain", "filter6"])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype, vdiff, filter6):
    """A CPU tensor takes the plain version in the dtype it comes in, and
    launches nothing; every term acts."""
    grid = _grid(5, 7, 9)
    sc_pad, k_pad, dz2 = _inputs(3, 5, 7, 9, dtype)
    n0 = dk.diffuse_scalars.launches
    out = dk.diffuse_scalars(sc_pad, k_pad, grid, dz2 if vdiff else None, 30.0, filter6)
    ref = dk.diffuse_scalars_reference(sc_pad, k_pad, grid, dz2 if vdiff else None, 30.0,
                                       filter6)
    assert dk.diffuse_scalars.launches == n0
    assert out.dtype == dtype and tuple(out.shape) == (3, 5, 7, 9)
    assert torch.equal(out, ref)
    h = dk._hdiff(sc_pad, k_pad, grid)
    assert torch.equal(out, h) == (not vdiff and filter6 is None)


def _bad(case):
    sc_pad, k_pad, dz2 = _inputs(2, 4, 5, 6)
    if case == "k_shape":
        k_pad = k_pad[:, 1:]
    elif case == "dz2_shape":
        dz2 = dz2[:-1]
    elif case == "slice_dims":
        sc_pad = sc_pad[0]
    elif case == "empty":
        sc_pad = sc_pad[:0]
    elif case == "strided":
        sc_pad = sc_pad.transpose(0, 1)
    elif case == "dtype":
        k_pad = k_pad.double()
    elif case == "not_tensor":
        dz2 = dz2.numpy()
    elif case == "device":
        sc_pad, k_pad, dz2 = (t.to("meta") for t in (sc_pad, k_pad, dz2))
    return sc_pad, k_pad, dz2


@pytest.mark.parametrize("case", ["k_shape", "dz2_shape", "slice_dims", "empty", "strided",
                                  "dtype", "not_tensor", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    sc_pad, k_pad, dz2 = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        dk.diffuse_scalars(sc_pad, k_pad, _grid(4, 5, 6), dz2, 30.0)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vdiff", [False, True], ids=["h", "h+v"])
@pytest.mark.parametrize("filter6", [None, (0.12, 6.0)], ids=["plain", "filter6"])
def test_kernel_is_bitwise_at_the_block_slice_on_gpu(vdiff, filter6):
    """One pass's slice at config 5's block, (18, 60, 506, 506): the kernel
    bitwise as its plain version, with and without each optional term; one
    launch; and the kernel refuses float64."""
    dev = _on_card()
    nt, nz, ny, nx = 18, 60, 500, 500
    grid = _grid(nz, ny, nx, dev)
    sc_pad, k_pad, dz2 = _inputs(nt, nz, ny, nx, device=dev, seed=5)
    dz2 = dz2 if vdiff else None
    n0 = dk.diffuse_scalars.launches
    out = dk.diffuse_scalars(sc_pad, k_pad, grid, dz2, 30.0, filter6)
    torch.cuda.synchronize()
    assert dk.diffuse_scalars.launches == n0 + 1
    ref = dk.diffuse_scalars_reference(sc_pad, k_pad, grid, dz2, 30.0, filter6)
    assert torch.equal(out, ref)
    assert float(out.abs().max()) > 0.0
    with pytest.raises(TypeError):
        dk.diffuse_scalars(sc_pad.double(), k_pad.double(), grid, None, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["config3", "config4"])
def test_kernel_is_bitwise_on_a_main_step_on_gpu(config, monkeypatch):
    """One step of config 3 (47 scalars) and of config 4 (107) at 100x100x50
    through `Simulation`, every advected scalar perturbed so that its
    tendency is live: each pass of the step's diffusion through the
    kernel, bitwise as the plain version on the same inputs, one launch a
    pass (one pass a step at this size)."""
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    from wrfchem_arc_interactions_tpu_torch.registry.state import advected_names
    dev = _on_card()
    cfg = _main_path_cfg(config)
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    for b in (1, 2):
        for s, v in AEROSOL_SEED:
            state[f"chem_{s}_a{b:02d}"] = torch.full_like(state["t"], v)
    if config == "config4":
        for s, v in GAS_SEED:
            state[f"chem_{s}"] = torch.full_like(state["t"], v)
    rng = np.random.default_rng(23)
    names = advected_names(cfg)
    for q in names:
        noise = torch.from_numpy(rng.uniform(0.9, 1.1, tuple(state[q].shape))
                                 .astype(np.float32)).to(dev)
        state[q] = state[q] * noise + 1e-6 * (noise - 0.9)
    real = dk.diffuse_scalars
    passes = []

    def checked(sc_pad, k_pad, grid, dz2=None, kvdif=0.0, filter6=None):
        # the wrapper counts its launch on the module's `diffuse_scalars`,
        # which is this function while the step runs
        n0 = checked.launches
        out = real(sc_pad, k_pad, grid, dz2, kvdif, filter6)
        assert checked.launches == n0 + 1
        ref = dk.diffuse_scalars_reference(sc_pad, k_pad, grid, dz2, kvdif, filter6)
        passes.append((sc_pad.shape[0], torch.equal(out, ref), float(out.abs().max())))
        return out

    checked.launches = 0
    monkeypatch.setattr(dk, "diffuse_scalars", checked)
    sim = Simulation(cfg, grid, state, device=dev)
    sim.advance(1)
    sim.sync()
    assert checked.launches == len(passes) == 1
    assert passes[0][0] == len(names) == (47 if config == "config3" else 107)
    assert passes[0][1], "kernel and plain version differ"
    assert passes[0][2] > 0.0
