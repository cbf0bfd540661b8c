"""The acoustic substep's implicit W''-phi'' update
(`ops/advance_w_kernel.py`): the wrapper's routes and checks on the CPU,
and on the card the CUDA kernel bitwise against its plain version at
config 5's per-card block (61 w-levels, 500x500 columns), flat and with
terrain's surface row and a map factor, with and without the damping
profile, and on every substep of one main step of config 4 at 100x100x50,
one launch a substep.  The kernel itself runs on the CPU through the CUDA
emulation in `test_torch_emulated.py`.  This file imports no JAX: the
card's tests compare with the plain PyTorch version.
"""

import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

from wrfchem_arc_interactions_tpu_torch.ops import advance_w_kernel as ak  # noqa: E402


def _inputs(nz, ny, nx, dtype=torch.float32, device="cpu", seed=0, msf=False, terrain=False,
            damp=True):
    """One substep's inputs of plausible magnitudes, the rows diagonally
    dominant (s, eps_w, inv_mu, rdn_w > 0), as a tuple of `advance_w`'s
    arguments."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=dtype, device=device)

    nw = nz + 1
    w, rw = u(nw, ny, nx, lo=-2.0, hi=2.0), u(nw, ny, nx, lo=-0.5, hi=0.5)
    ph, rph = u(nw, ny, nx, lo=-50.0, hi=50.0), u(nw, ny, nx, lo=-5.0, hi=5.0)
    om = u(nw, ny, nx, lo=-0.3, hi=0.3)
    th, p_now = u(nz, ny, nx, lo=-3e4, hi=3e4), u(nz, ny, nx, lo=-200.0, hi=200.0)
    mu = u(ny, nx, lo=-300.0, hi=300.0)
    ac = {"coef_pt": u(nz, ny, nx, lo=1.0, hi=5.0), "s": u(nz, ny, nx, lo=50.0, hi=150.0),
          "inv_mu": u(ny, nx, lo=1e-5, hi=1.2e-5), "eps_w": u(nw, ny, nx, lo=0.99, hi=1.01),
          "rdn_w": u(nw, 1, 1, lo=30.0, hi=90.0), "dphdn_ref": u(nw, ny, nx, lo=-2e4, hi=2e4),
          "w_damp": (u(nw, ny, nx, lo=0.0, hi=0.2) if damp
                     else torch.zeros((1, 1, 1), dtype=dtype, device=device))}
    if msf:
        ac["msft"] = u(ny, nx, lo=0.95, hi=1.05)
        ac["inv_msft"] = 1.0 / ac["msft"]
    wsfc = u(ny, nx, lo=-0.2, hi=0.2) if terrain else None
    return w, ph, th, mu, om, p_now, rw, rph, ac, 1.5, 0.1, wsfc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["flat", "nodamp", "terrain_msf"])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype, kind):
    """A CPU tensor takes the plain version in the dtype it comes in, and
    launches nothing; the surface row is wsfc over terrain, 0 else, and
    phi'' at the surface stays as it was."""
    args = _inputs(6, 5, 7, dtype, msf=kind == "terrain_msf", terrain=kind == "terrain_msf",
                   damp=kind != "nodamp")
    n0 = ak.advance_w.launches
    w, ph = ak.advance_w(*args)
    w_ref, ph_ref = ak.advance_w_reference(*args)
    assert ak.advance_w.launches == n0
    assert w.dtype == ph.dtype == dtype and w.shape == ph.shape == (7, 5, 7)
    assert torch.equal(w, w_ref) and torch.equal(ph, ph_ref)
    assert torch.isfinite(w).all() and float(w[1:].abs().max()) > 0.0
    wsfc = args[-1]
    assert torch.equal(w[0], wsfc if wsfc is not None else torch.zeros_like(w[0]))
    assert torch.equal(ph[0], args[1][0])


def _bad(case):
    w, ph, th, mu, om, p_now, rw, rph, ac, dtau, epssm, wsfc = _inputs(4, 3, 5, terrain=True,
                                                                      msf=True)
    if case == "th_shape":
        th = th[1:]
    elif case == "w_damp_shape":
        ac["w_damp"] = ac["w_damp"][:, :1]
    elif case == "rdn_w_shape":
        ac["rdn_w"] = ac["rdn_w"].reshape(-1)
    elif case == "wsfc_shape":
        wsfc = wsfc[None]
    elif case == "one_level":
        w = w[:1]
    elif case == "strided":
        ph = ph.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "dtype":
        mu = mu.double()
    elif case == "not_tensor":
        om = om.numpy()
    elif case == "msft_alone":
        del ac["inv_msft"]
    elif case == "device":
        w, ph, th, mu, om, p_now, rw, rph, wsfc = (
            t.to("meta") for t in (w, ph, th, mu, om, p_now, rw, rph, wsfc))
        ac = {k: v.to("meta") for k, v in ac.items()}
    return w, ph, th, mu, om, p_now, rw, rph, ac, dtau, epssm, wsfc


@pytest.mark.parametrize("case", ["th_shape", "w_damp_shape", "rdn_w_shape", "wsfc_shape",
                                  "one_level", "strided", "dtype", "not_tensor", "msft_alone",
                                  "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        ak.advance_w(*_bad(case))


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "nodamp", "terrain_msf"])
def test_kernel_is_bitwise_at_the_block_on_gpu(kind):
    """Config 5's block, 61 w-levels over 500x500 columns: the kernel
    bitwise as its plain version, flat, without the damping profile, and
    with terrain's surface row and a map factor; one launch; the kernel
    refuses float64."""
    dev = _on_card()
    args = _inputs(60, 500, 500, device=dev, seed=7, msf=kind == "terrain_msf",
                   terrain=kind == "terrain_msf", damp=kind != "nodamp")
    n0 = ak.advance_w.launches
    w, ph = ak.advance_w(*args)
    torch.cuda.synchronize()
    assert ak.advance_w.launches == n0 + 1
    w_ref, ph_ref = ak.advance_w_reference(*args)
    assert torch.equal(w, w_ref) and torch.equal(ph, ph_ref)
    assert float(w[1:].abs().max()) > 0.0
    with pytest.raises(TypeError):
        ak.advance_w(*_inputs(4, 3, 5, dtype=torch.float64, device=dev))


@pytest.mark.cuda
def test_kernel_is_bitwise_on_a_main_step_on_gpu(monkeypatch):
    """One step of config 4's package at 100x100x50 through `Simulation`:
    each of the step's 7 acoustic substeps through the kernel, bitwise as
    the plain version on the same inputs, one launch a substep."""
    from test_torch_diffusion_kernel import GAS_SEED, _main_path_cfg
    from wrfchem_arc_interactions_tpu_torch.models import ideal
    from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation
    dev = _on_card()
    cfg = _main_path_cfg("config4")
    grid, state = ideal.make_case(cfg, "squall2d_x", device=dev, bubble_amp=3.0)
    for s, v in GAS_SEED:
        state[f"chem_{s}"] = torch.full_like(state["t"], v)
    real = ak.advance_w
    substeps = []

    def checked(*args):
        # the wrapper counts its launch on the module's `advance_w`, which
        # is this function while the step runs
        n0 = checked.launches
        out = real(*args)
        assert checked.launches == n0 + 1
        ref = ak.advance_w_reference(*args)
        substeps.append(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]))
        return out

    checked.launches = 0
    monkeypatch.setattr(ak, "advance_w", checked)
    sim = Simulation(cfg, grid, state, device=dev)
    sim.advance(1)
    sim.sync()
    assert checked.launches == len(substeps) == 7
    assert all(substeps), substeps
