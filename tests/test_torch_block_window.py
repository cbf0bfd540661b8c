"""Width does not change a column-local result: the chem call and the rad
call of config 4 (bench.py's `_cfg4` values) at 24x24x20, both alarms
ringing at step 0, on the whole domain and on an interior 16x16 window cut
from it (grid and state), are equal on the window's columns bit for bit.
A process mesh, whose blocks may have any width, relies on this.

On the CPU, PyTorch's vectorised elementwise loops compute the last
(n mod 32) elements of a tensor (with AVX-512; mod 16 with AVX2) in a scalar
path whose exp, log and pow round differently from the vector path's, so a
cell's last bits there depend on where the tensor ends: a 10x10 window at
20 levels (2,000 cells) differs from the domain in exactly its last 16
cells.  The window (16x16) and the row blocks (8 rows of 24) therefore hold
a multiple of 32 columns, as the domain does.  On the card every element
takes the same path, and `chip_smoke.py` holds a 100x100 window of a
500x500 block.

The diffusion's scalar stack in passes over slices of the tracer axis
(`utils.device.pass_slices`, which a stack whose temporaries would pass
`PASS_ELEMENTS` takes) against one pass, bit for bit, and
against the JAX package's `diffusion_tendencies` within 1e-5 of each
tendency's magnitude, as `test_torch_dycore.py` holds one pass.

And the chem call in blocks of rows (`chem.driver.row_blocks`, which a
domain whose optics temporaries would pass `PASS_ELEMENTS` takes) against
the call in one
piece, bit for bit, and against the JAX package's `chem_driver` within
`test_torch_slice4._compare`'s bound (1e-4 of each field's magnitude, or
three times the reference's own one-ulp noise where that is larger).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu import config as jcfg  # noqa: E402
from wrfchem_arc_interactions_tpu.chem import driver as jchem  # noqa: E402
from wrfchem_arc_interactions_tpu.dycore import diffusion as jdiff  # noqa: E402
from wrfchem_arc_interactions_tpu.models import ideal as jideal  # noqa: E402
from wrfchem_arc_interactions_tpu.parallel.halo import HaloOps as JHalo  # noqa: E402

from wrfchem_arc_interactions_tpu_torch import config as tcfg  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import driver as tchem  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.dycore import diffusion as tdiff  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.grid.grid import TENSOR_FIELDS  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.models.driver import Simulation  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops.stencil import win  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.parallel.halo import HaloOps  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.registry.state import (  # noqa: E402
    advected_names, state_from_numpy,
)
from wrfchem_arc_interactions_tpu_torch.utils import device as tdevice  # noqa: E402

from test_torch_slice import _rel, jax_grid_to_port, seed_chem  # noqa: E402
from test_torch_slice4 import GAS_SEED, _cfg4, _compare  # noqa: E402

N = 24                 # the domain's columns in x and y
WINDOW = (4, 5, 16)    # the window's (y0, x0, width)


def _case():
    """Config 4 at 24x24x20 in both packages from noon, both alarms every
    step, and one state seeded with numpy: bench.py's aerosol and gas seed,
    a random cloud and random aerosol optics."""
    jc, tc = (_cfg4(m, nx=N, ny=N, nz=20, steps_per_alarm=1) for m in (jcfg, tcfg))
    jg, js = jideal.make_case(jc, "squall2d_x", bubble_amp=3.0)
    js = seed_chem(dict(js), lambda a, v: np.full(a.shape, v, np.float32))
    for s, v in GAS_SEED:
        js[f"chem_{s}"] = np.full(js["t"].shape, v, np.float32)
    js = {k: np.array(v, np.float32) for k, v in js.items()}
    rng = np.random.default_rng(24)
    js["qc"] = (1e-3 * rng.uniform(0, 1, js["t"].shape)
                * (rng.uniform(size=js["t"].shape) > 0.7)).astype(np.float32)
    js["tau_aer_sw"] = (0.02 * rng.uniform(0, 1, js["tau_aer_sw"].shape)).astype(np.float32)
    js["ssa_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.9)
    js["asy_aer_sw"] = np.full_like(js["tau_aer_sw"], 0.65)
    return jc, tc, jg, js


def _cut(fields):
    """The window of every tensor whose trailing axes are the domain's."""
    y0, x0, n = WINDOW
    return {k: v[..., y0:y0 + n, x0:x0 + n].contiguous()
            if v.dim() >= 2 and tuple(v.shape[-2:]) == (N, N) else v
            for k, v in fields.items()}


def test_chem_and_rad_on_a_window_are_the_domains():
    _, tc, jg, js = _case()
    grid = jax_grid_to_port(jg)
    state = state_from_numpy(js, "cpu")
    grid_w = dataclasses.replace(grid, **_cut({k: getattr(grid, k) for k in TENSOR_FIELDS}))
    state_w = _cut(state)
    assert (grid_w.ny, grid_w.nx) == (WINDOW[2], WINDOW[2])
    sim = Simulation(tc, grid, state, device="cpu")
    t_now = np.float32(0.0)
    for key in ("chem", "rad"):
        fn = sim._stepper(key)
        whole, part = fn(state, grid, t_now), fn(state_w, grid_w, t_now)
        cut = _cut(whole)
        assert set(cut) == set(part)
        assert sum(whole[k] is not state[k] for k in whole) > (50 if key == "chem" else 5)
        differ = [k for k in part if not torch.equal(cut[k], part[k])]
        assert not differ, (key, differ)
    assert float(whole["swdown"].max()) > 100.0          # the rad call saw the sun


def test_chem_in_row_blocks(monkeypatch):
    jc, tc, jg, js = _case()
    grid = jax_grid_to_port(jg)
    state = state_from_numpy(js, "cpu")
    t_s, jd = np.float32(43200.0), np.float32(172.5)
    whole = tchem.chem_driver(state, grid, tc, 60.0, time_s=t_s, julian_day=jd)
    nz = state["t"].shape[0]
    assert tchem.row_blocks(N, N, nz) == [(0, N)]
    monkeypatch.setattr(tdevice, "PASS_ELEMENTS", 8 * N * nz * 30)   # 8 rows, 30 bands
    assert tchem.row_blocks(N, N, nz) == [(0, 8), (8, 16), (16, 24)]
    blocks = tchem.chem_driver(state, grid, tc, 60.0, time_s=t_s, julian_day=jd)
    assert set(blocks) == set(whole)
    differ = [k for k in whole if not torch.equal(whole[k], blocks[k])]
    assert not differ, differ
    jsj = {k: jnp.asarray(v) for k, v in js.items()}
    hx = JHalo(bc_x=jc.dynamics.bc_x, bc_y=jc.dynamics.bc_y)
    jout = jchem.chem_driver(jsj, jg, jc, hx, 60.0, time_s=t_s, julian_day=jd)
    jout_ulp = jchem.chem_driver(dict(jsj, t=jsj["t"] * np.float32(1.0 + 2.0 ** -23)),
                                 jg, jc, hx, 60.0, time_s=t_s, julian_day=jd)
    assert set(jout) == set(blocks)
    _compare(jout, jout_ulp, blocks, float(np.abs(np.asarray(jg.phb)).max()))
    assert float(blocks["chem_oh"].max()) > 0.0          # photolysis is live


def test_diffusion_in_stack_slices(monkeypatch):
    jc, tc, jg, js = _case()
    grid = jax_grid_to_port(jg)
    state = state_from_numpy(js, "cpu")
    names = advected_names(tc)
    cells = state["t"].numel()
    one = tdiff.diffusion_tendencies(state, grid, tc, HaloOps(), 6.0, names)
    assert tdevice.pass_slices(len(names), cells) == [(0, 107)]
    monkeypatch.setattr(tdevice, "PASS_ELEMENTS", 20 * cells)
    assert tdevice.pass_slices(len(names), cells) == [(a, min(107, a + 18))
                                                      for a in range(0, 107, 18)]
    passes = tdiff.diffusion_tendencies(state, grid, tc, HaloOps(), 6.0, names)
    assert set(passes) == set(one)
    differ = [k for k in one if not torch.equal(one[k], passes[k])]
    assert not differ, differ
    ref = jdiff.diffusion_tendencies({k: jnp.asarray(v) for k, v in js.items()}, jg, jc,
                                     JHalo(), 6.0, names)
    assert set(ref) == set(passes)
    for k in ref:
        a = np.asarray(ref[k])
        assert _rel(a, passes[k].numpy(), float(np.abs(a).max())) <= 1e-5, k


# The scalars' operators of `dycore/diffusion.py`, written out here as the
# plain PyTorch they are, so that a change to `ops/diffusion_kernel.py`'s
# plain version that moves a value shows.
def _hdiff_written_out(q_pad, k_pad, grid, pad=3):
    rdx2 = grid.rdx * grid.rdx
    rdy2 = grid.rdy * grid.rdy
    k_e = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, 1, pad=pad))
    k_w = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 0, -1, pad=pad))
    k_n = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, 1, 0, pad=pad))
    k_s = 0.5 * (win(k_pad, 0, 0, pad=pad) + win(k_pad, -1, 0, pad=pad))
    q0 = win(q_pad, 0, 0, pad=pad)
    return (rdx2 * (k_e * (win(q_pad, 0, 1, pad=pad) - q0)
                    - k_w * (q0 - win(q_pad, 0, -1, pad=pad)))
            + rdy2 * (k_n * (win(q_pad, 1, 0, pad=pad) - q0)
                      - k_s * (q0 - win(q_pad, -1, 0, pad=pad))))


def _vdiff_written_out(q, kv, dz2):
    dq = q[..., 1:, :, :] - q[..., :-1, :, :]
    zero = torch.zeros_like(q[..., :1, :, :])
    dq_up = torch.cat([dq, zero], dim=-3)
    dq_dn = torch.cat([zero, dq], dim=-3)
    return kv * (dq_up - dq_dn) / dz2


def _filter6_written_out(q_pad, factor, dt):
    wx = [win(q_pad, 0, m) for m in (-3, -2, -1, 0, 1, 2, 3)]
    wy = [win(q_pad, m, 0) for m in (-3, -2, -1, 0, 1, 2, 3)]
    coef = factor / (64.0 * dt)
    sx = (-wx[0] + 6 * wx[1] - 15 * wx[2] + 20 * wx[3] - 15 * wx[4] + 6 * wx[5] - wx[6])
    sy = (-wy[0] + 6 * wy[1] - 15 * wy[2] + 20 * wy[3] - 15 * wy[4] + 6 * wy[5] - wy[6])
    return -coef * (sx + sy)


@pytest.mark.parametrize("perturbed", [False, True], ids=["case", "perturbed"])
@pytest.mark.parametrize("diff_6th_opt", [0, 2])
def test_diffusion_stack_is_its_operators_written_out(monkeypatch, diff_6th_opt, perturbed):
    """`diffusion_tendencies` on CPU tensors, whose scalars' pass is
    `ops/diffusion_kernel.py`'s plain version there, bitwise as the stack's
    operators written out (`_hdiff`, then `+ _vdiff`, then `+ _filter6` on
    the padded stack, K from the Smagorinsky closure), on
    test_diffusion_in_stack_slices's case and on it with every scalar
    perturbed (by up to 10%, and by up to 2e-7 where it is 0, so that each
    tendency is live), in one pass and in passes of 18 scalars, with kvdif
    30 and the 6th-order filter off and on."""
    _, tc, jg, js = _case()
    tc = tc.replace(dynamics=dataclasses.replace(tc.dynamics, diff_6th_opt=diff_6th_opt))
    grid = jax_grid_to_port(jg)
    state = state_from_numpy(js, "cpu")
    names = advected_names(tc)
    if perturbed:
        rng = np.random.default_rng(136)
        for q in names:
            noise = torch.from_numpy(rng.uniform(0.9, 1.1, tuple(state[q].shape))
                                     .astype(np.float32))
            state[q] = state[q] * noise + 1e-6 * (noise - 0.9)
    hx = HaloOps()
    g = hx.pad_many({"u": state["u"], "v": state["v"]}, 3)
    k_pad = hx.pad(tdiff.smagorinsky_k(g["u"], g["v"], grid, tc), 3)
    ph_full = grid.phb + state["ph"]
    dz = (ph_full[1:] - ph_full[:-1]) / 9.81
    sc = torch.stack([state[q] for q in names])
    sc_pad = hx.pad(sc, 3)
    want = _hdiff_written_out(sc_pad, k_pad, grid) + _vdiff_written_out(sc, 30.0, dz * dz)
    if diff_6th_opt:
        want = want + _filter6_written_out(sc_pad, tc.dynamics.diff_6th_factor, 6.0)
    assert tc.dynamics.kvdif == 30.0
    for elements in (None, 20 * state["t"].numel()):
        if elements is not None:
            monkeypatch.setattr(tdevice, "PASS_ELEMENTS", elements)
        out = tdiff.diffusion_tendencies(state, grid, tc, hx, 6.0, names)
        differ = [q for i, q in enumerate(names) if not torch.equal(out[q], want[i])]
        assert not differ, differ
    live = sum(float(want[i].abs().max()) > 0.0 for i in range(len(names)))
    assert live == len(names) if perturbed else live > 0
