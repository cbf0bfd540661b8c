"""One acoustic substep's vertically implicit W''-phi'' update (WRF's
advance_w): CUDA kernel wrapper and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's implicit solve is plain `jnp`
with a `lax.scan` Thomas solve (`dycore/small_step.py`).  The plain version
builds the tridiagonal rows A, B, C, D from some 60 whole-array operators
and solves them with `dycore/tridiag.py::thomas`, a Python loop over the
levels: 672 launches a substep at config 5's 500x500x60 block (392 mul, 188
sub, 61 reciprocal, ...), most of them on single 1-MB planes, which the
host cannot issue as fast as the card runs them.  The kernel (``csrc/advance_w.cu``) does the update in one
launch, one thread a column sweeping up and down its levels; it reads each
input once and writes w and phi'' once, which is its bound (0.85 GB a
substep at the block, 0.25 ms at 3.35 TB/s).  The source's header states
the design.  The kernel rounds where the plain version does
(``--fmad=false``): the two are bitwise equal.

`advance_w` launches the kernel for CUDA tensors and runs
`advance_w_reference` for CPU tensors; it never falls back from one to the
other.  The plain version takes the dtype it is given (the CPU tests hold
some paths in float64); the kernel takes float32 only.
``advance_w.launches`` counts kernel launches: one a substep.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from wrfchem_arc_interactions_tpu_torch.dycore.tridiag import thomas
from wrfchem_arc_interactions_tpu_torch.ops import build
from wrfchem_arc_interactions_tpu_torch.utils.constants import G

Tensors = Dict[str, torch.Tensor]

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] + [ctypes.c_void_p] * 12
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# the stage coefficients of `ac` that the update reads (the last two on a
# projected grid only)
STAGE_KEYS = ("coef_pt", "s", "inv_mu", "eps_w", "rdn_w", "dphdn_ref", "w_damp", "msft",
              "inv_msft")
_W_LEVEL = ("eps_w", "dphdn_ref")
_MASS_LEVEL = ("coef_pt", "s")


def advance_w_reference(w, ph, th, mu, om, p_now, rw, rph, ac: Tensors, dtau: float,
                        epssm: float, wsfc=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the new (w, ph) of one substep from the substep's new
    th, mu, om and its p_now, the old w and ph, the slow tendencies rw and
    rph, and the stage coefficients `ac` (coef_pt, s, inv_mu, eps_w, rdn_w,
    dphdn_ref, w_damp; msft and inv_msft on a projected grid); `wsfc` the
    kinematic surface w over terrain, None on a flat grid (w = 0 there)."""
    bp, bm = 0.5 * (1.0 + epssm), 0.5 * (1.0 - epssm)
    coef_pt = ac["coef_pt"]
    s = ac["s"]
    inv_mu = ac["inv_mu"]
    eps_w = ac["eps_w"]
    rdn_w = ac["rdn_w"]
    dphdn_ref = ac["dphdn_ref"]
    msf = "msft" in ac
    m_t = ac.get("msft")
    inv_m = ac["inv_msft"][None] if msf else 1.0

    a_w = dtau * G * bp * inv_mu
    gw_m = (G * m_t * inv_mu)[None] if msf else G * inv_mu[None]
    ph_exp_t = (rph - om * dphdn_ref * inv_mu[None]
                + gw_m * bm * w)
    ph_exp = ph + dtau * ph_exp_t
    ph_exp[0] = ph[0]                                 # phi''_sfc frozen

    p_theta = coef_pt * th
    p_exp = p_theta + s * (ph_exp[1:] - ph_exp[:-1])
    # p'' = 0 above the lid: "up" arrays padded with zero at k = nz
    zero2d = torch.zeros_like(p_exp[:1])
    p_exp_up = torch.cat([p_exp, zero2d], dim=0)
    p_exp_dn = torch.cat([zero2d, p_exp], dim=0)
    p_old_up = torch.cat([p_now, zero2d], dim=0)
    p_old_dn = torch.cat([zero2d, p_now], dim=0)
    s_up = torch.cat([s, torch.zeros_like(s[:1])], dim=0)
    s_dn = torch.cat([torch.zeros_like(s[:1]), s], dim=0)

    dpdn_exp = rdn_w * (p_exp_up - p_exp_dn)
    dpdn_old = rdn_w * (p_old_up - p_old_dn)

    K = dtau * G * eps_w * bp * rdn_w * a_w[None]
    A = -K * s_dn
    C = -K * s_up
    B = 1.0 + K * (s_up + s_dn) + dtau * ac["w_damp"]
    D = (w + dtau * (rw
                     + (G * inv_m) * eps_w * (bp * dpdn_exp + bm * dpdn_old)
                     - (G * inv_m) * mu[None]))
    # surface row: flat => W'' = 0; terrain => the kinematic BC with the
    # new acoustic winds (reference part + perturbation-wind part)
    A[0] = 0.0
    C[0] = 0.0
    B[0] = 1.0
    if wsfc is not None:
        D[0] = wsfc
    else:
        D[0] = 0.0
    w = thomas(A, B, C, D)
    ph = ph_exp + (a_w * m_t if msf else a_w)[None] * w
    ph[0] = ph_exp[0]
    return w, ph


def _check(w, ph, th, mu, om, p_now, rw, rph, ac: Tensors, wsfc) -> Tuple[int, int, int]:
    """Raise unless every input is a contiguous tensor of w's dtype and
    device with its shape; returns (nz, ny, nx)."""
    if not isinstance(w, torch.Tensor) or w.dim() != 3 or w.shape[0] < 2:
        raise ValueError("w must be a (nz+1, ny, nx) tensor with nz >= 1")
    nw, ny, nx = w.shape
    nz = nw - 1
    if ny < 1 or nx < 1:
        raise ValueError(f"empty domain in w {tuple(w.shape)}")
    msf = "msft" in ac
    if msf != ("inv_msft" in ac):
        raise ValueError("msft and inv_msft come together")
    w_damp = ac["w_damp"]
    full = isinstance(w_damp, torch.Tensor) and w_damp.numel() > 1
    shapes = {"ph": (ph, (nw, ny, nx)), "om": (om, (nw, ny, nx)),
              "rw": (rw, (nw, ny, nx)), "rph": (rph, (nw, ny, nx)),
              "th": (th, (nz, ny, nx)), "p_now": (p_now, (nz, ny, nx)),
              "mu": (mu, (ny, nx)), "inv_mu": (ac["inv_mu"], (ny, nx)),
              "rdn_w": (ac["rdn_w"], (nw, 1, 1)),
              "w_damp": (w_damp, (nw, ny, nx) if full else (1, 1, 1))}
    shapes.update({k: (ac[k], (nw, ny, nx)) for k in _W_LEVEL})
    shapes.update({k: (ac[k], (nz, ny, nx)) for k in _MASS_LEVEL})
    if msf:
        shapes.update({k: (ac[k], (ny, nx)) for k in ("msft", "inv_msft")})
    if wsfc is not None:
        shapes["wsfc"] = (wsfc, (ny, nx))
    for name, (t, shape) in shapes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != w.dtype:
            raise TypeError(f"{name} is {t.dtype}, w {w.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    return nz, ny, nx


def launch(lib: ctypes.CDLL, w, ph, th, mu, om, p_now, rw, rph, ac: Tensors, dtau: float,
           epssm: float, wsfc, w_out, ph_out, stream) -> int:
    """Launch kernel library `lib` on checked inputs into `w_out`, `ph_out`
    on `stream`; the scalars as the plain version's Python floats round
    them to float32.  Returns the CUDA error code (0 on success)."""
    fn = lib.advance_w
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    bp, bm = 0.5 * (1.0 + epssm), 0.5 * (1.0 - epssm)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    return fn(ptr(w), ptr(ph), ptr(rw), ptr(rph), ptr(om), ptr(ac["dphdn_ref"]),
              ptr(ac["eps_w"]), ptr(ac["w_damp"]), int(ac["w_damp"].numel() > 1), ptr(th),
              ptr(ac["coef_pt"]), ptr(ac["s"]), ptr(p_now), ptr(ac["rdn_w"]), ptr(mu),
              ptr(ac["inv_mu"]), ptr(ac.get("msft")), ptr(ac.get("inv_msft")), ptr(wsfc),
              ptr(w_out), ptr(ph_out), *p_now.shape,
              float(dtau), float(dtau * G), float(dtau * G * bp), float(bp), float(bm),
              float(G), stream)


def plan(lib: ctypes.CDLL, nz: int, ncol: int) -> dict:
    """The grid the kernel library `lib` launches for nz mass levels and
    ncol columns: threads of a block, blocks, shared bytes a block, blocks
    an SM, registers and spilled bytes a thread."""
    fn = lib.advance_w_plan
    fn.argtypes = _PLAN_ARGTYPES
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(nz, ncol, out)
    if err != 0:
        raise RuntimeError(f"advance_w_plan failed: cudaError {err}")
    return dict(zip(("threads", "blocks", "shared_bytes", "blocks_per_sm", "registers",
                     "local_bytes"), out))


def advance_w(w, ph, th, mu, om, p_now, rw, rph, ac: Tensors, dtau: float, epssm: float,
              wsfc=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The new (w, ph) of one acoustic substep (see `advance_w_reference`):
    w, ph, om, rw, rph (nz+1, ny, nx); th, p_now (nz, ny, nx); mu (ny, nx);
    `ac` the stage coefficients; `wsfc` (ny, nx) over terrain or None."""
    _check(w, ph, th, mu, om, p_now, rw, rph, ac, wsfc)
    if w.device.type == "cpu":
        return advance_w_reference(w, ph, th, mu, om, p_now, rw, rph, ac, dtau, epssm, wsfc)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {w.dtype}")
    w_out, ph_out = torch.empty_like(w), torch.empty_like(ph)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = launch(build.load("advance_w"), w, ph, th, mu, om, p_now, rw, rph, ac, dtau,
                     epssm, wsfc, w_out, ph_out, stream)
    if err != 0:
        raise RuntimeError(f"advance_w launch failed: cudaError {err}")
    advance_w.launches += 1
    return w_out, ph_out


advance_w.launches = 0
