"""McICA cloud overlap: stochastic subcolumn sampling of partial cloudiness
(port of the JAX package's `physics/radiation/mcica.py`; canonical: the
mcica_subcol_gen_lw/sw modules of phys/module_ra_rrtmg_{lw,sw}.F).

Each g-point gets its own binary cloud subcolumn drawn from the layer
cloud-fraction profile with maximum-random overlap (Raisanen et al. 2004).
The deviates come from a stateless integer hash of (g-point, layer, seed),
the same hash as the reference's, so the masks match it bit for bit.  The
hash's uint32 arithmetic runs in int64 here, each product cut to its low
32 bits (`_mul32` splits the multiplier so that no product overflows).
The overlap recursion is a Python loop over z on (g-point, column) planes.

Also provides the Xu & Randall (1996) diagnostic cloud fraction used when
``icloud=1``.
"""

from __future__ import annotations

import torch

from wrfchem_arc_interactions_tpu_torch.utils import constants as c

# minimum in-cloud fraction when normalising condensate to in-cloud values
CF_MIN = 0.02

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant k,
    with every intermediate below 2**49."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply finalizer (splitmix-style avalanche) on uint32
    values held in int64."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def uniform_gk(ngpt: int, nz: int, seed, device=None) -> torch.Tensor:
    """(nz, ngpt) float32 uniforms in [0,1) from a stateless hash of
    (layer, g, seed).  `seed` is an int or an integer tensor."""
    g = torch.arange(ngpt, dtype=torch.int64, device=device)[None, :]
    k = torch.arange(nz, dtype=torch.int64, device=device)[:, None]
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    h = _hash_u32((_mul32(g, 0x9E3779B1) + _mul32(k, 0x85EBCA77)
                   + _mul32(s, 0xC2B2AE3D)) & _M32)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def mcica_mask(cldfra: torch.Tensor, ngpt: int, seed=0) -> torch.Tensor:
    """Binary cloud mask per g-point subcolumn, maximum-random overlap.

    cldfra: (nz, ncol) layer cloud fraction in [0,1], level 0 = surface.
    Returns the float mask (ngpt, nz, ncol): 1 where that subcolumn is
    cloudy.
    """
    nz, ncol = cldfra.shape
    r = uniform_gk(ngpt, nz, seed, cldfra.device)              # (nz, ngpt)
    mask = torch.empty((ngpt, nz, ncol), dtype=cldfra.dtype, device=cldfra.device)
    x_above = torch.zeros((ngpt, ncol), dtype=cldfra.dtype, device=cldfra.device)
    cf_above = torch.zeros((ncol,), dtype=cldfra.dtype, device=cldfra.device)
    for k in range(nz - 1, -1, -1):                            # from model top
        cf_k = cldfra[k]
        # max-random: a subcolumn cloudy in the layer above keeps its
        # deviate (maximum overlap); otherwise draw fresh, compressed into
        # the clear part of the layer above (random overlap across gaps)
        clear_above = (1.0 - cf_above)[None, :]
        fresh = r[k][:, None] * clear_above
        x = torch.where(x_above > clear_above, x_above, fresh)
        mask[:, k] = (x > (1.0 - cf_k)[None, :]).to(cldfra.dtype)
        x_above, cf_above = x, cf_k
    return mask


def _qsat(p, t):
    """Saturation mixing ratio over liquid (Tetens)."""
    es = 610.78 * torch.exp(17.27 * (t - c.SVPT0) / torch.clamp(t - 35.86, min=1.0))
    es = torch.minimum(es, 0.5 * p)
    return 0.622 * es / (p - es)


def xu_randall_cldfra(p_lay, t_lay, qv, qcond) -> torch.Tensor:
    """Xu & Randall (1996) semi-empirical cloud fraction (icloud=1):
    CF = RH^0.25 * (1 - exp(-alpha0 * qc / ((1-RH) qs)^gamma)), alpha0=100,
    gamma=0.49.  qcond = total cloud condensate (liquid + ice) [kg/kg]."""
    qs = _qsat(p_lay, t_lay)
    rh = torch.clamp(qv / torch.clamp(qs, min=1e-10), 0.0, 1.0)
    sub = torch.clamp((1.0 - rh) * qs, min=1e-10) ** 0.49
    cf = rh ** 0.25 * (1.0 - torch.exp(-100.0 * qcond / sub))
    cf = torch.where(qcond > 1e-9, torch.clamp(cf, 0.0, 1.0), 0.0)
    # saturated cells with condensate are overcast
    return torch.where((rh >= 0.999) & (qcond > 1e-7), 1.0, cf)
