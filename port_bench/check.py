"""The comparison that decides `correct`.

The numbers, each held to its limit (the cell's ``limits/<cell>.json``):

- ``start_err``: the case the port built from the seed against the case
  the reference builds from it, by per-field sums, sums of squares and
  extremes: the start, which the followed steps take from the port;
- ``state_err``: the port's state at the window's close against the
  reference's, which follows the window's last steps from the port's own
  state before them (a copy taken inside the window).  Per field, the
  largest difference over the largest magnitude of the reference's field;
  the number is the worst field's.

A field that holds anything but finite values on either side reads inf.
`verdict` turns the numbers into `correct`, for the port and for the
control put in its place alike.

On a cell of several cards no card holds the whole domain: the start's
statistics are taken on rank 0, which holds both global cases in turn,
and the state's per field from `field_maxima` of each rank's tiles,
joined by `merge_maxima` before `errs_from_maxima` divides, so that
`state_err` is the whole domain's number, as `field_errs` gives it.
"""

from __future__ import annotations

import math

import torch

TINY = 1e-30


def field_stats(state: dict, grid=None) -> dict:
    """{field: (sum, sum of squares, min, max)} in float64 on the host, of
    every state field and every tensor of the grid (``grid.<name>``)."""
    fields = dict(state)
    if grid is not None:
        fields.update({f"grid.{k}": v for k, v in vars(grid).items()
                       if isinstance(v, torch.Tensor)})
    out = {}
    for k, v in fields.items():
        x = v.detach().double()
        out[k] = torch.stack([x.sum(), (x * x).sum(), x.min(), x.max()]).cpu().tolist() \
            if x.numel() else [0.0, 0.0, 0.0, 0.0]
    return out


def stats_err(port: dict, ref: dict) -> tuple:
    """(worst relative difference of any statistic, its field)."""
    if set(port) != set(ref):
        return math.inf, f"fields differ: {sorted(set(port) ^ set(ref))[:6]}"
    worst, where = 0.0, None
    for k in sorted(ref):
        for a, b in zip(port[k], ref[k]):
            if not (math.isfinite(a) and math.isfinite(b)):
                err = math.inf
            else:
                err = abs(a - b) / max(abs(b), TINY) if a != b else 0.0
            if err > worst or where is None:
                worst, where = max(worst, err), k
    return worst, where


def field_maxima(port: dict, ref: dict, device) -> dict:
    """{field: (max|port - ref|, max|ref|, equal, finite)} in float64 on
    the host, the parts of `field_errs` that reduce over pieces of a
    domain by a maximum (and an all): `merge_maxima` joins the pieces and
    `errs_from_maxima` reads the whole domain's errors from them.  A field
    missing on one side, or of another shape, reads (inf, inf, False,
    False).  `port` may sit on the host; each field goes to `device`."""
    out = {}
    for k in sorted(set(port) | set(ref)):
        if k not in port or k not in ref:
            out[k] = (math.inf, math.inf, False, False)
            continue
        a = port[k].to(device)
        b = ref[k].to(device)
        if a.shape != b.shape:
            out[k] = (math.inf, math.inf, False, False)
            continue
        b64 = b.double()
        scale = float(b64.abs().max()) if b.numel() else 0.0
        if torch.equal(a, b):
            out[k] = (0.0, scale, True, bool(torch.isfinite(b).all()))
        elif not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            out[k] = (math.inf, scale, False, False)
        else:
            out[k] = (float((a.double() - b64).abs().max()), scale, False, True)
        del a, b, b64
    return out


def merge_maxima(parts) -> dict:
    """`field_maxima` of pieces that tile a domain, joined into the
    domain's: each maximum's maximum, each flag's all; a field that one
    piece lacks reads as missing."""
    parts = list(parts)
    names = sorted(set().union(*parts)) if parts else []
    out = {}
    for k in names:
        got = [p.get(k, (math.inf, math.inf, False, False)) for p in parts]
        out[k] = (max(g[0] for g in got), max(g[1] for g in got),
                  all(g[2] for g in got), all(g[3] for g in got))
    return out


def errs_from_maxima(maxima: dict) -> dict:
    """{field: error} as `field_errs` defines it, from `field_maxima`."""
    errs = {}
    for k, (diff, scale, equal, finite) in maxima.items():
        if equal:
            errs[k] = 0.0
        elif not finite:
            errs[k] = math.inf
        else:
            errs[k] = diff / max(scale, TINY)
    return errs


def field_errs(port: dict, ref: dict, device) -> dict:
    """{field: max|port - ref| / scale} (0 where both are equal, inf where
    either side holds a value that is not finite or a field is missing),
    the scale being the largest magnitude of the reference's field; `port`
    may sit on the host, each field goes to `device`."""
    return errs_from_maxima(field_maxima(port, ref, device))


def state_numbers(errs: dict) -> dict:
    """``state_err``, the worst field's error, and ``state_err_field``,
    that field."""
    worst = max(sorted(errs), key=lambda f: errs[f])
    return {"state_err": errs[worst], "state_err_field": worst}


def verdict(numbers: dict, limits: dict) -> bool:
    """`correct`: every number of the cell's `limits` within its limit."""
    return all(numbers[k] <= v["limit"] for k, v in limits.items())
