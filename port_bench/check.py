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


def field_errs(port: dict, ref: dict, device) -> dict:
    """{field: max|port - ref| / scale} (0 where both are equal, inf where
    either side holds a value that is not finite or a field is missing),
    the scale being the largest magnitude of the reference's field; `port`
    may sit on the host, each field goes to `device`."""
    errs = {}
    for k in sorted(set(port) | set(ref)):
        if k not in port or k not in ref:
            errs[k] = math.inf
            continue
        a = port[k].to(device)
        b = ref[k].to(device)
        if a.shape != b.shape:
            errs[k] = math.inf
        elif torch.equal(a, b):
            errs[k] = 0.0
        elif not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            errs[k] = math.inf
        else:
            diff = float((a.double() - b.double()).abs().max())
            errs[k] = diff / max(float(b.double().abs().max()), TINY)
        del a, b
    return errs


def state_numbers(errs: dict) -> dict:
    """``state_err``, the worst field's error, and ``state_err_field``,
    that field."""
    worst = max(sorted(errs), key=lambda f: errs[f])
    return {"state_err": errs[worst], "state_err_field": worst}


def verdict(numbers: dict, limits: dict) -> bool:
    """`correct`: every number of the cell's `limits` within its limit."""
    return all(numbers[k] <= v["limit"] for k, v in limits.items())
