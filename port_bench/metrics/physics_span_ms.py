"""Milliseconds of device time a model step in the main executable's
physics (``main/pre_physics`` and ``main/post_physics``: diffusion, PBL,
cumulus, microphysics, activation; spans block (b); on a mesh the cards'
mean)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    total = spans.total(records, ["main/pre_physics", "main/post_physics"], "device_s")
    if total is None or not s["steps"]:
        return None
    return 1e3 * total / s["cards"] / s["steps"]
