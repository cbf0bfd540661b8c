"""Milliseconds of device time a model step in the dycore's span
(``main/dycore``: the RK3 stages, large step, acoustic loop, scalars'
advection; spans block (b); on a mesh the cards' mean)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    total = spans.total(records, ["main/dycore"], "device_s")
    if total is None or not s["steps"]:
        return None
    return 1e3 * total / s["cards"] / s["steps"]
