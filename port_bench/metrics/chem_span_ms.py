"""Milliseconds of device time a chem call in the chem executable's span
(``chem``; spans block (b); on a mesh the cards' mean)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    total = spans.total(records, ["chem"], "device_s")
    if total is None or not s["chem_calls"]:
        return None
    return 1e3 * total / s["cards"] / s["chem_calls"]
