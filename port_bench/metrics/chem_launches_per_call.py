"""Kernel launches a chem call inside the chem executable's span (``chem``
and every span in it; the profiled spans block (a); on a mesh rank 0's)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    launches = spans.total(records, ["chem"], "launches")
    if not launches or not s["chem_calls"]:
        return None
    return launches / s["chem_calls"]
