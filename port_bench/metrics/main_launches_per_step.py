"""Kernel launches a model step inside the main executable's span
(``main`` and every span in it; the host's launch calls in the profiled
spans block (a); on a mesh rank 0's)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    launches = spans.total(records, ["main"], "launches")
    if not launches or not s["steps"]:
        return None
    return launches / s["steps"]
