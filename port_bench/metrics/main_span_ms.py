"""Milliseconds of device time a model step in the main executable's span
(``main``; the harness's spans block (b): spans on, no profiler; on a mesh
the cards' mean)."""

from port_bench import spans


def read(records):
    s = records.get("spans")
    total = spans.total(records, ["main"], "device_s")
    if total is None or not s["steps"]:
        return None
    return 1e3 * total / s["cards"] / s["steps"]
