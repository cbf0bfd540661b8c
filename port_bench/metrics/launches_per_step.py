"""Kernels launched per model step in the traced periods (the profiler's
kernel events over the periods' steps, chem and rad calls included)."""


def read(records):
    t = records.get("trace")
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["steps"]
