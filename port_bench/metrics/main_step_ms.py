"""Milliseconds of one main step, each closed by a synchronisation
(`Simulation.advance(phase_timing=True)`'s ``phase_times["main"]`` over the
phase-timed periods' steps)."""


def read(records):
    p = records.get("phases")
    if not p or not p["steps"]:
        return None
    return 1e3 * p["main_s"] / p["steps"]
