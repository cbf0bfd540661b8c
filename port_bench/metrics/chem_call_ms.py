"""Milliseconds of one chem call, closed by a synchronisation
(``phase_times["chem"]`` over the phase-timed periods' chem calls)."""


def read(records):
    p = records.get("phases")
    if not p or not p["chem_calls"]:
        return None
    return 1e3 * p["chem_s"] / p["chem_calls"]
