"""Seconds from the harness's start to the window's: imports, the kernels'
build where the checkout has none yet, the case from the seed, the
`Simulation` and the warm-up steps (the check's own work left out)."""


def read(records):
    return records["setup_s"] if "window" in records else None
