"""Grid points advanced per second [M]: nx*ny*nz times the model steps of
the window's whole periods, over the window's seconds (host clock, from the
first period's start to the last one's synchronisation)."""


def read(records):
    w = records.get("window")
    if not w:
        return None
    nx, ny, nz = records["shape"]
    return nx * ny * nz * w["steps"] / w["seconds"] / 1e6
