from port_bench.reference.wrf.grid.grid import (  # noqa: F401
    Grid,
    grid_from_numpy,
    make_eta_levels,
    make_grid,
)
