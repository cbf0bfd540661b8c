from wrfchem_arc_interactions_tpu_torch.grid.grid import (  # noqa: F401
    Grid,
    grid_from_numpy,
    make_eta_levels,
    make_grid,
)
