from wrfchem_arc_interactions_tpu_torch.config.namelist import (  # noqa: F401
    ChemConfig,
    Config,
    DomainConfig,
    DynamicsConfig,
    PhysicsConfig,
    TimeControl,
)
