from port_bench.reference.wrf.config.namelist import (  # noqa: F401
    ChemConfig,
    Config,
    DomainConfig,
    DynamicsConfig,
    PhysicsConfig,
    TimeControl,
)
