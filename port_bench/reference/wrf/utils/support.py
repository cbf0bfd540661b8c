"""What the port refuses.

The port carries every module and option of the reference: the dycore with
every advection order, its limiters, diffusion and stochastic schemes;
every microphysics, boundary-layer, land-surface, cumulus and radiation
scheme; the whole chem driver for every package; the run infrastructure;
real data, nesting and ndown; and the domain decomposition over a process
mesh, nests on a mesh included.  What it refuses is an option that the
reference reads nowhere: `check_config` raises `NotImplementedError` for
it, with the reason, rather than run silently without it.
"""

from __future__ import annotations

from port_bench.reference.wrf.config import Config


def check_config(cfg: Config) -> None:
    """Raise `NotImplementedError` for any option the port does not carry."""
    if cfg.chem.aer_op_opt != 1:
        raise NotImplementedError(
            f"aer_op_opt={cfg.chem.aer_op_opt}: the reference reads this option nowhere "
            "and always mixes by volume (option 1); the port refuses other values "
            "rather than ignore them")

