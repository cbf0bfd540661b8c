"""PyTorch/CUDA port of `wrfchem_arc_interactions_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there (same sub-package, same file name) and is held against
it by the `tests/test_torch_*.py` tests.  The port imports neither JAX nor
anything of the JAX package.

Conventions kept from the reference: the state is a ``dict[str, Tensor]``,
3D fields are (nz, ny, nx) with z leading, the grid is a dataclass of
tensors.  The entry points (`models.ideal.make_case`,
`models.driver.Simulation`) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.

The port so far covers BASELINE config 3 whole — the "main" step (dycore +
diffusion + Kessler), RRTMG SW/LW on the radt alarm (in chunks of columns),
and MOSAIC 4-bin chemistry with fixed bins (dry deposition and aerosol
optics, fed back to radiation) on the chemdt alarm — and BASELINE config 4
whole, the interactive-ARC step: Morrison two-moment microphysics with
aerosol activation, CBM-Z gas chemistry with Fast-J photolysis and the
MOSAIC aerosol dynamics; and with them the rest of the chem driver for the
4- and 8-bin packages: constant emissions with plume rise, the cloud-borne
aerosol phase with aqueous chemistry, and wet scavenging; and the run
infrastructure (`io/`: history, restart, auxhist and emission files in
netCDF classic through the port's own C++ backend, built with g++ at first
use, or npz; tslist series, the NaN and CFL guards).  Four
hand-written CUDA kernels carry them (wrappers in `ops/`): the fused
5th/3rd-order scalar advection tendency (`adv_kernel.py`), the fused
multi-tracer RK-stage update (`tracers_kernel.py`, rows of any width), the
fast-Mie Chebyshev evaluator (`mie_kernel.py`), all three from `csrc/`, and
the sparse-LU ROS2 gas solver (`ros2_kernel.py`), whose CUDA source is
generated from the mechanism.
"""

__version__ = "0.1.0"

from wrfchem_arc_interactions_tpu_torch.config import (  # noqa: F401
    ChemConfig,
    Config,
    DomainConfig,
    DynamicsConfig,
    PhysicsConfig,
    TimeControl,
)
