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

The port so far covers the "main" executable of the config-3 step (dycore +
diffusion + Kessler) with radiation and chemistry off; the fused 5th/3rd
order scalar advection tendency runs as a hand-written CUDA kernel
(`csrc/advect_scalar_5_3.cu`, wrapper `ops/adv_kernel.py`).
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
