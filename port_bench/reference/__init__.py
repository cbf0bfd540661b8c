"""The reference that `correct` is decided against.

`wrf` is a frozen copy of the PyTorch port's plain path as of the commit
that added the benchmark: the modules the three executables (main, chem,
rad) and the ideal cases reach, with the package's name replaced by this
one and the four CUDA kernels' wrappers replaced by their plain versions
(`wrf/ops/*.py`), which run on every device.  It imports nothing of the
port, so a later change to the port cannot change what the port is held
to.  `runner` steps it in the run loop's order.

It is not independent of the port: outside the four kernels it is the
port's own code, and it shares every fault that code had when it was
copied.  What it decides is whether the port, changed later, still
computes what the port computed then, at the timed sizes, with the
kernels held to their plain versions.  The port's agreement with the JAX
package it was ported from is held by the repository's own tests, on the
CPU at small sizes, not here.
"""
