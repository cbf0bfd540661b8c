"""A kernel's share of its roofline in the traced periods: the sum of the
counted least times of its calls (`counts.kernel_bounds`) over the sum of
the device time of its launches, found in the trace by the kernel's name."""

from __future__ import annotations

import re

from port_bench import counts

# the port's kernels by their CUDA names
KERNEL_NAMES = {
    "advect_scalar_5_3": r"\badvect_scalar_5_3_kernel\b",
    "advect_tracers": r"\b(stage_kernel|limited_kernel)\b",
    "mie_cheb_eval": r"\bmie_cheb_eval_kernel\b",
    "ros2_integrate": r"\bros2_kernel\b",
    "diffuse_scalars": r"\bdiffuse_scalars_kernel\b",
}


def share(records: dict, kernel: str):
    """Percent, or None where the kernel has no launch or no call."""
    t = records.get("trace")
    if not t:
        return None
    pat = re.compile(KERNEL_NAMES[kernel])
    seconds = sum(s for name, (_, s) in t["kernels"].items() if pat.search(name))
    n_sub = counts.ros2_n_sub(records["chemdt_s"]) if records["gas_chem"] else 0
    bound = counts.kernel_bounds(records["shape"], records["scalars"], records["bins"],
                                 n_sub, t["steps"], t["chem_calls"],
                                 vdiff=records.get("kvdif", 0.0) > 0.0).get(kernel, 0.0)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
