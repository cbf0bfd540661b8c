"""Sparse-LU ROS2 gas-chemistry integrator: generated CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``wrfchem_arc_interactions_tpu/ops/pallas_ros2.py::
integrate_pallas``.  For every cell it takes `n_sub` two-stage Rosenbrock
substeps of the mechanism: reaction rates, A = I - gamma dt J assembled on
the symbolic-LU pattern of `chem.gas._SparseKinetics`, the unrolled sparse LU
with diagonal pivots, two triangular solve pairs, clip at >= 0.

Design for Hopper.  The step is one straight-line program of a few thousand
dependent scalar operations per cell, and it wants about 700 values live:
the 469 of the LU, the 110 rate constants, the step-start concentrations,
the stage vectors.  A thread has at most 255 registers, so what bounds the
kernel on this card is neither its bytes nor its arithmetic but where the
values that do not fit in registers go, and how long a warp waits for them:
with every value a local, the compiler's schedule keeps ~640 of them on a
2.5 KB stack per thread, and at the 8 warps an SM can hold at 255 registers
each warp starts one instruction in ~19 cycles.  So the generator
(`generate_source`) decides where the long-lived values live and when the
others come to life:

- the rate constants and the concentrations, live across the whole call,
  and the values that `_walk_step` hands to `hold` (the pivot reciprocals
  and the entries of L: final once formed, read again only in the solves)
  are in shared memory, laid out ``[value][thread]`` (a warp reads
  consecutive banks), and are read where they are used (``K(j)``, ``C(i)``,
  ``S(n)`` in the statements).  Each thread touches only its own column, so
  the kernel needs no barrier.  The accesses are ``volatile``: otherwise the
  compiler forwards a stored value to its later reads, keeps it in a
  register after all and spills it (measured: the stack does not shrink);
- what the LU works on (the entries of U and the trailing matrix) stays in
  `float` locals;
- `_walk_step` orders independent statements to shorten live ranges: an
  entry of A is assembled where the LU first touches it, and the stage-1
  right-hand side is formed after the LU, just before the solve that
  consumes it.  It never reassociates;
- residency is chosen, not inherited: `THREADS` per block and
  `BLOCKS_PER_SM` resident blocks (``__launch_bounds__``, a persistent grid
  of that many blocks per SM with a grid-stride loop over the cells, and a
  shared-memory carveout to match).  Two blocks of 64 threads hold 447 rows
  of shared memory each (112 KB); the stack is ~500 bytes.

The source is generated from the mechanism's symbolic lists, so a mechanism
compiled from a ``.eqn`` file gets the same kind of kernel; it is written
into the package's ``build/`` directory, named by a hash of the lists and
the generator's version, and built by `ops.build` at first use.  gamma*dt
and dt are arguments, so one build serves every time step.  The loop over
the substeps is inside the kernel: conc and k are read once and conc
written once per call, (2 ns + nr) * 4 bytes per cell, which is the
kernel's bytes bound; (ns, ncell) row-major puts consecutive cells at
consecutive addresses, so the loads coalesce without a transpose, and a
bounds check replaces padding.

One walker (`_walk_step`) holds the operation order — dv, assembly, LU,
rates, solve, stage 2, clip — and runs on two backends: `_Emit`
writes the CUDA statements, `_Eager` executes them on (ncell,) tensors, so
the plain version follows any reordering by construction.
The kernel is built with ``--fmad=false`` and IEEE division, so it and the
plain version `integrate_reference` round at the same places.

`ros2_integrate` launches the kernel for CUDA tensors and runs
`integrate_reference` for CPU tensors; it never falls back from one to the
other.  ``ros2_integrate.launches`` counts kernel launches (one per call).
`integrate_reference` is ~8,000 tiny tensor operations per substep: it is
for tests and comparisons at a few thousand cells.  The production CPU path
is the vectorised `chem.gas._SparseKinetics.step_ros2`.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, List

import numpy as np
import torch

from wrfchem_arc_interactions_tpu_torch.ops import build

GENERATOR_VERSION = 3
# Residency, baked into the generated source
THREADS = 64             # threads per block
BLOCKS_PER_SM = 2        # resident blocks per SM (launch bound, grid, carveout)
SM_SHARED_BYTES = 233472     # an SM's shared memory, the base of the carveout's percentage
BLOCK_RESERVED_BYTES = 1024  # shared memory the system keeps per resident block
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
             + [ctypes.c_void_p])


def _symbolic_lists(kin) -> dict:
    """Plain-python copies of the symbolic structure (ints and floats only),
    item for item what the reference's kernel generator walks."""
    ns, nr = kin.ns, kin.nr
    scratch = int(kin.nnz)
    f_terms = [[] for _ in range(ns)]
    for tgt, rxn, coef in zip(kin.f_tgt, kin.f_rxn, kin.f_coef):
        f_terms[int(tgt)].append((int(rxn), float(coef)))
    jac_terms = [[] for _ in range(kin.njac)]
    for tgt, pair, coef in zip(kin.jc_tgt, kin.jc_pair, kin.jc_coef):
        jac_terms[int(tgt)].append((int(pair), float(coef)))
    stages = []
    for kk in range(ns):
        ik = [int(x) for x in kin.ikm[kk] if int(x) != scratch]
        kj = [int(x) for x in kin.kjm[kk] if int(x) != scratch]
        upd = [[int(kin.updm[kk][a * kin.maxr + b]) for b in range(len(kj))]
               for a in range(len(ik))]
        stages.append((int(kin.pkk[kk]), ik, kj, upd))
    fw_rows = [[] for _ in range(ns)]
    for li in range(kin.fw_ep.shape[0]):
        for ep, ec, er in zip(kin.fw_ep[li], kin.fw_ec[li], kin.fw_er[li]):
            if int(er) != ns:
                fw_rows[int(er)].append((int(ep), int(ec)))
    bw_rows = [[] for _ in range(ns)]
    for li in range(kin.bw_ep.shape[0]):
        for ep, ec, er in zip(kin.bw_ep[li], kin.bw_ec[li], kin.bw_er[li]):
            if int(er) != ns:
                bw_rows[int(er)].append((int(ep), int(ec)))
    return dict(
        ns=ns, nr=nr, nnz=int(kin.nnz),
        r1=[int(x) for x in kin.r1], r2=[int(x) for x in kin.r2],
        f_terms=f_terms,
        p_rxn=[int(x) for x in kin.p_rxn],
        p_oth=[int(x) for x in kin.p_oth],
        p_coef=[float(x) for x in kin.p_coef],
        jac_terms=jac_terms,
        jac_pos=[int(x) for x in kin.jac_pos],
        diag_pos=set(int(x) for x in kin.diag_pos),
        stages=stages, fw_rows=fw_rows, bw_rows=bw_rows,
        perm=[int(x) for x in kin.perm], iperm=[int(x) for x in kin.iperm],
    )


def _symbolic(kin) -> dict:
    """`_symbolic_lists(kin)`, computed once per kinetics object."""
    if getattr(kin, "_ros2_symbolic", None) is None:
        kin._ros2_symbolic = _symbolic_lists(kin)
    return kin._ros2_symbolic


class _Eager:
    """Backend of `_walk_step` that executes each operation: values are
    (ncell,) float32 tensors or Python floats holding float32 values (the
    literals 0 and 1 of untouched matrix positions and the coefficients;
    everything that reaches `max0` or the output has a tensor in it)."""

    @staticmethod
    def lit(x: float):
        return float(np.float32(x))

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b

    @staticmethod
    def recip(a):
        return 1.0 / a

    @staticmethod
    def max0(a):
        return torch.clamp(a, min=0.0)

    @staticmethod
    def hold(a):
        return a


class _Emit:
    """Backend of `_walk_step` that writes one CUDA statement per operation:
    values are the names of `float` locals, float literals or references to
    the thread's column of shared memory (``K(j)``, ``C(i)``, a held value's
    ``S(n)``).  Counts the floating-point operations whose operands are not
    all literals."""

    def __init__(self, first_row: int):
        self.lines: List[str] = []
        self.n = 0
        self.flops = 0
        self.first_row = first_row     # shared-memory rows of k and c come first
        self.held = 0                  # rows of held values after them

    @staticmethod
    def lit(x: float) -> str:
        return f"{float(np.float32(x)):.9e}f"       # 9 digits: exact float32

    def _new(self, expr: str, *operands: str) -> str:
        if not all(o.endswith("f") for o in operands):
            self.flops += 1
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"const float {name} = {expr};")
        return name

    def add(self, a, b):
        return self._new(f"{a} + {b}", a, b)

    def sub(self, a, b):
        return self._new(f"{a} - {b}", a, b)

    def mul(self, a, b):
        return self._new(f"{a} * {b}", a, b)

    def recip(self, a):
        return self._new(f"1.0f / {a}", a)

    def max0(self, a):
        return self._new(f"fmaxf({a}, 0.0f)", a)

    def hold(self, a):
        """Move value `a` to a row of shared memory of its own and return
        the reference that reads it back."""
        ref = f"S({self.first_row + self.held})"
        self.held += 1
        self.lines.append(f"{ref} = {a};")
        return ref


def _walk_step(sym: dict, B, c: list, kr: list, dt, gdt, ngdt, h15, h05) -> list:
    """One ROS2 substep, the operations of the reference's kernel generator
    with independent statements ordered to shorten live ranges, on backend
    `B`: c (ns values), kr (nr values) -> ns new values.  dt, gdt = gamma*dt,
    ngdt = -gdt, h15 = 1.5 dt, h05 = 0.5 dt."""
    ns, nr = sym["ns"], sym["nr"]

    def coef_times(coef, x):
        return x if coef == 1.0 else B.mul(B.lit(coef), x)

    def prod_rates(cc):
        v = []
        for j in range(nr):
            vj = kr[j]
            if sym["r1"][j] != ns:
                vj = B.mul(vj, cc[sym["r1"][j]])
            if sym["r2"][j] != ns:
                vj = B.mul(vj, cc[sym["r2"][j]])
            v.append(vj)
        f = []
        for i in range(ns):
            acc = None
            for (j, coef) in sym["f_terms"][i]:
                t = coef_times(coef, v[j])
                acc = t if acc is None else B.add(acc, t)
            f.append(acc if acc is not None else B.lit(0.0))
        return f

    # dv_j/dc_l pairs and the Jacobian entries they sum into
    dv = [None] * len(sym["p_rxn"])

    def pair(pid):
        if dv[pid] is None:
            d = coef_times(sym["p_coef"][pid], kr[sym["p_rxn"][pid]])
            if sym["p_oth"][pid] != ns:
                d = B.mul(d, c[sym["p_oth"][pid]])
            dv[pid] = d
        return dv[pid]

    # A = I - gamma dt J on the LU pattern (fill positions start at 0,
    # untouched diagonals at 1).  An entry is assembled where the LU first
    # touches it, not before: its live range starts there.
    entry_of = {p: e for e, p in enumerate(sym["jac_pos"])}
    vals = [None] * sym["nnz"]

    def assemble(p):
        if p not in entry_of:
            return B.lit(1.0 if p in sym["diag_pos"] else 0.0)
        acc = None
        for (pid, coef) in sym["jac_terms"][entry_of[p]]:
            t = coef_times(coef, pair(pid))
            acc = t if acc is None else B.add(acc, t)
        return B.sub(B.lit(1.0), B.mul(gdt, acc)) if p in sym["diag_pos"] \
            else B.mul(ngdt, acc)

    def touch(p):
        if vals[p] is None:
            vals[p] = assemble(p)
        return vals[p]

    # sparse LU with diagonal pivots (static unrolled fill schedule).  The
    # pivot reciprocals and the entries of L are final once formed and are
    # not read again before the solves: they are held (in shared memory).
    invd = [None] * ns
    for kk, (pkk, ik, kj, upd) in enumerate(sym["stages"]):
        idk = B.recip(touch(pkk))
        invd[kk] = B.hold(idk)
        for pkj in kj:                  # row kk of U is final here
            touch(pkj)
        for a, pik in enumerate(ik):
            lik = B.mul(touch(pik), idk)
            vals[pik] = B.hold(lik)
            for b, pkj in enumerate(kj):
                pu = upd[a][b]
                vals[pu] = B.sub(touch(pu), B.mul(lik, vals[pkj]))

    def solve(b):
        y = [None] * ns
        for q in range(ns):
            acc = b[sym["perm"][q]]
            for (ep, ec) in sym["fw_rows"][q]:
                acc = B.sub(acc, B.mul(vals[ep], y[ec]))
            y[q] = acc
        x = [None] * ns
        for q in range(ns - 1, -1, -1):
            acc = y[q]
            for (ep, ec) in sym["bw_rows"][q]:
                acc = B.sub(acc, B.mul(vals[ep], x[ec]))
            x[q] = B.mul(acc, invd[q])
        out = [None] * ns
        for q in range(ns):
            out[sym["perm"][q]] = x[q]
        return out

    # the stage-1 right-hand side is formed here, after the LU, so that it
    # is not live while the LU runs
    k1 = solve(prod_rates(c))
    c1 = [B.max0(B.add(c[i], B.mul(dt, k1[i]))) for i in range(ns)]
    f1 = prod_rates(c1)
    k2 = solve([B.sub(f1[i], B.mul(B.lit(2.0), k1[i])) for i in range(ns)])
    return [B.max0(B.add(B.add(c[i], B.mul(h15, k1[i])), B.mul(h05, k2[i])))
            for i in range(ns)]


def _step_scalars(dt_total: float, n_sub: int):
    """(dt, gamma*dt) of one substep as float32 values, as the kernel gets
    them; the kernel and the plain version derive -gamma*dt, 1.5 dt and
    0.5 dt from these in float32."""
    gamma = 1.0 + 1.0 / np.sqrt(2.0)
    dts = float(dt_total) / n_sub
    return np.float32(dts), np.float32(gamma * dts)


def integrate_reference(kin, conc: torch.Tensor, k: torch.Tensor, dt_total: float,
                        n_sub: int) -> torch.Tensor:
    """Plain version: the kernel's program walked operation by operation on
    (ncell,) tensors.  conc (ns, ncell), k (nr, ncell) float32."""
    sym = _symbolic(kin)
    dt, gdt = _step_scalars(dt_total, n_sub)
    ngdt, h15, h05 = -gdt, np.float32(1.5) * dt, np.float32(0.5) * dt
    c = list(conc.unbind(0))
    kr = list(k.unbind(0))
    for _ in range(n_sub):
        c = _walk_step(sym, _Eager, c, kr, float(dt), float(gdt), float(ngdt),
                       float(h15), float(h05))
    return torch.stack(c)


def generate_source(kin) -> Dict[str, object]:
    """The CUDA source of the kernel for `kin`'s mechanism: {"text",
    "flops_per_substep", "statements", "shared_bytes"} (`shared_bytes` per
    block).  Between the lines ``// substep: begin`` and ``// substep: end``
    the text holds one substep as statements ``const float tN = <expr>;`` and
    ``<shared reference> = <value>;``."""
    sym = _symbolic(kin)
    ns, nr = sym["ns"], sym["nr"]
    em = _Emit(first_row=nr + ns)
    new_c = _walk_step(sym, em, [f"C({i})" for i in range(ns)],
                       [f"K({j})" for j in range(nr)], "dt", "gdt", "ngdt", "h15", "h05")
    # the new concentrations are all formed before the first is stored
    em.lines.extend(f"C({i}) = {new_c[i]};" for i in range(ns))
    body = "\n".join("            " + ln for ln in em.lines)
    shared_bytes = 4 * THREADS * (nr + ns + em.held)
    carveout = min(100, -(-100 * BLOCKS_PER_SM * (shared_bytes + BLOCK_RESERVED_BYTES)
                          // SM_SHARED_BYTES))
    text = f"""// Generated by ops/ros2_kernel.py (generator version {GENERATOR_VERSION}); do not edit.
// n_sub two-stage Rosenbrock (ROS2) substeps of a {ns}-species, {nr}-reaction
// mechanism per cell on its symbolic sparse LU ({sym['nnz']} nonzeros);
// {em.flops} floating-point operations per substep.
// Replaces the TPU kernel ops/pallas_ros2.py::integrate_pallas.
// Bound by bytes when the substeps are few: (2 ns + nr) * 4 B per cell.  What
// costs time on the card is where the ~700 live values of a substep go that
// do not fit a thread's 255 registers.  The rate constants K(j), the
// concentrations C(i) and the {em.held} held values S(n) (pivot reciprocals,
// entries of L) live in shared memory, [value][thread], each thread in its
// own column (no barrier, consecutive banks), read through volatile accesses
// so that the compiler does not keep them in registers after all; the rest
// of the LU are float locals, each entry of A assembled at its first use.
// {THREADS} threads per block and {BLOCKS_PER_SM} resident blocks per SM (a persistent
// grid with a grid-stride loop over the cells, a shared-memory carveout of
// {carveout}% of the SM).
// conc (ns, ncell), k (nr, ncell), out (ns, ncell) are row-major float32, so
// neighbouring threads read neighbouring addresses.
#include <cuda_runtime.h>

#define THREADS {THREADS}
#define BLOCKS_PER_SM {BLOCKS_PER_SM}
#define NS {ns}
#define NR {nr}
#define SHARED_BYTES {shared_bytes}
#define K(j) ((volatile float*)sh)[(j) * THREADS + threadIdx.x]
#define C(i) ((volatile float*)sh)[(NR + (i)) * THREADS + threadIdx.x]
#define S(n) ((volatile float*)sh)[(n) * THREADS + threadIdx.x]

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ros2_kernel(const float* __restrict__ conc, const float* __restrict__ k,
            float* __restrict__ out, int ncell, int n_sub, float dt, float gdt)
{{
    extern __shared__ float sh[];
    const size_t n = (size_t)ncell;
    const float ngdt = -gdt;
    const float h15 = 1.5f * dt;
    const float h05 = 0.5f * dt;
#pragma unroll 1
    for (size_t base = (size_t)blockIdx.x * THREADS; base < n;
         base += (size_t)gridDim.x * THREADS) {{
        const size_t cell = base + threadIdx.x;
        if (cell >= n) continue;
#pragma unroll
        for (int j = 0; j < NR; ++j) K(j) = k[(size_t)j * n + cell];
#pragma unroll
        for (int i = 0; i < NS; ++i) C(i) = conc[(size_t)i * n + cell];
#pragma unroll 1
        for (int sub = 0; sub < n_sub; ++sub) {{
            // substep: begin
{body}
            // substep: end
        }}
#pragma unroll
        for (int i = 0; i < NS; ++i) out[(size_t)i * n + cell] = C(i);
    }}
}}

extern "C" int ros2_integrate(const float* conc, const float* k, float* out, int ncell,
                              int n_sub, float dt, float gdt, cudaStream_t stream)
{{
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ros2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SHARED_BYTES);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ros2_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, {carveout});
    if (err != cudaSuccess) return (int)err;
    int blocks = (ncell + THREADS - 1) / THREADS;
    if (blocks > BLOCKS_PER_SM * sms) blocks = BLOCKS_PER_SM * sms;
    ros2_kernel<<<blocks, THREADS, SHARED_BYTES, stream>>>(conc, k, out, ncell, n_sub, dt, gdt);
    return (int)cudaGetLastError();
}}
"""
    return {"text": text, "flops_per_substep": em.flops, "statements": len(em.lines),
            "shared_bytes": shared_bytes}


def register(kin) -> str:
    """Generate the kernel source for `kin`'s mechanism, hand it to
    `ops.build` and return the kernel's name there (``ros2_<hash>``: a hash
    of the symbolic lists, the generator's version and its residency
    constants).  Idempotent."""
    name = getattr(kin, "_ros2_kernel_name", None)
    if name is None:
        sym = _symbolic(kin)
        canon = repr(sorted((k, sorted(v) if isinstance(v, set) else v)
                            for k, v in sym.items()))
        digest = hashlib.sha1(f"{GENERATOR_VERSION}|{THREADS}|{BLOCKS_PER_SM}|"
                              f"{canon}".encode()).hexdigest()[:12]
        name = f"ros2_{digest}"
        src = generate_source(kin)
        build.register_generated(name, src["text"])
        kin._ros2_kernel_name = name
        kin._ros2_flops = src["flops_per_substep"]
    return name


def flops_per_substep(kin) -> int:
    """Floating-point operations of one substep of one cell, as generated."""
    if getattr(kin, "_ros2_flops", None) is None:
        kin._ros2_flops = generate_source(kin)["flops_per_substep"]
    return kin._ros2_flops


def _check(kin, conc, k, n_sub):
    for name, t, rows in (("conc", conc, kin.ns), ("k", k, kin.nr)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} must be ({rows}, ncell), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.device != conc.device:
        raise ValueError(f"k is on {k.device}, conc on {conc.device}")
    if k.shape[1] != conc.shape[1]:
        raise ValueError(f"conc has {conc.shape[1]} cells, k {k.shape[1]}")
    if conc.shape[1] < 1 or conc.shape[1] >= 2 ** 31:
        raise ValueError(f"unsupported cell count {conc.shape[1]}")
    if int(n_sub) < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")


def ros2_integrate(kin, conc: torch.Tensor, k: torch.Tensor, dt_total: float,
                   n_sub: int) -> torch.Tensor:
    """`n_sub` ROS2 substeps of `kin`'s mechanism over dt_total: conc
    (ns, ncell) [molec/cm3] and k (nr, ncell), float32 and contiguous ->
    (ns, ncell).  One kernel launch per call on a CUDA tensor; the plain
    version on a CPU tensor."""
    _check(kin, conc, k, n_sub)
    if conc.device.type == "cpu":
        return integrate_reference(kin, conc, k, dt_total, n_sub)
    if conc.device.type != "cuda":
        raise ValueError(f"unsupported device {conc.device}")
    fn = build.load(register(kin)).ros2_integrate
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    dt, gdt = _step_scalars(dt_total, n_sub)
    out = torch.empty_like(conc)
    with torch.cuda.device(conc.device):
        stream = torch.cuda.current_stream(conc.device).cuda_stream
        err = fn(conc.data_ptr(), k.data_ptr(), out.data_ptr(), conc.shape[1],
                 int(n_sub), float(dt), float(gdt), stream)
    if err != 0:
        raise RuntimeError(f"ros2_integrate launch failed: cudaError {err}")
    ros2_integrate.launches += 1
    return out


ros2_integrate.launches = 0
