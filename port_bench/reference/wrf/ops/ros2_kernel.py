"""Plain version of the port's sparse-LU ROS2 gas solver (the port's
`ops/ros2_kernel.py`, frozen): the kernel's program walked operation by
operation on tensors (`integrate_reference`), in pieces of `CELL_PIECE`
cells; the CUDA generator is left out.
"""

from __future__ import annotations


import numpy as np
import torch


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


CELL_PIECE = 1 << 21     # cells per plain pass


def ros2_integrate(kin, conc: torch.Tensor, k: torch.Tensor, dt_total: float,
                   n_sub: int) -> torch.Tensor:
    """`n_sub` ROS2 substeps over dt_total, by the plain version."""
    out = torch.empty_like(conc)
    for a in range(0, conc.shape[1], CELL_PIECE):
        b = a + CELL_PIECE
        out[:, a:b] = integrate_reference(kin, conc[:, a:b].contiguous(),
                                          k[:, a:b].contiguous(), dt_total, n_sub)
    return out
