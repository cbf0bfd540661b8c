"""The port's gas-phase chemistry against the JAX package on identical
seeded inputs (both on the CPU).

- species, reactions, stoichiometry tables, every index table of
  `_SparseKinetics` and the kernel generator's symbolic lists: exact;
- `rate_constants`: 1e-5 relative;
- `integrate` (the vectorised CPU path) against the reference's XLA path,
  and `ops.ros2_kernel.integrate_reference` (the kernel's plain version:
  the generated program walked on tensors) against both, at
  max |a - b| / (|b| + 1e3) < 5e-3 [molec/cm3] — the bound the JAX package
  holds its own kernel to; the measured values (1e-6 on a mild start, up
  to 2e-3 on this one, which spans 215-305 K and day and night: float32
  sums taken in another order on a stiff system) are printed;
- `integrate_adaptive` against the reference at the same bound;
- the generated CUDA source: its shape, its version and shared-memory size,
  and that it is a pure function of the mechanism; its statements, executed
  one by one by a small evaluator (numpy float32, shared memory as rows that
  must be written before they are read), bitwise equal to
  `integrate_reference` — without a CUDA compiler the only guard on where
  the generator stores each value and in which order it forms them;
- a mechanism compiled from ``mechanisms/cbmz.eqn`` takes the same kernel;
  a small user mechanism gets its own;
- on a CUDA card, the kernel against its plain version (skipped without
  one).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one thread per process (the suite runs several workers, and
# intra-op threads of many tiny operations only contend for the cores)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from wrfchem_arc_interactions_tpu.chem import gas as jgas  # noqa: E402
from wrfchem_arc_interactions_tpu.ops import pallas_ros2  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import gas as tgas  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.chem import mechanism as tmech  # noqa: E402
from wrfchem_arc_interactions_tpu_torch.ops import build, ros2_kernel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e3)))


def _relk(a, b):
    """Worst relative difference of two rate-constant tables (0 = 0 at night)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def polluted_start(ncell, seed, night_fraction=0.3):
    """Polluted-air concentrations [molec/cm3] x U(0.5, 2) per cell and
    species, temperatures over the troposphere's range and J scales from
    night to overhead sun: (conc (NS, ncell), k (NR, ncell)) float32."""
    rng = np.random.default_rng(seed)
    t_air = rng.uniform(215.0, 305.0, ncell).astype(np.float32)
    m_air = (rng.uniform(0.3, 1.0, ncell) * 2.5e19).astype(np.float32)
    ppm = {"o3": 0.04, "no2": 2e-3, "no": 1e-3, "co": 0.12, "so2": 2e-3, "h2o2": 1e-3,
           "ch4": 1.7, "hcho": 1e-3, "par": 5e-3, "isop": 1e-3, "tol": 1e-4,
           "eth": 1e-3, "ald2": 5e-4, "hno3": 1e-3, "nh3": 1e-3, "dms": 1e-4,
           "oh": 1e-7, "ho2": 1e-5}
    conc = np.zeros((tgas.NS, ncell), np.float32)
    for s, v in ppm.items():
        conc[tgas.IDX[s]] = v * 1e-6 * m_air * rng.uniform(0.5, 2.0, ncell)
    js = rng.uniform(0.0, 1.0, ncell) * (rng.uniform(size=ncell) > night_fraction)
    k = np.asarray(jgas.rate_constants(jnp.asarray(t_air), jnp.asarray(m_air),
                                       jnp.asarray(js.astype(np.float32))))
    return conc, k.astype(np.float32), t_air, m_air, js.astype(np.float32)


def test_mechanism_tables_exact():
    assert jgas.GAS_SPECIES == tgas.GAS_SPECIES and jgas.NS == tgas.NS == 55
    assert jgas.REACTIONS == tgas.REACTIONS and tgas.NR_RXN == 110
    assert jgas.J_CLEAR == tgas.J_CLEAR and jgas.PHOT_NAMES == tgas.PHOT_NAMES
    np.testing.assert_array_equal(jgas._ORDER, tgas._ORDER)
    np.testing.assert_array_equal(jgas._NET, tgas._NET)
    assert jgas._RKIND == tgas._RKIND and jgas._RPARAMS == tgas._RPARAMS
    assert jgas.SUBSTEP_TARGET_S == tgas.SUBSTEP_TARGET_S


def test_sparse_kinetics_and_symbolic_lists_exact():
    jk, tk = jgas._kinetics(), tgas._kinetics()
    for name in ("ns", "nr", "nnz", "njac", "n_fill_ops", "maxb", "maxr", "rx"):
        assert getattr(jk, name) == getattr(tk, name), name
    for name in ("r1", "r2", "f_tgt", "f_rxn", "f_coef", "p_rxn", "p_oth", "p_coef",
                 "jc_tgt", "jc_pair", "jc_coef", "perm", "iperm", "diag_pos", "jac_pos",
                 "pkk", "ikm", "kjm", "updm", "fw_ep", "fw_ec", "fw_er", "bw_ep",
                 "bw_ec", "bw_er"):
        a, b = getattr(jk, name), getattr(tk, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    js, ts = pallas_ros2._symbolic_lists(jk), ros2_kernel._symbolic_lists(tk)
    assert list(js) == list(ts)
    for key in js:
        assert js[key] == ts[key], key
    assert tgas._kinetics() is tk                      # content-keyed cache


def test_rate_constants():
    _, kj, t_air, m_air, js = polluted_start(64, 0)
    kt = tgas.rate_constants(_t(t_air), _t(m_air), _t(js)).numpy()
    assert kt.shape == (110, 64)
    assert _relk(kt, kj) <= 1e-5
    # the dict form (per-reaction spectral scales)
    scales = {n: js * (1.0 + 0.1 * i) for i, n in enumerate(tgas.PHOT_NAMES)}
    kj2 = np.asarray(jgas.rate_constants(jnp.asarray(t_air), jnp.asarray(m_air),
                                         {n: jnp.asarray(v) for n, v in scales.items()}))
    kt2 = tgas.rate_constants(_t(t_air), _t(m_air), {n: _t(v) for n, v in scales.items()})
    assert _relk(kt2.numpy(), kj2) <= 1e-5


@pytest.mark.parametrize("n_sub", [1, 2])
def test_integrate_matches_jax(n_sub):
    conc, k, *_ = polluted_start(256, 1)
    ref = np.asarray(jgas.integrate(jnp.asarray(conc), jnp.asarray(k), 60.0, n_sub=n_sub,
                                    backend="xla"))
    vec = tgas.integrate(_t(conc), _t(k), 60.0, n_sub=n_sub).numpy()
    plain = ros2_kernel.integrate_reference(tgas._kinetics(), _t(conc), _t(k), 60.0,
                                            n_sub).numpy()
    wrapped = ros2_kernel.ros2_integrate(tgas._kinetics(), _t(conc), _t(k), 60.0,
                                         n_sub).numpy()
    errs = {"vectorised vs reference": _err(vec, ref), "plain vs reference": _err(plain, ref),
            "plain vs vectorised": _err(plain, vec)}
    print(f"n_sub={n_sub}:", errs)
    assert np.isfinite(vec).all() and (vec >= 0).all() and (plain >= 0).all()
    assert float(np.abs(ref - conc).max()) > 1e6          # the step does something
    assert max(errs.values()) < BOUND
    np.testing.assert_array_equal(wrapped, plain)          # CPU tensors: the plain version
    assert ros2_kernel.ros2_integrate.launches == 0


def test_integrate_default_substeps_and_chunks(monkeypatch):
    conc, k, *_ = polluted_start(200, 2)
    ref = np.asarray(jgas.integrate(jnp.asarray(conc), jnp.asarray(k), 60.0, backend="xla"))
    whole = tgas.integrate(_t(conc), _t(k), 60.0).numpy()          # n_sub = 2
    monkeypatch.setattr(tgas, "CELL_CHUNK", 64)
    chunked = tgas.integrate(_t(conc), _t(k), 60.0).numpy()
    assert _err(whole, ref) < BOUND
    np.testing.assert_array_equal(whole, chunked)


def test_integrate_adaptive_matches_jax():
    conc, k, *_ = polluted_start(48, 3)
    jout, jst = jgas.integrate_adaptive(jnp.asarray(conc), jnp.asarray(k), 120.0,
                                        return_stats=True)
    tout, tst = tgas.integrate_adaptive(_t(conc), _t(k), 120.0, return_stats=True)
    assert tst["all_finished"] and bool(jst["all_finished"])
    assert abs(tst["iterations"] - int(jst["iterations"])) <= 1
    assert _err(tout.numpy(), np.asarray(jout)) < BOUND


def test_wrapper_checks_inputs():
    kin = tgas._kinetics()
    conc, k, *_ = polluted_start(8, 4)
    with pytest.raises(TypeError):
        ros2_kernel.ros2_integrate(kin, _t(conc).double(), _t(k), 60.0, 2)
    with pytest.raises(ValueError):
        ros2_kernel.ros2_integrate(kin, _t(conc)[:, :4], _t(k), 60.0, 2)
    with pytest.raises(ValueError):
        ros2_kernel.ros2_integrate(kin, _t(conc).t().contiguous().t(), _t(k), 60.0, 2)
    with pytest.raises(ValueError):
        ros2_kernel.ros2_integrate(kin, _t(conc), _t(k), 60.0, 0)


def test_generated_source():
    kin = tgas._kinetics()
    a, b = ros2_kernel.generate_source(kin), ros2_kernel.generate_source(kin)
    assert a["text"] == b["text"]                          # a pure function of the tables
    text = a["text"]
    assert 'extern "C" int ros2_integrate(' in text
    assert "__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)\nros2_kernel(" in text
    assert ros2_kernel.GENERATOR_VERSION == 3 and "(generator version 3)" in text
    # k, c, the pivot reciprocals and the entries of L, one row of THREADS floats each
    n_l = sum(len(ik) for _, ik, _, _ in ros2_kernel._symbolic(kin)["stages"])
    assert a["shared_bytes"] == 4 * ros2_kernel.THREADS * (kin.nr + 2 * kin.ns + n_l) == 114432
    assert f"#define SHARED_BYTES {a['shared_bytes']}\n" in text
    assert f"#define THREADS {ros2_kernel.THREADS}\n" in text
    assert f"#define BLOCKS_PER_SM {ros2_kernel.BLOCKS_PER_SM}\n" in text
    # the resident blocks' shared memory fits an SM
    assert ros2_kernel.BLOCKS_PER_SM * (a["shared_bytes"] + ros2_kernel.BLOCK_RESERVED_BYTES) \
        <= ros2_kernel.SM_SHARED_BYTES
    assert text.count("volatile") >= 3 and "cudaFuncAttributePreferredSharedMemoryCarveout" in text
    assert text.count("1.0f / ") == kin.ns                  # one pivot reciprocal per species
    assert text.count("fmaxf(") == 2 * kin.ns
    assert "for (int sub = 0; sub < n_sub; ++sub)" in text
    assert a["flops_per_substep"] == ros2_kernel.flops_per_substep(kin)
    assert 6000 < a["flops_per_substep"] < 9000
    assert "jax" not in text and "torch" not in text
    name = ros2_kernel.register(kin)
    assert name.startswith("ros2_") and name == ros2_kernel.register(kin)
    src = build._source(name)
    assert os.path.dirname(src) == build.BUILD_DIR and open(src).read() == text
    assert name in build.lib_path(name)


_OPERAND = r"(t\d+|[KCS]\(\d+\)|-?\d\.\d+e[+-]\d+f|dt|gdt|ngdt|h15|h05)"
_STATEMENTS = (
    ("bin", re.compile(rf"const float (t\d+) = {_OPERAND} ([-+*]) {_OPERAND};")),
    ("recip", re.compile(rf"const float (t\d+) = 1\.0f / {_OPERAND};")),
    ("max0", re.compile(rf"const float (t\d+) = fmaxf\({_OPERAND}, 0\.0f\);")),
    ("store", re.compile(rf"([KCS]\(\d+\)) = {_OPERAND};")),
)


def _execute_generated(src, kin, conc, k, dt_total, n_sub):
    """Run the statements between the generated source's substep markers on
    numpy float32 arrays, as the kernel's thread would: K(j), C(i), S(n)
    are rows of the block's shared memory (k first, then c, then the held
    values), a row is read only after it was written, and a local is
    declared once per substep."""
    body = src["text"].split("// substep: begin")[1].split("// substep: end")[0]
    lines = [ln.strip() for ln in body.strip().splitlines()]
    assert len(lines) == src["statements"]
    n_rows = src["shared_bytes"] // (4 * ros2_kernel.THREADS)
    first = {"K": 0, "C": kin.nr, "S": 0}
    limit = {"K": (0, kin.nr), "C": (kin.nr, kin.nr + kin.ns), "S": (kin.nr + kin.ns, n_rows)}
    shared = {}

    def row(ref):
        r = first[ref[0]] + int(ref[2:-1])
        assert limit[ref[0]][0] <= r < limit[ref[0]][1], ref
        return r

    for j in range(kin.nr):
        shared[row(f"K({j})")] = k[j]
    for i in range(kin.ns):
        shared[row(f"C({i})")] = conc[i]
    dt, gdt = ros2_kernel._step_scalars(dt_total, n_sub)
    scalars = {"dt": dt, "gdt": gdt, "ngdt": -gdt, "h15": np.float32(1.5) * dt,
               "h05": np.float32(0.5) * dt}
    ops = {"+": np.add, "-": np.subtract, "*": np.multiply}
    for _ in range(n_sub):
        local = {}

        def value(tok):
            if tok in scalars:
                return scalars[tok]
            if tok[0] == "t":
                return local[tok]
            if tok[0] in "KCS":
                return shared[row(tok)]           # KeyError: read before written
            return np.float32(tok[:-1])

        for ln in lines:
            for kind, pat in _STATEMENTS:
                m = pat.fullmatch(ln)
                if m:
                    break
            else:
                raise AssertionError(f"statement not understood: {ln}")
            g = m.groups()
            if kind == "store":
                shared[row(g[0])] = value(g[1])
                continue
            assert g[0] not in local, g[0]
            if kind == "bin":
                out = ops[g[2]](value(g[1]), value(g[3]))
            elif kind == "recip":
                out = np.float32(1.0) / value(g[1])
            else:
                out = np.maximum(value(g[1]), np.float32(0.0))
            assert np.asarray(out).dtype == np.float32, ln
            local[g[0]] = out
    return np.stack([np.broadcast_to(shared[row(f"C({i})")], conc[i].shape)
                     for i in range(kin.ns)])


@pytest.mark.parametrize("n_sub", [1, 2])
def test_generated_statements_execute_to_the_plain_version(n_sub):
    kin = tgas._kinetics()
    conc, k, *_ = polluted_start(7, 6)
    src = ros2_kernel.generate_source(kin)
    out = _execute_generated(src, kin, conc, k, 60.0, n_sub)
    ref = ros2_kernel.integrate_reference(kin, _t(conc), _t(k), 60.0, n_sub).numpy()
    assert float(np.abs(ref - conc).max()) > 1e6          # the step does something
    np.testing.assert_array_equal(out, ref)                # bitwise: the same operations
    # the held values take rows of their own after k and c, each written once per substep
    stores = re.findall(r"^\s*S\((\d+)\) = ", src["text"], flags=re.M)
    assert len(stores) == len(set(stores)) == src["shared_bytes"] // (4 * ros2_kernel.THREADS) \
        - kin.nr - kin.ns
    assert min(map(int, stores)) == kin.nr + kin.ns


def _have_mechc():
    try:
        tmech.build_mechc()
        return True
    except Exception:
        return False


def test_compiled_mechanisms_take_the_generated_path(tmp_path):
    if not _have_mechc():
        pytest.skip("no C++ toolchain for mechc")
    mech = tmech.compile_eqn(os.path.join(REPO, "mechanisms", "cbmz.eqn"))
    species, order, net, rkind, rparams = tmech.tables_from(mech)
    assert species == tgas.GAS_SPECIES
    np.testing.assert_array_equal(order, tgas._ORDER)
    np.testing.assert_array_equal(net, tgas._NET)
    builtin = ros2_kernel.register(tgas._kinetics())
    with tmech.use_tables(order, net, rkind, rparams):
        assert ros2_kernel.register(tgas._kinetics()) == builtin
    # a small user mechanism: its own kinetics, its own kernel, and the
    # photostationary state k1 [NO2] ~ J [NO] [O3] after 600 s
    p = tmp_path / "tiny.eqn"
    p.write_text("#SPECIES o3 no no2\n"
                 "no2 = no + o3 : PHOT(no2, 1.0) ;\n"
                 "no + o3 = no2 : ARR(3.0e-12, 0.0, 1500.0) ;\n")
    species, order, net, rkind, rparams = tmech.tables_from(tmech.compile_eqn(str(p)))
    with tmech.use_tables(order, net, rkind, rparams):
        kin = tgas._kinetics()
        assert (kin.ns, kin.nr) == (3, 2)
        assert ros2_kernel.register(kin) != builtin
        k = tgas.rate_constants(torch.full((1,), 298.0), torch.ones(1), torch.ones(1))
        conc0 = torch.tensor([[9e11], [2.5e11], [2.5e11]])
        vec = tgas.integrate(conc0, k, 600.0)
        plain = ros2_kernel.ros2_integrate(kin, conc0, k.contiguous(), 600.0, 20)
    assert tgas.NS == 55 and tgas._kinetics().ns == 55      # restored
    o3, no, no2 = (float(x) for x in vec[:, 0])
    lhs, rhs = float(k[0, 0]) * no2, float(k[1, 0]) * no * o3
    assert abs(lhs - rhs) / rhs < 0.05
    assert abs(no + no2 - 5e11) <= 1e-3 * 5e11
    assert _err(plain.numpy(), vec.numpy()) < BOUND


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ROS2 CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    kin = tgas._kinetics()
    before = ros2_kernel.ros2_integrate.launches
    # a short grid with a ragged last block, then the 100x100x50 grid's cell count
    for ncell, n_sub in ((4096 + 37, 1), (4096 + 37, 2), (500_000, 2)):
        conc, k, *_ = polluted_start(ncell, 5)
        conc, k = _t(conc).to(dev), _t(k).to(dev)
        out = ros2_kernel.ros2_integrate(kin, conc, k, 60.0, n_sub)
        ref = ros2_kernel.integrate_reference(kin, conc, k, 60.0, n_sub)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        assert float(((out - ref).abs() / (ref.abs() + 1e3)).max()) <= 1e-5
    assert ros2_kernel.ros2_integrate.launches == before + 3
    conc, k = conc[:, :4096 + 37].contiguous(), k[:, :4096 + 37].contiguous()
    # gas.integrate on a CUDA tensor goes through the kernel
    out = tgas.integrate(conc, k, 60.0)
    assert ros2_kernel.ros2_integrate.launches == before + 4
    assert _err(out.cpu().numpy(), tgas.integrate(conc.cpu(), k.cpu(), 60.0).numpy()) < BOUND
