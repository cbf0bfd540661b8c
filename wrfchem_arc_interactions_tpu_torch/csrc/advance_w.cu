// One acoustic substep's vertically implicit W''-phi'' update (WRF's
// advance_w), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's implicit solve is plain `jnp`
// with a `lax.scan` Thomas solve (`wrfchem_arc_interactions_tpu/dycore/
// small_step.py`).  It was added because the port's plain version, about
// 60 whole-array operators to build the tridiagonal rows and a Python loop
// over the levels in `dycore/tridiag.py::thomas` (~9 launches a level, each
// on one 1-MB plane), issued 672 launches a substep at config 5's
// 500x500x60 block: launches the host could not issue as fast as the card
// ran them, so the card idled in them.  It computes, for each column, what
// `ops/advance_w_kernel.py::advance_w_reference` computes:
//
//   phi_exp[k] = ph[k] + dtau*((rph[k] - (om[k]*dphdn[k])*imu) + (gwm*bm)*w[k]),  k >= 1
//   phi_exp[0] = ph[0]                                     (the surface is frozen)
//   p_exp[k]   = coef_pt[k]*th[k] + s[k]*(phi_exp[k+1] - phi_exp[k])   (mass levels)
//   row k >= 1 of the tridiagonal system A w[k-1] + B w[k] + C w[k+1] = D:
//     K = (((dtau_g*eps_w[k])*bp)*rdn_w[k])*aw,   aw = dtau_g_bp*imu
//     A = -K*s[k-1],  C = -K*s[k] (0 above the lid),
//     B = (1 + K*(s[k] + s[k-1])) + dtau*w_damp[k]
//     D = w[k] + dtau*((rw[k] + (gi*eps_w[k])*(bp*dpdn_exp + bm*dpdn_old)) - gi*mu)
//     dpdn_x = rdn_w[k]*(p_x[k] - p_x[k-1]), p'' = 0 below the surface and above the lid
//   row 0: A = C = 0, B = 1, D = wsfc (the kinematic surface w over terrain) or 0
//   w_new  = the Thomas solve of those rows;  phi_new[k] = phi_exp[k] + awm*w_new[k],
//   phi_new[0] = phi_exp[0]
//
// with imu = 1/mu_full, gwm = G*imu (G*m*imu on a projected grid), gi = G
// (G/m), awm = aw (aw*m).  Shapes (float32, contiguous): w, ph, rw, rph, om,
// dphdn, eps_w (nz+1, ny, nx); w_damp the same or one value; th, coef_pt,
// s, p_now (nz, ny, nx); rdn_w (nz+1); mu, inv_mu and, where present,
// msft, inv_msft, wsfc (ny, nx).  The update is column-local: no halo and
// no neighbour, so a block of a process mesh is just a smaller domain.
//
// Bound: memory.  Seven w-level arrays and w_damp, four mass-level arrays
// and the 2-D rows read once, w and phi written once: about 14 arrays of a
// block's 61 x 500 x 500 floats, 0.85 GB a substep (0.25 ms at 3.35 TB/s),
// against ~45 float operations and one division a cell (~0.02 ms at
// 67 TFLOP/s).
//
// Design: one thread owns one column, so the solve is the plain version's
// sequential sweep, with no barrier and no exchange between threads.
//
// - Columns are numbered j*nx + i, a block of one warp takes 32
//   consecutive ones: every level's loads of a warp are one coalesced
//   128-byte line an array, also across a row's end.  The last block is
//   ragged; its idle lanes return at once.
// - Going up, step k reads level k + 1's phi inputs and level k's mass and
//   row inputs (`fetch`), forms phi_exp[k+1] and p_exp[k], then row k, and
//   takes the Thomas forward step.  The next step's loads are issued before
//   this step's arithmetic, so a level's memory latency overlaps the
//   previous level's division chain.
// - c', d' and phi_exp of every level stay on chip for the way down, in
//   dynamic shared memory laid out [slot][level][lane], so that a warp's
//   accesses fall in 32 distinct banks: 3 x (nz+1) x 4 bytes a thread, 23.4
//   KB a block at 61 levels, 9 blocks (288 threads) an SM.  Kept in device
//   memory instead, phi_exp alone would be written and read back after a
//   column's whole upward sweep, by when the streamed inputs of the other
//   columns in flight (~170 MB) have pushed it out of the 50-MB L2.
// - Coming down, each level writes w and phi once.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W, config 5's block, 61 x 500 x
// 500, inputs of the path's magnitudes): 0.431 ms a launch, 59.1% of the
// 0.254-ms bound; 58 registers, no spills, 9 blocks an SM; the plain
// version 3.49 ms of device time and 8.9 ms of host wall a substep.  Tried
// and dropped (one-off probes, not kept): blocks of 64 and 128 threads (4
// and 2 blocks an SM: 0.466 ms), phi_exp through the output array, two
// slots in shared memory and 14 blocks an SM (0.505 ms), and no prefetch
// (0.452 ms).
//
// Arithmetic: every value is formed in the plain version's order, each
// Python scalar rounded to float32 where PyTorch rounds it, and the library
// is built with --fmad=false, so that no multiply-add is contracted; the
// division is IEEE (nvcc's default -prec-div=true), as PyTorch's
// reciprocal.  The kernel is bitwise its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;           // one warp a block
constexpr int SLOTS = 3;              // c', d' and phi_exp of each level
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block may have (227 KB)
constexpr size_t DEFAULT_SMEM = 49152;

struct Args {
  const float* w;        // (nz+1, ny, nx)
  const float* ph;
  const float* rw;
  const float* rph;
  const float* om;
  const float* dphdn;
  const float* eps_w;
  const float* w_damp;   // (nz+1, ny, nx), or one value when wd_full is 0
  const float* th;       // (nz, ny, nx)
  const float* coef_pt;
  const float* s;
  const float* p_now;
  const float* rdn_w;    // (nz+1)
  const float* mu;       // (ny, nx)
  const float* inv_mu;
  const float* msft;     // (ny, nx) on a projected grid, else null
  const float* inv_msft;
  const float* wsfc;     // (ny, nx) over terrain, else null
  float* w_out;          // (nz+1, ny, nx)
  float* ph_out;
  int nz, ncol, wd_full;
  float dtau, dtau_g, dtau_g_bp, bp, bm, g;
};

// What step k of the upward sweep reads from device memory.
struct Level {
  float ph, rph, om, dph, w;   // w level k + 1 (k < nz)
  float th, cpt, s, pn;        // mass level k (k < nz)
  float rw, ew, wd;            // w level k (k >= 1)
};

__device__ __forceinline__ void fetch(Level& L, const Args& a, int k, size_t c) {
  const size_t plane = (size_t)a.ncol;
  if (k < a.nz) {
    const size_t up = (size_t)(k + 1) * plane + c, m = (size_t)k * plane + c;
    L.ph = __ldg(a.ph + up);
    L.rph = __ldg(a.rph + up);
    L.om = __ldg(a.om + up);
    L.dph = __ldg(a.dphdn + up);
    L.w = __ldg(a.w + up);
    L.th = __ldg(a.th + m);
    L.cpt = __ldg(a.coef_pt + m);
    L.s = __ldg(a.s + m);
    L.pn = __ldg(a.p_now + m);
  }
  if (k >= 1) {
    const size_t at = (size_t)k * plane + c;
    L.rw = __ldg(a.rw + at);
    L.ew = __ldg(a.eps_w + at);
    L.wd = __ldg(a.w_damp + (a.wd_full ? at : 0));
  }
}

__global__ void __launch_bounds__(THREADS) advance_w_kernel(Args a) {
  extern __shared__ float smem[];
  const size_t c = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= (size_t)a.ncol) return;        // no barrier follows
  const int nz = a.nz;
  const size_t plane = (size_t)a.ncol;
  float* const cps = smem + threadIdx.x;  // level k at cps[k * THREADS]
  float* const dps = cps + (size_t)(nz + 1) * THREADS;
  float* const phe = dps + (size_t)(nz + 1) * THREADS;

  const float imu = __ldg(a.inv_mu + c), mu = __ldg(a.mu + c);
  const float aw = a.dtau_g_bp * imu;
  const float gwm = a.msft ? (a.g * __ldg(a.msft + c)) * imu : a.g * imu;
  const float gwm_bm = gwm * a.bm;
  const float gi = a.inv_msft ? a.g * __ldg(a.inv_msft + c) : a.g;
  const float awm = a.msft ? aw * __ldg(a.msft + c) : aw;

  float phe_k = __ldg(a.ph + c);          // phi_exp at the surface: phi'' frozen
  phe[0] = phe_k;
  float w_k = 0.0f;                       // w at level k (row 0 reads none)
  float pe_dn = 0.0f, pn_dn = 0.0f, s_dn = 0.0f;   // p_exp, p_now, s of the mass level below
  float cp = 0.0f, dp = 0.0f;
  Level cur{}, nxt{};
  fetch(cur, a, 0, c);
  for (int k = 0; k <= nz; ++k) {
    if (k < nz) fetch(nxt, a, k + 1, c);
    float pe_up = 0.0f, pn_up = 0.0f, s_up = 0.0f, phe_up = 0.0f;
    if (k < nz) {
      phe_up = cur.ph + a.dtau * ((cur.rph - (cur.om * cur.dph) * imu) + gwm_bm * cur.w);
      phe[(size_t)(k + 1) * THREADS] = phe_up;
      pe_up = cur.cpt * cur.th + cur.s * (phe_up - phe_k);
      pn_up = cur.pn;
      s_up = cur.s;
    }
    float A, B, C, D;
    if (k == 0) {
      A = 0.0f;
      C = 0.0f;
      B = 1.0f;
      D = a.wsfc ? __ldg(a.wsfc + c) : 0.0f;
    } else {
      const float rdn = __ldg(a.rdn_w + k);
      const float dpe = rdn * (pe_up - pe_dn);
      const float dpo = rdn * (pn_up - pn_dn);
      const float K = (((a.dtau_g * cur.ew) * a.bp) * rdn) * aw;
      A = -K * s_dn;
      C = -K * s_up;
      B = (1.0f + K * (s_up + s_dn)) + a.dtau * cur.wd;
      D = w_k + a.dtau * ((cur.rw + (gi * cur.ew) * (a.bp * dpe + a.bm * dpo)) - gi * mu);
    }
    const float inv = 1.0f / (B - A * cp);
    cp = C * inv;
    dp = (D - A * dp) * inv;
    cps[(size_t)k * THREADS] = cp;
    dps[(size_t)k * THREADS] = dp;
    pe_dn = pe_up;
    pn_dn = pn_up;
    s_dn = s_up;
    phe_k = phe_up;
    w_k = cur.w;
    cur = nxt;
  }
  float x = 0.0f;
  for (int k = nz; k >= 0; --k) {
    const size_t at = (size_t)k * THREADS;
    x = dps[at] - cps[at] * x;
    a.w_out[(size_t)k * plane + c] = x;
    a.ph_out[(size_t)k * plane + c] = k > 0 ? phe[at] + awm * x : phe[0];
  }
}

size_t smem_bytes(int nz) { return (size_t)SLOTS * (nz + 1) * THREADS * sizeof(float); }

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an empty domain or more w levels than a block's
// shared memory holds (605).  `w_damp_full` 0 reads one w_damp value for
// every cell; `msft`, `inv_msft` (both or neither) and `wsfc` may be null.
extern "C" int advance_w(const float* w, const float* ph, const float* rw, const float* rph,
                         const float* om, const float* dphdn, const float* eps_w,
                         const float* w_damp, int w_damp_full, const float* th,
                         const float* coef_pt, const float* s, const float* p_now,
                         const float* rdn_w, const float* mu, const float* inv_mu,
                         const float* msft, const float* inv_msft, const float* wsfc,
                         float* w_out, float* ph_out, int nz, int ny, int nx, float dtau,
                         float dtau_g, float dtau_g_bp, float bp, float bm, float g,
                         void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || (long long)ny * nx > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(nz);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes > DEFAULT_SMEM) {
    const int e = (int)cudaFuncSetAttribute(advance_w_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)bytes);
    if (e != 0) return e;
  }
  // as much of the SM's 256 KB as shared memory as it takes: blocks an SM
  // are bounded by their shared memory
  cudaFuncSetAttribute(advance_w_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  const int ncol = ny * nx;
  const Args a{w, ph, rw, rph, om, dphdn, eps_w, w_damp, th, coef_pt, s, p_now, rdn_w, mu,
               inv_mu, msft, inv_msft, wsfc, w_out, ph_out, nz, ncol, w_damp_full,
               dtau, dtau_g, dtau_g_bp, bp, bm, g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((ncol + THREADS - 1) / THREADS);
  advance_w_kernel<<<blocks, THREADS, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The grid `advance_w` launches for nz mass levels and ncol columns, into
// plan[6] = {threads of a block, blocks, shared bytes a block, blocks an SM,
// registers a thread, local (spilled) bytes a thread}.
extern "C" int advance_w_plan(int nz, int ncol, int* plan) {
  const size_t bytes = smem_bytes(nz);
  plan[0] = THREADS;
  plan[1] = (ncol + THREADS - 1) / THREADS;
  plan[2] = (int)bytes;
  if (bytes > DEFAULT_SMEM && bytes <= MAX_SMEM)
    cudaFuncSetAttribute(advance_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  cudaFuncSetAttribute(advance_w_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  int per_sm = 0;
  int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, advance_w_kernel, THREADS,
                                                              bytes);
  if (e != 0) return e;
  plan[3] = per_sm;
  cudaFuncAttributes attr;
  e = (int)cudaFuncGetAttributes(&attr, advance_w_kernel);
  if (e != 0) return e;
  plan[4] = attr.numRegs;
  plan[5] = (int)attr.localSizeBytes;
  return 0;
}
