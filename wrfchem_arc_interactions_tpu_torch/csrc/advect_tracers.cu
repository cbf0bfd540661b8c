// Fused multi-tracer RK-stage scalar update, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wrfchem_arc_interactions_tpu/ops/pallas_adv_multi.py::
// advect_tracers_fused` (body `_adv_kernel`).  For every tracer t of a stack
// and every cell, in the operation order of the reference's scan body
// (`dycore/solve.py`) and `dycore/advection.py::pd_limit`:
//
//   F      = 5th-order horizontal / 3rd-order vertical fluxes of q
//            (vertical: -flux3(-ww) on edge-replicated ghosts, zero at k = 0
//            and k = nz)
//   if pd:   L  = first-order upwind fluxes, renormalised by the donor
//               cell's factor r_lo (limit_low_order)
//            phi_td = max(phi_old + dts * (-div L), 0)
//            A  = F - L, scaled by the donor cell's factor r_hi
//            F  = L + A r_hi
//   tend   = -div F (+ mu_full * pt when a tendency stack is given)
//   q_new  = (phi_old + dts * tend) / mu_new,   max(q_new, 0) if clip
//
// Shapes (float32, contiguous): q (nt, nz, ny+6, nx+6) padded by the
// lateral boundary rule; phi_old, pt, r_lo, r_hi, out (nt, nz, ny, nx);
// ru, rv (nz, ny+6, nx+6); ww (nz+1, ny, nx); mu_full, mu_new (ny, nx);
// rdnw (nz,).
//
// Bound: memory.  Each input read once and the output written once is
// ~0.39 GB at nt = 47 and 100x100x50 (0.12 ms at 3.35 TB/s), against
// ~75 float operations per cell and tracer without the limiter and ~200
// with it (at most 4.7 GFLOP, 0.07 ms at 67 TFLOP/s).
//
// Design (first, simple version): one thread per (tracer, cell), blocks of
// 32x8 cells over (x, y) and one grid layer per (tracer, level).  Without
// the limiter one launch computes the update.  With it, three launches:
// (1) r_lo per cell from the low-order fluxes, (2) r_hi per cell from the
// renormalised low-order and the antidiffusive fluxes, (3) the update.
// Each launch recomputes the fluxes of its cell's six faces from global
// memory (reuse between neighbours is left to L1/L2).  The factor of a
// neighbour outside the domain is read through the lateral boundary's
// index map (periodic wrap, open edge replication, symmetric reflection),
// which is what the reference's halo padding of r by one cell gives for
// every boundary kind; the TPU kernel instead recomputed the factors in
// the ghost ring, which equals that only for periodic boundaries.
//
// Arithmetic: every operation follows the plain PyTorch version
// (ops/tracers_kernel.py::advect_tracers_reference) in order, and the
// library is built with --fmad=false, so the two round alike.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int TX = 32;
constexpr int TY = 8;

struct Args {
  const float* q;
  const float* phi;
  const float* pt;       // may be null
  const float* ru;
  const float* rv;
  const float* ww;
  const float* mu_full;
  const float* mu_new;
  const float* rdnw;
  float* r_lo;
  float* r_hi;
  float* out;
  int nt, nz, ny, nx;
  int bcx, bcy;          // 0 periodic, 1 open, 2 symmetric
  float rdx, rdy, dts;
};

// The reference multiplies by the Python double 1/60 (1/12) cast to float.
__device__ __forceinline__ float flux5(float vel, float qm3, float qm2, float qm1,
                                       float q0, float qp1, float qp2) {
  const float r60 = (float)(1.0 / 60.0);
  const float f6 = vel * (37.0f * (q0 + qm1) - 8.0f * (qp1 + qm2) + (qp2 + qm3)) * r60;
  return f6 - fabsf(vel) * (10.0f * (q0 - qm1) - 5.0f * (qp1 - qm2) + (qp2 - qm3)) * r60;
}

__device__ __forceinline__ float flux3(float vel, float qm2, float qm1, float q0,
                                       float qp1) {
  const float r12 = (float)(1.0 / 12.0);
  const float f4 = vel * (7.0f * (q0 + qm1) - (qp1 + qm2)) * r12;
  return f4 - fabsf(vel) * (3.0f * (q0 - qm1) - (qp1 - qm2)) * r12;
}

__device__ __forceinline__ float flux1(float vel, float qm1, float q0) {
  return vel * (vel > 0.0f ? qm1 : q0);
}

// Cell index c in [-1, n] of a boundary-padded axis -> interior cell.
__device__ __forceinline__ int bc_map(int c, int n, int bc) {
  if (c >= 0 && c < n) return c;
  if (bc == 0) return c < 0 ? c + n : c - n;     // periodic: wrap
  if (bc == 1) return c < 0 ? 0 : n - 1;         // open: replicate the edge
  return c < 0 ? -c : 2 * (n - 1) - c;           // symmetric: reflect
}

__device__ __forceinline__ size_t qidx(const Args& a, int t, int k, int jp, int ip) {
  return (((size_t)t * a.nz + k) * (a.ny + 2 * PAD) + jp) * (a.nx + 2 * PAD) + ip;
}
__device__ __forceinline__ size_t widx(const Args& a, int k, int jp, int ip) {
  return ((size_t)k * (a.ny + 2 * PAD) + jp) * (a.nx + 2 * PAD) + ip;
}
__device__ __forceinline__ size_t cidx(const Args& a, int t, int k, int j, int i) {
  return (((size_t)t * a.nz + k) * a.ny + j) * a.nx + i;
}

// ---- face fluxes: x face f lies between cells f-1 and f (0 <= f <= nx),
// y face f between rows f-1 and f, z face kf between levels kf-1 and kf.

__device__ float low_x(const Args& a, int t, int k, int j, int f) {
  const size_t q0 = qidx(a, t, k, j + PAD, f + PAD);
  return flux1(a.ru[widx(a, k, j + PAD, f + PAD)], a.q[q0 - 1], a.q[q0]);
}
__device__ float low_y(const Args& a, int t, int k, int f, int i) {
  const size_t q0 = qidx(a, t, k, f + PAD, i + PAD);
  return flux1(a.rv[widx(a, k, f + PAD, i + PAD)], a.q[q0 - (a.nx + 2 * PAD)], a.q[q0]);
}
__device__ float low_z(const Args& a, int t, int kf, int j, int i) {
  if (kf == 0 || kf == a.nz) return 0.0f;
  const float w = a.ww[((size_t)kf * a.ny + j) * a.nx + i];
  return -flux1(-w, a.q[qidx(a, t, kf - 1, j + PAD, i + PAD)],
                a.q[qidx(a, t, kf, j + PAD, i + PAD)]);
}
__device__ float high_x(const Args& a, int t, int k, int j, int f) {
  const float* s = a.q + qidx(a, t, k, j + PAD, f);
  return flux5(a.ru[widx(a, k, j + PAD, f + PAD)], s[0], s[1], s[2], s[3], s[4], s[5]);
}
__device__ float high_y(const Args& a, int t, int k, int f, int i) {
  const int n = a.nx + 2 * PAD;
  const float* s = a.q + qidx(a, t, k, f, i + PAD);
  return flux5(a.rv[widx(a, k, f + PAD, i + PAD)], s[0], s[n], s[2 * n], s[3 * n],
               s[4 * n], s[5 * n]);
}
__device__ float high_z(const Args& a, int t, int kf, int j, int i) {
  if (kf == 0 || kf == a.nz) return 0.0f;
  const float w = a.ww[((size_t)kf * a.ny + j) * a.nx + i];
  const float qm2 = a.q[qidx(a, t, max(kf - 2, 0), j + PAD, i + PAD)];
  const float qm1 = a.q[qidx(a, t, kf - 1, j + PAD, i + PAD)];
  const float q0 = a.q[qidx(a, t, kf, j + PAD, i + PAD)];
  const float qp1 = a.q[qidx(a, t, min(kf + 1, a.nz - 1), j + PAD, i + PAD)];
  return -flux3(-w, qm2, qm1, q0, qp1);
}

// A face flux scaled by the factor of its donor cell (the cell it drains).
__device__ __forceinline__ float donor_x(const Args& a, const float* r, float f_,
                                         int t, int k, int j, int f) {
  const int c = bc_map(f_ > 0.0f ? f - 1 : f, a.nx, a.bcx);
  return f_ * r[cidx(a, t, k, j, c)];
}
__device__ __forceinline__ float donor_y(const Args& a, const float* r, float f_,
                                         int t, int k, int f, int i) {
  const int c = bc_map(f_ > 0.0f ? f - 1 : f, a.ny, a.bcy);
  return f_ * r[cidx(a, t, k, c, i)];
}
__device__ __forceinline__ float donor_z(const Args& a, const float* r, float f_,
                                         int t, int kf, int j, int i) {
  // positive flux drains the upper cell kf; ghost levels replicate the edge
  const int c = f_ > 0.0f ? min(kf, a.nz - 1) : max(kf - 1, 0);
  return f_ * r[cidx(a, t, c, j, i)];
}

// Renormalised low-order fluxes (limit_low_order).
__device__ float lows_x(const Args& a, int t, int k, int j, int f) {
  return donor_x(a, a.r_lo, low_x(a, t, k, j, f), t, k, j, f);
}
__device__ float lows_y(const Args& a, int t, int k, int f, int i) {
  return donor_y(a, a.r_lo, low_y(a, t, k, f, i), t, k, f, i);
}
__device__ float lows_z(const Args& a, int t, int kf, int j, int i) {
  return donor_z(a, a.r_lo, low_z(a, t, kf, j, i), t, kf, j, i);
}

// Limiter factor: min(1, avail / outflow) where there is outflow, else 1.
__device__ __forceinline__ float factor(float avail, float xl, float xr, float yl,
                                        float yr, float zl, float zu, float rdnw,
                                        const Args& a) {
  const float out_x = fmaxf(xr, 0.0f) - fminf(xl, 0.0f);
  const float out_y = fmaxf(yr, 0.0f) - fminf(yl, 0.0f);
  const float up_c = -zu * rdnw;
  const float lo_c = zl * rdnw;
  const float out_z = fmaxf(-up_c, 0.0f) + fmaxf(-lo_c, 0.0f);
  const float p_out = a.dts * ((out_x * a.rdx + out_y * a.rdy) + out_z);
  return p_out > 0.0f ? fminf(avail / fmaxf(p_out, 1e-30f), 1.0f) : 1.0f;
}

__device__ __forceinline__ float divergence(float xl, float xr, float yl, float yr,
                                            float zl, float zu, float rdnw,
                                            const Args& a) {
  return -(((xr - xl) * a.rdx + (yr - yl) * a.rdy) + (zu - zl) * rdnw);
}

// (1) r_lo: donor factor of the first-order upwind fluxes.
__global__ void __launch_bounds__(TX * TY) low_factor_kernel(Args a) {
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  const int t = blockIdx.z / a.nz;
  const int k = blockIdx.z % a.nz;
  if (i >= a.nx || j >= a.ny) return;
  const size_t c = cidx(a, t, k, j, i);
  a.r_lo[c] = factor(fmaxf(a.phi[c], 0.0f),
                     low_x(a, t, k, j, i), low_x(a, t, k, j, i + 1),
                     low_y(a, t, k, j, i), low_y(a, t, k, j + 1, i),
                     low_z(a, t, k, j, i), low_z(a, t, k + 1, j, i), a.rdnw[k], a);
}

// (2) r_hi: donor factor of the antidiffusive fluxes.
__global__ void __launch_bounds__(TX * TY) high_factor_kernel(Args a) {
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  const int t = blockIdx.z / a.nz;
  const int k = blockIdx.z % a.nz;
  if (i >= a.nx || j >= a.ny) return;
  const size_t c = cidx(a, t, k, j, i);
  const float rdnw = a.rdnw[k];
  const float lxl = lows_x(a, t, k, j, i), lxr = lows_x(a, t, k, j, i + 1);
  const float lyl = lows_y(a, t, k, j, i), lyr = lows_y(a, t, k, j + 1, i);
  const float lzl = lows_z(a, t, k, j, i), lzu = lows_z(a, t, k + 1, j, i);
  const float phi_td = fmaxf(
      a.phi[c] + a.dts * divergence(lxl, lxr, lyl, lyr, lzl, lzu, rdnw, a), 0.0f);
  a.r_hi[c] = factor(phi_td,
                     high_x(a, t, k, j, i) - lxl, high_x(a, t, k, j, i + 1) - lxr,
                     high_y(a, t, k, j, i) - lyl, high_y(a, t, k, j + 1, i) - lyr,
                     high_z(a, t, k, j, i) - lzl, high_z(a, t, k + 1, j, i) - lzu,
                     rdnw, a);
}

// Limited fluxes: renormalised low order + scaled antidiffusive part.
__device__ float lim_x(const Args& a, int t, int k, int j, int f) {
  const float l = lows_x(a, t, k, j, f);
  return l + donor_x(a, a.r_hi, high_x(a, t, k, j, f) - l, t, k, j, f);
}
__device__ float lim_y(const Args& a, int t, int k, int f, int i) {
  const float l = lows_y(a, t, k, f, i);
  return l + donor_y(a, a.r_hi, high_y(a, t, k, f, i) - l, t, k, f, i);
}
__device__ float lim_z(const Args& a, int t, int kf, int j, int i) {
  const float l = lows_z(a, t, kf, j, i);
  return l + donor_z(a, a.r_hi, high_z(a, t, kf, j, i) - l, t, kf, j, i);
}

// (3) the update, with (pd) or without the limiter.
template <bool PD>
__global__ void __launch_bounds__(TX * TY) update_kernel(Args a, int clip) {
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  const int t = blockIdx.z / a.nz;
  const int k = blockIdx.z % a.nz;
  if (i >= a.nx || j >= a.ny) return;
  const size_t c = cidx(a, t, k, j, i);
  float xl, xr, yl, yr, zl, zu;
  if (PD) {
    xl = lim_x(a, t, k, j, i);  xr = lim_x(a, t, k, j, i + 1);
    yl = lim_y(a, t, k, j, i);  yr = lim_y(a, t, k, j + 1, i);
    zl = lim_z(a, t, k, j, i);  zu = lim_z(a, t, k + 1, j, i);
  } else {
    xl = high_x(a, t, k, j, i);  xr = high_x(a, t, k, j, i + 1);
    yl = high_y(a, t, k, j, i);  yr = high_y(a, t, k, j + 1, i);
    zl = high_z(a, t, k, j, i);  zu = high_z(a, t, k + 1, j, i);
  }
  float tend = divergence(xl, xr, yl, yr, zl, zu, a.rdnw[k], a);
  const size_t cell = (size_t)j * a.nx + i;
  if (a.pt != nullptr) tend = tend + a.mu_full[cell] * a.pt[c];
  float qn = (a.phi[c] + a.dts * tend) / a.mu_new[cell];
  if (clip) qn = fmaxf(qn, 0.0f);
  a.out[c] = qn;
}

}  // namespace

// Launches on `stream` (one grid without the limiter, three with it) and
// returns the first cudaGetLastError() that is not 0.  `pt` may be null;
// `r_lo`/`r_hi` are (nt, nz, ny, nx) scratch, unused (may be null) without
// the limiter.
extern "C" int advect_tracers(const float* q, const float* phi, const float* pt,
                              const float* ru, const float* rv, const float* ww,
                              const float* mu_full, const float* mu_new,
                              const float* rdnw, float* r_lo, float* r_hi, float* out,
                              int nt, int nz, int ny, int nx, float rdx, float rdy,
                              float dts, int pd, int clip, int bcx, int bcy,
                              void* stream) {
  Args a{q, phi, pt, ru, rv, ww, mu_full, mu_new, rdnw, r_lo, r_hi, out,
         nt, nz, ny, nx, bcx, bcy, rdx, rdy, dts};
  const dim3 block(TX, TY, 1);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, nt * nz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pd) {
    low_factor_kernel<<<grid, block, 0, s>>>(a);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    high_factor_kernel<<<grid, block, 0, s>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    update_kernel<true><<<grid, block, 0, s>>>(a, clip);
  } else {
    update_kernel<false><<<grid, block, 0, s>>>(a, clip);
  }
  return static_cast<int>(cudaGetLastError());
}
