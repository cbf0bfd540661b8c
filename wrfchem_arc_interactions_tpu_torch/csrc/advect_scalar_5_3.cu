// Fused 5th/3rd-order flux-form scalar advection tendency, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wrfchem_arc_interactions_tpu/ops/pallas_adv.py::
// advect_scalar_5_3` (body `_adv_kernel`), which computes the same function
// as `dycore/advection.py::advect_scalar(q_pad, ru, rv, ww, grid, 5, 3)`:
//
//   out[k,j,i] = -( (Fx[i+1]-Fx[i])*rdx + (Fy[j+1]-Fy[j])*rdy
//                   + (Fz[k+1]-Fz[k])*rdnw[k] )
//
//   Fx, Fy : flux5 of the PAD=3 padded q with the face mass fluxes ru, rv
//   Fz     : -flux3(-ww, ...) on edge-replicated z ghosts (eta decreases with
//            k, so the index-space upwind direction is -sign(ww)); Fz = 0 at
//            k = 0 and k = nz (rigid lid and surface).
//
// Shapes (float32, contiguous): q_pad, ru_pad, rv_pad (nz, ny+6, nx+6);
// ww (nz+1, ny, nx); rdnw (nz,); out (nz, ny, nx).
//
// Bound: memory.  Each input read once and the output written once is
// 4*(3*nz*(ny+6)*(nx+6) + (nz+1)*ny*nx + nz*ny*nx) bytes (10.8 MB at
// 100x100x50, 3.2 us at 3.35 TB/s) against ~140 float operations per cell
// (~1 us at 67 TFLOP/s), so the time is set by bytes.
//
// Design (first, simple version): one thread per output cell, blocks of
// 32x8 cells over (x, y) and one grid layer per level k.  Each thread
// evaluates its two x faces, two y faces and two z faces straight from
// global memory; the 7-point reuse of q between neighbouring threads is
// left to L1/L2 through read-only loads.  Staging a (ty+6)x(tx+6) tile per
// level in shared memory, TMA, and several scalars per launch are later
// work (PERF.md records the time against the bound).
//
// Arithmetic: the order of every operation follows advection.flux5/flux3
// and flux_div, and the library is built with --fmad=false so that no
// multiply-add is contracted: the kernel rounds exactly where the plain
// PyTorch version (ops/adv_kernel.py::advect_scalar_5_3_reference) does.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int TX = 32;
constexpr int TY = 8;

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

__global__ void __launch_bounds__(TX * TY)
advect_scalar_5_3_kernel(const float* __restrict__ q, const float* __restrict__ ru,
                         const float* __restrict__ rv, const float* __restrict__ ww,
                         const float* __restrict__ rdnw, float* __restrict__ out,
                         int nz, int ny, int nx, float rdx, float rdy) {
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= nx || j >= ny) return;

  const int nxp = nx + 2 * PAD;
  const size_t plane = (size_t)(ny + 2 * PAD) * nxp;
  const size_t kp = (size_t)k * plane;

  // x faces i and i+1: face f uses padded columns f..f+5 of row j+PAD and
  // the mass flux at padded column f+PAD.
  const float* qx = q + kp + (size_t)(j + PAD) * nxp + i;
  const float* ux = ru + kp + (size_t)(j + PAD) * nxp + i + PAD;
  const float fx0 = flux5(ux[0], qx[0], qx[1], qx[2], qx[3], qx[4], qx[5]);
  const float fx1 = flux5(ux[1], qx[1], qx[2], qx[3], qx[4], qx[5], qx[6]);
  float div = (fx1 - fx0) * rdx;

  // y faces j and j+1: face f uses padded rows f..f+5 of column i+PAD.
  const float* qy = q + kp + (size_t)j * nxp + i + PAD;
  const float* vy = rv + kp + (size_t)(j + PAD) * nxp + i + PAD;
  const float fy0 = flux5(vy[0], qy[0], qy[nxp], qy[2 * nxp], qy[3 * nxp],
                          qy[4 * nxp], qy[5 * nxp]);
  const float fy1 = flux5(vy[nxp], qy[nxp], qy[2 * nxp], qy[3 * nxp], qy[4 * nxp],
                          qy[5 * nxp], qy[6 * nxp]);
  div = div + (fy1 - fy0) * rdy;

  // z faces k and k+1 on edge-replicated ghosts; zero flux at 0 and nz.
  const float* qc = q + (size_t)(j + PAD) * nxp + i + PAD;
  const size_t cell = (size_t)j * nx + i;
  const size_t wplane = (size_t)ny * nx;
  float fz[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int kf = k + s;
    if (kf == 0 || kf == nz) {
      fz[s] = 0.0f;
      continue;
    }
    const float qm2 = qc[(size_t)max(kf - 2, 0) * plane];
    const float qm1 = qc[(size_t)(kf - 1) * plane];
    const float q0 = qc[(size_t)kf * plane];
    const float qp1 = qc[(size_t)min(kf + 1, nz - 1) * plane];
    fz[s] = -flux3(-ww[(size_t)kf * wplane + cell], qm2, qm1, q0, qp1);
  }
  div = div + (fz[1] - fz[0]) * rdnw[k];

  out[(size_t)k * wplane + cell] = -div;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int advect_scalar_5_3(const float* q_pad, const float* ru_pad,
                                 const float* rv_pad, const float* ww,
                                 const float* rdnw, float* out, int nz, int ny,
                                 int nx, float rdx, float rdy, void* stream) {
  const dim3 block(TX, TY, 1);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, nz);
  advect_scalar_5_3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q_pad, ru_pad, rv_pad, ww, rdnw, out, nz, ny, nx, rdx, rdy);
  return static_cast<int>(cudaGetLastError());
}
