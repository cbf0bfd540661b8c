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
// On a map-projected grid an optional m2 (ny, nx), the squared map factor
// at mass points, scales the horizontal part, as flux_div's m_h does:
//
//   out[k,j,i] = -( m2[j,i] * ((Fx[i+1]-Fx[i])*rdx + (Fy[j+1]-Fy[j])*rdy)
//                   + (Fz[k+1]-Fz[k])*rdnw[k] )
//
// The TPU kernel has no map factor (the reference's dycore sends projected
// grids through its plain operators); with m2 null the flat kernel runs,
// instruction for instruction as before (a template parameter).
//
// Shapes (float32, contiguous): q_pad, ru_pad, rv_pad (nz, ny+6, nx+6);
// ww (nz+1, ny, nx); rdnw (nz,); m2 (ny, nx) or null; out (nz, ny, nx).
//
// Bound: memory.  Each input read once and the output written once is
// 4*(3*nz*(ny+6)*(nx+6) + (nz+1)*ny*nx + nz + nz*ny*nx) bytes (10.8 MB at
// 100x100x50, 3.22 us at 3.35 TB/s) against ~140 float operations per cell
// (~1 us at 67 TFLOP/s).  What the card showed (NVIDIA H100 80GB HBM3,
// 700 W; scripts/kernel_ab_gpu.py, warm L2): the first design, one thread
// per cell with every operand from device memory on a 2,600-block grid,
// took 10.1 us; an empty kernel on that grid takes 3.4 us, the same kernel
// with its flux arithmetic replaced by sums of its 28 loads a cell 8.6 us,
// and a kernel that only reads the inputs once and writes the output
// 4.7 us.  So the loads a cell issues, in 2.5 waves of blocks that each
// wait for theirs, and the grid's fixed cost set its time, not the
// arithmetic.  Two designs that lost (one-off probes, not kept): planes
// staged in shared memory by tiles of 4 rows that march up chunks of 3
// levels, two barriers a level (11.9 us: each block's march is a chain of
// waits, and one scalar gives too few blocks to hide them); the march
// below with the next level's loads issued a level ahead into registers
// (8.3 us at best: 120 registers a thread leave too few warps an SM, and
// at 64 it spills and takes 28 us).
//
// Design: each thread marches up a chunk of levels in registers, with no
// shared memory and no barrier; warps (20 an SM) hide the loads' latency.
//
// - A thread owns a slot (p, i) of the plane: the cells (RY p + r, i),
//   r < RY, of one column and the west x faces of those rows; slots run
//   over i = 0 .. nx, one more than the cells, so that each x face has an
//   owner.  Warp g covers slots 31 g .. 31 g + 31: its last lane only
//   computes faces, for the cells of lane 30, and the next warp starts at
//   that slot.  A cell's east x face comes from the next lane by a warp
//   shuffle, so each x face is computed once.  The RY cells of a thread
//   share their inner y faces: RY + 1 faces for RY cells.
// - Loads per level (27 at RY = 2, 13.5 a cell against 28): the x stencils
//   of the RY rows (6 q and one ru each), the six y-stencil q values
//   outside them and RY + 1 rv; the z stencil keeps q of the levels below
//   and above in registers, and loads one new level and omega a level
//   ahead.  All of a level's loads are independent, so a warp has them in
//   flight at once; neighbouring lanes read neighbouring addresses.
// - Every offset of a level is a multiple of the padded row width from one
//   base per array, so that a level costs a few address computations.
// - Grid: the warps of a plane in blocks of 4 times chunks of `kc` levels;
//   `kc` is chosen so that the grid holds about RESIDENT blocks per SM (at
//   100x100x50 on 132 SMs: 163 warps a plane, 41 blocks, kc = 4, 13
//   chunks, 533 blocks, 86 registers a thread).  Small blocks spread the
//   work evenly over the SMs.  A chunk starts by reading the z face below
//   it from device memory.
//
// This design takes 6.3 us at (50, 106, 106), 51% of the bound, against
// 10.1 us for the first design in the same run; an empty kernel on its
// grid takes 2.2 us of that, and the read-once kernel above 4.6 us.  What
// bounds it now is that fixed cost and the wait for each level's loads,
// not the bytes and not the arithmetic (206 float instructions of its 592
// in SASS, the rest mostly integer address arithmetic and the loads).
//
// The map factor adds one load a cell, made once before the march, and one
// multiply a cell and level.
//
// Arithmetic: the order of every operation follows advection.flux5/flux3
// and flux_div, and the library is built with --fmad=false so that no
// multiply-add is contracted: the kernel rounds exactly where the plain
// PyTorch version (ops/adv_kernel.py::advect_scalar_5_3_reference) does.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RY = 2;                  // rows of cells a thread owns
constexpr int RESIDENT = 5;            // blocks meant to share an SM (at most 102 registers a thread)
constexpr unsigned FULL = 0xffffffffu;
static_assert(RY <= 4, "a thread's rows past ny must stay inside the halo");

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

struct Args {
  const float* q;
  const float* ru;
  const float* rv;
  const float* ww;
  const float* rdnw;
  const float* m2;     // (ny, nx), or null on a flat grid
  float* out;
  int nz, ny, nx;
  int warps, blocks_per_plane, kc;   // warps and blocks of a plane, levels of a chunk
  float rdx, rdy;
};

// A thread's operands of one level k: what the level's arithmetic reads
// from device memory.
struct Level {
  float xq[RY][6];    // q of the x stencils of the RY rows
  float ux[RY];       // ru at the rows' west x faces
  float yo[6];        // q of the y stencil in the 3 rows below and above the RY rows
  float vy[RY + 1];   // rv at the RY + 1 y faces
  float qz[RY];       // q at level k + 2 (clamped to the top level)
  float wz[RY];       // omega at face k + 2 (clamped to the top face)
};

// The operands of level k.  `at` is the offset of padded row j0, column i
// in a plane (row j0 + r + 3 holds cell row r); `top` the offset, from row
// j0, of the last row the y stencil may read (ny + 5 at most); `og` the
// cells' offsets in an unpadded plane.
__device__ __forceinline__ void fetch(Level& L, const Args& a, int k, int px, int at, int top,
                                      const int (&og)[RY]) {
  const size_t pyx = (size_t)(a.ny + 2 * PAD) * px, nyx = (size_t)a.ny * a.nx;
  const float* const qk = a.q + (size_t)k * pyx + at;
  const float* const ruk = a.ru + (size_t)k * pyx + at;
  const float* const rvk = a.rv + (size_t)k * pyx + at + PAD;
  const float* const qk2 = a.q + (size_t)min(k + 2, a.nz - 1) * pyx + at;
  const float* const wk2 = a.ww + (size_t)min(k + 2, a.nz) * nyx;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) L.xq[r][c] = qk[(r + PAD) * px + c];
    L.ux[r] = ruk[(r + PAD) * px + PAD];
    L.qz[r] = qk2[(r + PAD) * px + PAD];
    L.wz[r] = wk2[og[r]];
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    L.yo[m] = qk[m * px + PAD];
    L.yo[3 + m] = qk[min(PAD + RY + m, top) * px + PAD];
  }
#pragma unroll
  for (int f = 0; f <= RY; ++f) L.vy[f] = rvk[(f + PAD) * px];
}

template <bool MSF>
__global__ void __launch_bounds__(THREADS, RESIDENT) advect_scalar_5_3_kernel(Args a) {
  const int nx = a.nx, ny = a.ny, nz = a.nz, px = nx + 2 * PAD, w = nx + 1;
  const size_t pyx = (size_t)(ny + 2 * PAD) * px, nyx = (size_t)ny * nx;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x % a.blocks_per_plane) * WARPS + (threadIdx.x >> 5);
  const int k0 = (blockIdx.x / a.blocks_per_plane) * a.kc;
  const int k1 = min(k0 + a.kc, nz);
  const int slots = (ny + RY - 1) / RY * w;
  const int slot = 31 * warp + lane;
  // every lane stays to the end (the shuffles need the whole warp); a lane
  // past the last slot reads at slot 0 and stores nothing
  const bool live = warp < a.warps && slot < slots;
  const int p = live ? slot / w : 0;
  const int i = live ? slot - p * w : 0;
  const bool owner = live && lane < 31 && i < nx;
  const int j0 = p * RY;
  // a row past ny (j0 + r >= ny) is a halo row: its q is the y stencil's,
  // and its cell is never stored
  const int at = j0 * px + i;
  const int top = ny + 5 - j0;
  int og[RY];
  bool cell[RY];
  float m2[RY];        // the rows' squared map factors (MSF)
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    cell[r] = owner && j0 + r < ny;
    og[r] = min(j0 + r, ny - 1) * nx + min(i, nx - 1);
    m2[r] = MSF ? a.m2[og[r]] : 1.0f;
  }

  // the z face below the chunk (0 at the surface), q one level below and
  // one above the first level, omega at the face above it
  float q_dn[RY], q_up[RY], fz_lo[RY], ww_up[RY];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const float* const qc = a.q + at + (r + PAD) * px + PAD;
    q_dn[r] = qc[(size_t)max(k0 - 1, 0) * pyx];
    q_up[r] = qc[(size_t)min(k0 + 1, nz - 1) * pyx];
    fz_lo[r] = 0.0f;
    if (k0 > 0)
      fz_lo[r] = -flux3(-a.ww[(size_t)k0 * nyx + og[r]], qc[(size_t)max(k0 - 2, 0) * pyx],
                        q_dn[r], qc[(size_t)k0 * pyx], q_up[r]);
    ww_up[r] = a.ww[(size_t)min(k0 + 1, nz) * nyx + og[r]];
  }

  for (int k = k0; k < k1; ++k) {
    Level cur;
    fetch(cur, a, k, px, at, top, og);
    const float rd = a.rdnw[k];
    const bool lid = k + 1 == nz;            // no flux through the model top
    float* const out_k = a.out + (size_t)k * nyx;
    float ys[RY + 6];                        // the y stencil column of the level
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ys[m] = cur.yo[m];
      ys[PAD + RY + m] = cur.yo[3 + m];
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) ys[PAD + r] = cur.xq[r][PAD];   // the cells' own q
    float fy[RY + 1];
#pragma unroll
    for (int f = 0; f <= RY; ++f)
      fy[f] = flux5(cur.vy[f], ys[f], ys[f + 1], ys[f + 2], ys[f + 3], ys[f + 4], ys[f + 5]);
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      // x faces i (this lane) and i+1 (the next lane's), z face k+1
      const float fx0 = flux5(cur.ux[r], cur.xq[r][0], cur.xq[r][1], cur.xq[r][2],
                              cur.xq[r][3], cur.xq[r][4], cur.xq[r][5]);
      const float fx1 = __shfl_down_sync(FULL, fx0, 1);
      const float fz = -flux3(-ww_up[r], q_dn[r], cur.xq[r][PAD], q_up[r], cur.qz[r]);
      const float fz_up = lid ? 0.0f : fz;
      float div = (fx1 - fx0) * a.rdx;
      div = div + (fy[r + 1] - fy[r]) * a.rdy;
      if (MSF) div = m2[r] * div;
      div = div + (fz_up - fz_lo[r]) * rd;
      if (cell[r]) out_k[og[r]] = -div;
      fz_lo[r] = fz_up;
      q_dn[r] = cur.xq[r][PAD];
      q_up[r] = cur.qz[r];
      ww_up[r] = cur.wz[r];
    }
  }
}

// The launch plan {warps of a plane, blocks of a plane, levels of a chunk,
// chunks} for a grid on `sms` SMs.
void make_plan(int nz, int ny, int nx, int sms, int* p) {
  const int slots = (ny + RY - 1) / RY * (nx + 1);
  const int warps = (slots - 1 + 30) / 31;       // warp g owns the cells of slots 31g .. 31g+30
  const int bpp = (warps + WARPS - 1) / WARPS;
  int want = sms * RESIDENT / bpp;               // chunks that fill the card
  want = want < 1 ? 1 : (want > nz ? nz : want);
  const int kc = (nz + want - 1) / want;
  p[0] = warps;
  p[1] = bpp;
  p[2] = kc;
  p[3] = (nz + kc - 1) / kc;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return sms > 0 ? sms : 1;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `m2` (ny, nx) may be null: a flat grid.
extern "C" int advect_scalar_5_3(const float* q_pad, const float* ru_pad,
                                 const float* rv_pad, const float* ww,
                                 const float* rdnw, const float* m2, float* out, int nz,
                                 int ny, int nx, float rdx, float rdy, void* stream) {
  int p[4];
  make_plan(nz, ny, nx, sm_count(), p);
  const Args a{q_pad, ru_pad, rv_pad, ww, rdnw, m2, out, nz, ny, nx, p[0], p[1], p[2], rdx,
               rdy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(p[1] * p[3]);
  if (m2 != nullptr)
    advect_scalar_5_3_kernel<true><<<blocks, THREADS, 0, s>>>(a);
  else
    advect_scalar_5_3_kernel<false><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plan `advect_scalar_5_3` launches for a grid on `sms` SMs, into
// plan[6] = {rows of cells a thread owns, warps of a plane, blocks of a
// plane, levels of a chunk, chunks, threads of a block}.
extern "C" void advect_scalar_5_3_plan(int nz, int ny, int nx, int sms, int* plan) {
  plan[0] = RY;
  make_plan(nz, ny, nx, sms, plan + 1);
  plan[5] = THREADS;
}
