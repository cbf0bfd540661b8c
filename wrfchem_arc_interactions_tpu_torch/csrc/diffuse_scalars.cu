// Subgrid diffusion of a stack of scalars, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's diffusion is plain `jnp`
// (`wrfchem_arc_interactions_tpu/dycore/diffusion.py::diffusion_tendencies`).
// It was added because the port's plain version of the scalars' pass,
// some 36 elementwise operators over a slice of the stack, each reading and
// writing the whole slice, took 138 ms a main step at config 5's
// 500x500x60 block with 107 scalars (H100): the largest owner of the
// step's device time.  It computes, for each scalar s of one pass's slice,
// what `ops/diffusion_kernel.py::diffuse_scalars_reference` computes:
//
//   out[s,k,j,i] = hdiff                        (_hdiff)
//                + vdiff        when kvdif > 0  (_vdiff)
//                + filter6      when diff_6th_opt is on (_filter6)
//
//   hdiff  = rdx2 * (k_e*(qE - q0) - k_w*(q0 - qW))
//          + rdy2 * (k_n*(qN - q0) - k_s*(q0 - qS)),   k_e = 0.5*(k0 + kE), ...
//   vdiff  = (kvdif * (dq_up - dq_dn)) / dz2,   dq_up = q[k+1] - q[k] (0 at the top),
//                                               dq_dn = q[k] - q[k-1] (0 at the bottom)
//   filter6 = neg_coef * (sx + sy),   sx = -w0 + 6 w1 - 15 w2 + 20 w3 - 15 w4 + 6 w5 - w6
//                                     along x, sy along y, summed left to right;
//                                     neg_coef = -diff_6th_factor / (64 dt)
//
// Shapes (float32, contiguous): sc_pad (nt, nz, ny+6, nx+6), the slice as
// the halo exchange pads it; k_pad (nz, ny+6, nx+6), the eddy viscosity
// (Smagorinsky or the TKE closure's) padded alike; dz2 (nz, ny, nx) or null
// (no vertical term); out (nt, nz, ny, nx).  Lateral boundaries and mesh
// seams live in the pads, so the kernel knows nothing of them.
//
// Bound: memory.  The slice read once, K and dz2 once, the tendency
// written once: 4*((nt + 1)*nz*(ny+6)*(nx+6) + nz*ny*nx + nt*nz*ny*nx)
// bytes, 2.31 GB a pass of 18 scalars at config 5's block (0.69 ms at
// 3.35 TB/s), against ~20 float operations a cell without the filter and
// ~40 with it (~0.1 ms at 67 TFLOP/s).
//
// Design: each thread marches up the levels of a chunk in registers, with
// no shared memory and no barrier, as the scalar advection kernel does.
//
// - A block of 8 warps owns a tile of 32 columns by 16 rows of one scalar;
//   a warp owns 32 neighbouring columns, and each lane RY = 2 rows of its
//   column.  The lane's rows share their y stencil: RY + 6 q values of the
//   column (RY + 2 without the filter) and RY + 2 of K give every y
//   neighbour and y face of its cells.  The x neighbours are loads of the
//   same rows, which the warp's neighbouring lanes load too, so they come
//   from L1.  A level's loads (`fetch`) are all independent of each other.
// - The vertical term keeps q of the level below and of the level above
//   in registers: a level costs one new load of the cells' q.
// - K's planes are shared by the scalars.  The scalar is the fastest index
//   of the grid, so the blocks of one tile's scalars run together and read
//   each plane of K from L2 after the first.
// - Rows of the padded slice are nx + 6 floats (506 at the block): their
//   starts are not 16-byte aligned, so loads are of single floats, which a
//   warp still coalesces.
// - Grid: nt x tiles x chunks of levels, the chunks as many as give the
//   card about WAVES waves of RESIDENT blocks an SM (one chunk for the
//   9,216 blocks of a pass at config 5's block).  A chunk starts by
//   reading q one level below it.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W, a pass of 18 scalars at config
// 5's block, kvdif 30): 1.48 ms, 46% of the 0.69-ms bound (1.97 ms with
// the filter), against 19.8 ms for the plain version's operators.  Tried
// on the card and dropped (one-off probes, not kept): RY 1, 4 and 8 at 2
// to 8 blocks an SM (1.49-7.0 ms; RY 4 at 4 blocks, 64 registers, 1.64
// ms); 2, 4 and 8 columns a lane, 32 apart, for wider x tiles (1.62-3.5
// ms: more registers, spills); each level's loads issued a level ahead
// into a second set of registers (1.38-1.42 ms at best, but the filter's
// instance spilled and took 2.6-6.0 ms).  So neither occupancy nor the
// wait for a level's loads bounds it; the misaligned rows' loads through
// L1 are the suspect, not measured (ncu does not run there): a ring of
// planes in shared memory filled by 16-byte asynchronous copies, as the
// multi-tracer kernel has, is the design to try next.
//
// Arithmetic: every value is formed in the plain version's order, and the
// library is built with --fmad=false, so that no multiply-add is
// contracted: the kernel is bitwise its plain version.  k_w of a cell is
// k_e of its west neighbour (IEEE addition commutes), so forming a face's
// K once or twice gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RY = 2;                  // rows of cells a lane owns
constexpr int TX = 32;                 // columns of a tile
constexpr int TY = WARPS * RY;         // rows of a tile
constexpr int RESIDENT = 4;            // blocks meant to share an SM (64 registers a thread)
constexpr int WAVES = 4;               // waves of blocks the chunks aim at

struct Args {
  const float* q;       // (nt, nz, ny+6, nx+6)
  const float* k;       // (nz, ny+6, nx+6)
  const float* dz2;     // (nz, ny, nx), or null without the vertical term
  float* out;           // (nt, nz, ny, nx)
  int nt, nz, ny, nx;
  int tiles_x, tiles_y, kc;
  float rdx2, rdy2, kvdif, neg_coef;
};

// A lane's operands of one level: what the level's arithmetic reads from
// device memory.
struct Level {
  float col[RY + 2 * PAD];   // q of the column at padded rows j0 .. j0 + RY + 5
  float kcol[RY + 2];        // K of the column at padded rows j0 + 2 .. j0 + RY + 3
  float xq[RY][6];           // q of each row at x offsets -3, -2, -1, +1, +2, +3
  float xk[RY][2];           // K of each row at x offsets -1, +1
  float qu[RY];              // q of the cells at level k + 1
  float dz[RY];              // dz2 of the cells
};

// The operands of level k: `qk`, `kk` at padded row j0 of the lane's
// column in level k's planes, `dk` at the lane's first cell of dz2's.
// Without the filter only rows j0 + 2 .. j0 + RY + 3 of the column and x
// offsets -1, +1 are read; with the vertical term the cells' own q comes
// from the level below's qu, not from here.
template <bool VDIFF, bool FILTER>
__device__ __forceinline__ void fetch(Level& L, const float* qk, const float* kk,
                                      const float* dk, size_t pyx, int px, int top, bool above,
                                      const int (&row)[RY], const int (&cell)[RY]) {
#pragma unroll
  for (int r = 0; r < RY + 2 * PAD; ++r) {
    const bool own = r >= PAD && r < PAD + RY;
    if ((FILTER || (r >= PAD - 1 && r <= PAD + RY)) && !(VDIFF && own))
      L.col[r] = qk[min(r, top) * px];
  }
#pragma unroll
  for (int r = 0; r < RY + 2; ++r) L.kcol[r] = kk[min(r + PAD - 1, top) * px];
#pragma unroll
  for (int m = 0; m < RY; ++m) {
    const float* const qr = qk + row[m];
    L.xq[m][2] = qr[-1];
    L.xq[m][3] = qr[1];
    if (FILTER) {
      L.xq[m][0] = qr[-3];
      L.xq[m][1] = qr[-2];
      L.xq[m][4] = qr[2];
      L.xq[m][5] = qr[3];
    }
    L.xk[m][0] = kk[row[m] - 1];
    L.xk[m][1] = kk[row[m] + 1];
    if (VDIFF) {
      L.qu[m] = above ? qr[pyx] : 0.0f;
      L.dz[m] = dk[cell[m]];
    }
  }
}

template <bool VDIFF, bool FILTER>
__global__ void __launch_bounds__(THREADS, RESIDENT) diffuse_scalars_kernel(Args a) {
  const int nz = a.nz, ny = a.ny, nx = a.nx, px = nx + 2 * PAD;
  const size_t pyx = (size_t)(ny + 2 * PAD) * px, nyx = (size_t)ny * nx;
  int b = blockIdx.x;
  const int s = b % a.nt;
  b /= a.nt;
  const int tx = b % a.tiles_x;
  b /= a.tiles_x;
  const int ty = b % a.tiles_y;
  const int k0 = b / a.tiles_y * a.kc;
  const int k1 = min(k0 + a.kc, nz);
  const int i = tx * TX + (int)(threadIdx.x & 31);
  const int j0 = ty * TY + (int)(threadIdx.x >> 5) * RY;
  if (i >= nx || j0 >= ny) return;       // no barrier or shuffle follows
  const int rows = min(RY, ny - j0);     // the lane's rows inside the domain
  // the last padded row a stencil may read, counted from padded row j0; a
  // row of the lane past ny reads clamped rows and stores nothing
  const int top = ny + 2 * PAD - 1 - j0;
  // padded row j0, the lane's column (padded column i + PAD)
  const float* const qs = a.q + (size_t)s * nz * pyx + (size_t)j0 * px + i + PAD;
  const float* const ks = a.k + (size_t)j0 * px + i + PAD;
  const float* const ds = VDIFF ? a.dz2 + (size_t)j0 * nx + i : nullptr;
  float* const os = a.out + (size_t)s * nz * nyx + (size_t)j0 * nx + i;
  int row[RY];                           // offset of each cell's own padded row
  int cell[RY];                          // offset of each cell in an unpadded plane
#pragma unroll
  for (int m = 0; m < RY; ++m) {
    row[m] = min(m + PAD, top) * px;
    cell[m] = min(m, rows - 1) * nx;
  }

  float qc[RY], qd[RY];                  // with the vertical term: q at level k and k - 1
#pragma unroll
  for (int m = 0; m < RY; ++m) {
    qc[m] = VDIFF ? qs[(size_t)k0 * pyx + row[m]] : 0.0f;
    qd[m] = VDIFF && k0 > 0 ? qs[(size_t)(k0 - 1) * pyx + row[m]] : 0.0f;
  }
  for (int k = k0; k < k1; ++k) {
    Level cur;
    fetch<VDIFF, FILTER>(cur, qs + (size_t)k * pyx, ks + (size_t)k * pyx,
                         VDIFF ? ds + (size_t)k * nyx : nullptr, pyx, px, top, k + 1 < nz, row,
                         cell);
    if (VDIFF) {
#pragma unroll
      for (int m = 0; m < RY; ++m) cur.col[m + PAD] = qc[m];
    }
    const bool above = k + 1 < nz;
#pragma unroll
    for (int m = 0; m < RY; ++m) {
      const float* const c = cur.col + m;      // c[3] is the cell, c[0] .. c[6] its y stencil
      const float q0 = c[PAD];
      const float qE = cur.xq[m][3], qW = cur.xq[m][2];
      const float kc0 = cur.kcol[m + 1];
      const float k_e = 0.5f * (kc0 + cur.xk[m][1]);
      const float k_w = 0.5f * (kc0 + cur.xk[m][0]);
      const float k_n = 0.5f * (kc0 + cur.kcol[m + 2]);
      const float k_s = 0.5f * (kc0 + cur.kcol[m]);
      float t = a.rdx2 * (k_e * (qE - q0) - k_w * (q0 - qW)) +
                a.rdy2 * (k_n * (c[PAD + 1] - q0) - k_s * (q0 - c[PAD - 1]));
      if (VDIFF) {
        const float dq_up = above ? cur.qu[m] - q0 : 0.0f;
        const float dq_dn = k > 0 ? q0 - qd[m] : 0.0f;
        t = t + (a.kvdif * (dq_up - dq_dn)) / cur.dz[m];
      }
      if (FILTER) {
        const float sx = -cur.xq[m][0] + 6.0f * cur.xq[m][1] - 15.0f * qW + 20.0f * q0 -
                         15.0f * qE + 6.0f * cur.xq[m][4] - cur.xq[m][5];
        const float sy = -c[0] + 6.0f * c[1] - 15.0f * c[2] + 20.0f * c[3] - 15.0f * c[4] +
                         6.0f * c[5] - c[6];
        t = t + a.neg_coef * (sx + sy);
      }
      if (m < rows) os[(size_t)k * nyx + cell[m]] = t;
    }
    if (VDIFF) {
#pragma unroll
      for (int m = 0; m < RY; ++m) {
        qd[m] = qc[m];
        qc[m] = cur.qu[m];
      }
    }
  }
}

// The launch plan {x tiles, y tiles, levels of a chunk, chunks} for a grid
// on `sms` SMs.
void make_plan(int nt, int nz, int ny, int nx, int sms, int* p) {
  const int tiles_x = (nx + TX - 1) / TX, tiles_y = (ny + TY - 1) / TY;
  const long long plane = (long long)nt * tiles_x * tiles_y;     // blocks of a chunk
  long long want = ((long long)sms * RESIDENT * WAVES + plane - 1) / plane;
  want = want < 1 ? 1 : (want > nz ? nz : want);
  const int kc = (int)((nz + want - 1) / want);
  p[0] = tiles_x;
  p[1] = tiles_y;
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
// `dz2` null leaves the vertical term out; `filter` 0 leaves the 6th-order
// filter out.
extern "C" int diffuse_scalars(const float* sc_pad, const float* k_pad, const float* dz2,
                               float* out, int nt, int nz, int ny, int nx, float rdx2,
                               float rdy2, float kvdif, float neg_coef, int filter,
                               void* stream) {
  if (nt < 1 || nz < 1 || ny < 1 || nx < 1) return cudaErrorInvalidValue;
  int p[4];
  make_plan(nt, nz, ny, nx, sm_count(), p);
  const long long blocks = (long long)nt * p[0] * p[1] * p[3];
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const Args a{sc_pad, k_pad, dz2, out, nt, nz, ny, nx, p[0], p[1], p[2],
               rdx2, rdy2, kvdif, neg_coef};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)blocks;
  if (dz2 != nullptr && filter)
    diffuse_scalars_kernel<true, true><<<g, THREADS, 0, st>>>(a);
  else if (dz2 != nullptr)
    diffuse_scalars_kernel<true, false><<<g, THREADS, 0, st>>>(a);
  else if (filter)
    diffuse_scalars_kernel<false, true><<<g, THREADS, 0, st>>>(a);
  else
    diffuse_scalars_kernel<false, false><<<g, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plan `diffuse_scalars` launches for a slice on `sms` SMs, into
// plan[7] = {x tiles, y tiles, levels of a chunk, chunks, threads of a
// block, columns of a tile, rows of a tile}.
extern "C" void diffuse_scalars_plan(int nt, int nz, int ny, int nx, int sms, int* plan) {
  make_plan(nt, nz, ny, nx, sms, plan);
  plan[4] = THREADS;
  plan[5] = TX;
  plan[6] = TY;
}
