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
// lateral boundary rule; phi_old, pt, r_hi, out (nt, nz, ny, nx);
// ru, rv (nz, ny+6, nx+6); ww (nz+1, ny, nx); mu_full, mu_new (ny, nx);
// rdnw (nz,).
//
// Bound: memory.  Each input read once and the output written once is
// ~0.39 GB at nt = 47 and 100x100x50 (0.12 ms at 3.35 TB/s), against
// ~75 float operations per cell and tracer without the limiter and ~200
// with it (at most 4.7 GFLOP, 0.07 ms at 67 TFLOP/s).  What costs time on
// the card is neither: it is the instructions around the arithmetic.  With
// one thread per cell and every operand fetched from global memory, a
// limited face flux was computed four times, a factor gathered seven
// times, and address arithmetic outweighed the float work three to one.
// This design computes each thing once per grid and keeps the per-level
// work of a thread to loads at fixed offsets from shared memory.
//
// Design: shared-memory planes, fixed slots and a march in z.
//
// - A block owns a tile of rows over the whole x row for one tracer and
//   marches from k = 0 to nz - 1.  Its slots are the (ty + 2) x (nx + 1)
//   points of the tile with a one-row halo and one more column; slot
//   (rr, i) is cell (j0 + rr - 1, i), its west x face and its south y face.
//   Each thread owns four slots (eight for a wide row) for the whole march,
//   so what a slot is (its flags) and where it reads (two offsets) is
//   worked out once, and no lane idles on a ragged x tile.  A thread
//   computes all of its slots alike, without branches on what a slot is, so
//   that the compiler interleaves their work; only the stores look at the
//   flags.  The tile height divides ny evenly and shrinks for rows too wide
//   for the shared memory.
// - Planes come by asynchronous copy (cp.async), started at least one
//   iteration before their use, into rings in shared memory: q (the tile's
//   rows and three halo rows are one contiguous piece of the padded array,
//   so a plane is a linear copy), ru and rv (likewise), and r_hi.  A plane
//   lands shifted by up to 3 floats, so that source and destination are
//   16-byte aligned alike and the copy goes in 16-byte pieces.  The few
//   per-cell values (ww, phi, pt) are loaded into registers a phase before
//   their use.  A level costs two barriers.
// - Each face flux is computed once per grid: x and y faces of the level
//   into shared memory, the z face k+1 by the thread that owns the cell,
//   kept in a register as the lower face of level k+1.
// - The limiter takes two grids instead of three, and r_lo never leaves
//   the chip: it needs only first-order fluxes, so both grids form r_lo of
//   level k+2 on the tile and its halo rows while level k is updated (a
//   ring of three planes).  Grid FACTOR writes r_hi; grid LIMITED reads it
//   into a ring of three planes (tile + one-row halo) and writes the update.
// - The factor of a neighbour outside the domain is read through the
//   lateral boundary's index map (periodic wrap, open edge replication,
//   symmetric reflection), which is what the reference's halo padding of r
//   by one cell gives for every boundary kind.  In x the mapped cell is
//   always in the block's row.  In y an open or symmetric boundary maps
//   the halo row onto a row of the tile or its other halo row; a periodic
//   one forms r_lo from the periodic padding of q (phi and ww read at the
//   wrapped row), which gives the far side's value bit for bit, and reads
//   r_hi from the far side.
// - Residency: three blocks on an SM without the limiter, two with it
//   (registers by launch bound, shared memory by the tile height).
// - Tried on the card and dropped: two tracers a block sharing ru, rv and ww
//   (6.7 MB at 100x100x50, they stay in L2; the block's shared memory
//   doubles and a block less fits an SM: slower), and a ninth warp that only
//   fetches planes (the compute warps' registers shrink: slower with the
//   limiter).  What bounds the kernel now is instruction rate: ~190 float
//   instructions per slot and level with the limiter (no fused multiply-add,
//   so that it rounds like its plain version), and the loads around them.
//
// Arithmetic: every operation follows the plain PyTorch version
// (ops/tracers_kernel.py::advect_tracers_reference) in order, and the
// library is built with --fmad=false, so the two round alike.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int THREADS = 256;
constexpr int TY_MAX = 8;                 // most rows of a tile
constexpr int SMEM_SM = 233472;           // an SM's shared memory
constexpr int SMEM_RESERVED = 1024;       // what the system keeps of it per resident block
constexpr int SMEM_MAX = 227 * 1024;      // most a block may ask for

enum Mode { PLAIN = 0, FACTOR = 1, LIMITED = 2 };

// How far ahead of the level k that is being updated the planes are
// fetched, and the rings that follow from it.  With the limiter, r_lo of
// level k+2 is formed while level k is updated (q planes k+1 .. k+3, mass
// fluxes of level k+2), so its planes must have landed one iteration before.
__host__ __device__ constexpr int q_ahead(int mode) { return mode == PLAIN ? 3 : 4; }
__host__ __device__ constexpr int v_ahead(int mode) { return mode == PLAIN ? 1 : 3; }
constexpr int R_RING = 3;                 // factor planes k .. k+2
// Blocks meant to share an SM: registers (launch bound) and shared memory
// (tile height) are budgeted for that many.
__host__ __device__ constexpr int resident(int mode) { return mode == PLAIN ? 3 : 2; }

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
  float* r_hi;           // written by FACTOR, read by LIMITED
  float* out;
  int nt, nz, ny, nx;
  int bcx, bcy;          // 0 periodic, 1 open, 2 symmetric
  int ty, tiles;         // rows of a tile, tiles over y
  float rdx, rdy, dts;
};

// Shared-memory layout in floats, the same on host and device.  A block's
// slots are the (ty + 2) x (nx + 1) points of its tile with a one-row halo
// and one more column: slot (rr, i) is cell (j0 + rr - 1, i), its west x
// face and its south y face.  Every plane starts on a 16-byte boundary and
// has room for the shift of up to 3 floats that lets its copy from device
// memory go in 16-byte pieces.  A thread computes every kind of flux for
// every slot it owns and stores only what the slot is, so a read may fall a
// row before the first q plane (`lead`) or a few slots after the last plane
// (`tail`): both are inside the block's allocation.
struct Layout {
  int qp, vp, sp;                   // q plane, ru/rv plane, slot plane
  int q, ru, rv, rl, rh, fx, fy;    // offsets
  int total;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Layout layout(int mode, int ty, int nx, int slots) {
  Layout l;
  const int px = nx + 2 * PAD;
  l.qp = round4((ty + 2 * PAD) * px + 3);
  l.vp = round4((ty + 3) * px + 3);
  l.sp = round4((ty + 2) * (nx + 1));
  l.q = round4(px);                                  // lead
  l.ru = l.q + (q_ahead(mode) + 2) * l.qp;
  l.rv = l.ru + (v_ahead(mode) + 1) * l.vp;
  l.rl = l.rv + (v_ahead(mode) + 1) * l.vp;
  l.rh = l.rl + (mode != PLAIN ? R_RING * l.sp : 0);
  l.fx = l.rh + (mode == LIMITED ? R_RING * l.sp : 0);
  l.fy = l.fx + (mode == FACTOR ? 2 : 1) * l.sp;     // FACTOR keeps L and A apart
  l.total = l.fy + (mode == FACTOR ? 2 : 1) * l.sp + round4(slots - l.sp + nx + 2);   // tail
  return l;
}

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
__host__ __device__ __forceinline__ int bc_map(int c, int n, int bc) {
  if (c >= 0 && c < n) return c;
  if (bc == 0) return c < 0 ? c + n : c - n;     // periodic: wrap
  if (bc == 1) return c < 0 ? 0 : n - 1;         // open: replicate the edge
  return c < 0 ? -c : 2 * (n - 1) - c;           // symmetric: reflect
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

// Asynchronous copies from device to shared memory; they have landed for
// every thread of the block after `copies_land` and a barrier.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_land() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// A contiguous piece of n >= 4 floats goes to a 16-byte aligned plane in
// 16-byte copies: element e lands at dst[shift(src) + e], so that source
// and destination are aligned alike; the few floats before the first and
// after the last 16-byte boundary go one by one.
__device__ __forceinline__ int shift(const float* src) {
  return (int)(((size_t)src >> 2) & 3);
}
__device__ __forceinline__ void copy_plane(float* dst, const float* src, int n) {
  const int sh = shift(src), head = (4 - sh) & 3, pieces = (n - head) >> 2;
  for (int c = threadIdx.x; c < pieces; c += THREADS)
    copy_async16(dst + sh + head + 4 * c, src + head + 4 * c);
  const int e = (int)threadIdx.x < head ? (int)threadIdx.x
                                        : 4 * pieces + (int)threadIdx.x;   // head, then tail
  if (e < n) copy_async(dst + sh + e, src + e);
}

// What a slot is, fixed for the whole march.
enum : int {
  IS_X = 1,        // owns an x face of the tile (rows 1 .. rows, any column)
  IS_Y = 2,        // owns a y face (rows 1 .. rows + 1, a cell column)
  IS_CELL = 4,     // a cell of the tile
  IS_HELD = 8,     // a cell of the tile or of a halo row that holds data
  FIRST = 16,      // column 0: the west donor lies across the boundary
  LAST = 32,       // column nx: the east "donor" cell lies across it
  SOUTH = 64,      // row 1: the south donor is halo row 0
  NORTH = 128,     // row rows + 1: the north donor is that halo row
};

// One RK stage of one tracer on one tile of rows, marching in k.  Each
// thread owns CPT slots and computes all of them alike, without branches on
// what a slot is (so that the compiler interleaves the slots' work); only
// the stores look at the slot's flags.
//   PLAIN:   high-order fluxes, update.
//   FACTOR:  r_lo on chip, renormalised low-order and antidiffusive fluxes,
//            r_hi to device memory.
//   LIMITED: r_lo on chip again, r_hi from device memory, limited fluxes,
//            update.
template <int MODE, int CPT>
__global__ void __launch_bounds__(THREADS, resident(MODE)) stage_kernel(Args a, int clip) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool PD = MODE != PLAIN;
  constexpr int QA = q_ahead(MODE), QR = QA + 2, VA = v_ahead(MODE), VR = VA + 1;
  const int nx = a.nx, ny = a.ny, nz = a.nz, w = nx + 1;
  const int px = nx + 2 * PAD, pyx = (ny + 2 * PAD) * px, nyx = ny * nx;
  const int j0 = (blockIdx.x % a.tiles) * a.ty;
  const int t = blockIdx.x / a.tiles;
  const int rows = min(a.ty, ny - j0);
  const Layout l = layout(MODE, a.ty, nx, CPT * THREADS);
  float* const qs = smem + l.q;
  float* const rus = smem + l.ru;
  float* const rvs = smem + l.rv;
  float* const rls = smem + l.rl;
  float* const rhs = smem + l.rh;
  float* const fxs = smem + l.fx;
  float* const fys = smem + l.fy;
  const float* const q_t = a.q + (size_t)t * nz * pyx + (size_t)j0 * px;
  const float* const ru_t = a.ru + (size_t)(j0 + 2) * px;   // one halo row below the tile
  const float* const rv_t = a.rv + (size_t)(j0 + 2) * px;
  const float* const phi_t = a.phi + (size_t)t * nz * nyx;
  const float* const pt_t = a.pt == nullptr ? nullptr : a.pt + (size_t)t * nz * nyx;
  float* const r_hi_t = PD ? a.r_hi + (size_t)t * nz * nyx : nullptr;
  float* const out_t = MODE != FACTOR ? a.out + (size_t)t * nz * nyx : nullptr;

  // a halo row outside the domain holds data only on a periodic boundary
  // (from the padding, or the far side); otherwise its factors are read at
  // the row of the tile (or the other halo row) that the boundary maps it to
  auto held = [&](int j) { return (j >= 0 && j < ny) || a.bcy == 0; };
  auto plane_row = [&](int j) { return (held(j) ? j : bc_map(j, ny, a.bcy)) - j0 + 1; };
  // donor slots across an edge, relative to the face's slot
  const int west_edge = bc_map(-1, nx, a.bcx);             // donor of face 0, flux > 0
  const int east_edge = bc_map(nx, nx, a.bcx) - nx;        // donor of face nx, flux <= 0
  const int south_edge = (plane_row(j0 - 1) - 1) * w;      // donor of row 1's face
  const int north_edge = (plane_row(j0 + rows) - (rows + 1)) * w;

  int flags[CPT], oq[CPT], og[CPT];
  float mu_f[CPT], mu_n[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int s = threadIdx.x + m * THREADS;
    const int rr = min(s / w, rows + 1), i = s - (s / w) * w, j = j0 + rr - 1;
    int f = 0;
    if (s < (rows + 2) * w) {
      const bool in_tile = rr >= 1 && rr <= rows;
      if (in_tile) f |= IS_X;
      if (rr >= 1 && i < nx) f |= IS_Y;
      if (in_tile && i < nx) f |= IS_CELL;
      if (i < nx && held(j)) f |= IS_HELD;
      if (i == 0) f |= FIRST;
      if (i == nx) f |= LAST;
      if (rr == 1) f |= SOUTH;
      if (rr == rows + 1) f |= NORTH;
    }
    flags[m] = f;
    oq[m] = (rr + 2) * px + i + PAD;       // a slot past the last row reads that row's q
    og[m] = (f & IS_HELD) ? bc_map(j, ny, a.bcy) * nx + i : 0;
    mu_f[m] = (f & IS_CELL) && MODE != FACTOR && pt_t != nullptr ? a.mu_full[og[m]] : 0.0f;
    mu_n[m] = (f & IS_CELL) && MODE != FACTOR ? a.mu_new[og[m]] : 1.0f;
  }

  // plane `lev` of a ring, where its copy put element 0
  auto q_at = [&](int lev) {
    return qs + (lev % QR) * l.qp + shift(q_t + (size_t)lev * pyx);
  };
  auto ru_at = [&](int lev) {       // indexed like q: two rows further down
    return rus + (lev % VR) * l.vp + shift(ru_t + (size_t)lev * pyx) - 2 * px;
  };
  auto rv_at = [&](int lev) {
    return rvs + (lev % VR) * l.vp + shift(rv_t + (size_t)lev * pyx) - 2 * px;
  };
  auto fetch_q = [&](int lev) {
    copy_plane(qs + (lev % QR) * l.qp, q_t + (size_t)lev * pyx, (rows + 2 * PAD) * px);
  };
  // mass fluxes of the tile's rows, one halo row below and two above
  auto fetch_v = [&](int lev) {
    copy_plane(rus + (lev % VR) * l.vp, ru_t + (size_t)lev * pyx, (rows + 3) * px);
    copy_plane(rvs + (lev % VR) * l.vp, rv_t + (size_t)lev * pyx, (rows + 3) * px);
  };

  // ---- before the march: the planes that the first iterations expect
  for (int lev = 0; lev < QA - 2 && lev < nz; ++lev) fetch_q(lev);
  for (int lev = 0; lev < VA - 2 && lev < nz; ++lev) fetch_v(lev);

  float ww_a[CPT], ww_b[CPT];    // omega at faces k+1 and k+2 of the slot's column
  float low_z[CPT];              // unscaled low-order flux, lower face of the next r_lo level
  float fz_lo[CPT], az_lo[CPT];  // flux (FACTOR: low and antidiffusive) at the lower face
#pragma unroll
  for (int m = 0; m < CPT; ++m)
    ww_a[m] = ww_b[m] = low_z[m] = fz_lo[m] = az_lo[m] = 0.0f;

  // Iterations k = -2, -1 only fetch and work ahead.
  for (int k = -2; k < nz; ++k) {
    copies_land();
    __syncthreads();
    if (k + QA >= 0 && k + QA < nz) fetch_q(k + QA);
    if (k + VA >= 0 && k + VA < nz) fetch_v(k + VA);
    float ww_n[CPT], phi_n[CPT], phi_0[CPT], pt_0[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int s = threadIdx.x + m * THREADS;
      if (MODE == LIMITED && k + 2 < nz && (flags[m] & IS_HELD))
        copy_async(rhs + ((k + 2) % R_RING) * l.sp + s, r_hi_t + (size_t)(k + 2) * nyx + og[m]);
      const int need = PD ? IS_HELD : IS_CELL;
      ww_n[m] = (flags[m] & need) && k + 3 >= 1 && k + 3 < nz
                    ? a.ww[(size_t)(k + 3) * nyx + og[m]] : 0.0f;
      phi_n[m] = PD && (flags[m] & IS_HELD) && k + 2 < nz
                     ? phi_t[(size_t)(k + 2) * nyx + og[m]] : 0.0f;
      const bool cell = k >= 0 && (flags[m] & IS_CELL);
      phi_0[m] = cell ? phi_t[(size_t)k * nyx + og[m]] : 0.0f;
      pt_0[m] = cell && MODE != FACTOR && pt_t != nullptr ? pt_t[(size_t)k * nyx + og[m]] : 0.0f;
    }

    float fz_up[CPT], az_up[CPT];
    if (k >= 0) {
      // ---- faces of level k
      const float* const qk = q_at(k);
      const float* const ruk = ru_at(k);
      const float* const rvk = rv_at(k);
      const float* const rlk = rls + (k % R_RING) * l.sp;
      const float* const rhk = rhs + (k % R_RING) * l.sp;
      const int kf = k + 1;
      const bool top = kf == nz;             // no flux through the model top
      const float* const q_m2 = q_at(max(kf - 2, 0));
      const float* const q_0 = q_at(min(kf, nz - 1));
      const float* const q_p1 = q_at(min(kf + 1, nz - 1));
      const float* const rlf = rls + (kf % R_RING) * l.sp;
      const float* const rhf = rhs + (kf % R_RING) * l.sp;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int s = threadIdx.x + m * THREADS, f = flags[m];
        const float* const q = qk + oq[m];
        {      // x face between cells i-1 and i
          const float vel = ruk[oq[m]];
          const float hi = flux5(vel, q[-3], q[-2], q[-1], q[0], q[1], q[2]);
          float flux = hi, anti = 0.0f;
          if (PD) {
            const int dw = (f & FIRST) ? west_edge : -1, de = (f & LAST) ? east_edge : 0;
            const float lo = flux1(vel, q[-1], q[0]);
            const float low = lo * rlk[s + (lo > 0.0f ? dw : de)];
            anti = hi - low;
            flux = MODE == FACTOR ? low : low + anti * rhk[s + (anti > 0.0f ? dw : de)];
          }
          if (f & IS_X) {
            fxs[s] = flux;
            if (MODE == FACTOR) fxs[l.sp + s] = anti;
          }
        }
        {      // y face between rows j-1 and j
          const float vel = rvk[oq[m]];
          const float hi = flux5(vel, q[-3 * px], q[-2 * px], q[-px], q[0], q[px], q[2 * px]);
          float flux = hi, anti = 0.0f;
          if (PD) {
            const int ds = (f & SOUTH) ? south_edge : -w, dn = (f & NORTH) ? north_edge : 0;
            const float lo = flux1(vel, q[-px], q[0]);
            const float low = lo * rlk[s + (lo > 0.0f ? ds : dn)];
            anti = hi - low;
            flux = MODE == FACTOR ? low : low + anti * rhk[s + (anti > 0.0f ? ds : dn)];
          }
          if (f & IS_Y) {
            fys[s] = flux;
            if (MODE == FACTOR) fys[l.sp + s] = anti;
          }
        }
        {      // z face k+1 above the cell: positive flux drains the upper cell k+1
          const float om = ww_a[m];
          const float hi = -flux3(-om, q_m2[oq[m]], q[0], q_0[oq[m]], q_p1[oq[m]]);
          float flux = hi, anti = 0.0f;
          if (PD) {
            const float lo = -flux1(-om, q[0], q_0[oq[m]]);
            const float low = lo * (lo > 0.0f ? rlf : rlk)[s];
            anti = hi - low;
            flux = MODE == FACTOR ? low : low + anti * (anti > 0.0f ? rhf : rhk)[s];
          }
          fz_up[m] = top ? 0.0f : flux;
          az_up[m] = top ? 0.0f : anti;
        }
      }
    }
    __syncthreads();

    if (k >= 0) {
      // ---- cells of level k
      const float rd = a.rdnw[k];
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int s = threadIdx.x + m * THREADS;
        const bool cell = flags[m] & IS_CELL;
        const size_t c = (size_t)k * nyx + og[m];
        const float div = divergence(fxs[s], fxs[s + 1], fys[s], fys[s + w], fz_lo[m],
                                     fz_up[m], rd, a);
        if (MODE == FACTOR) {
          const float phi_td = fmaxf(phi_0[m] + a.dts * div, 0.0f);
          const float r = factor(phi_td, fxs[l.sp + s], fxs[l.sp + s + 1], fys[l.sp + s],
                                 fys[l.sp + s + w], az_lo[m], az_up[m], rd, a);
          if (cell) r_hi_t[c] = r;
        } else {
          float tend = div;
          if (pt_t != nullptr) tend = tend + mu_f[m] * pt_0[m];
          float qn = (phi_0[m] + a.dts * tend) / mu_n[m];
          if (clip) qn = fmaxf(qn, 0.0f);
          if (cell) out_t[c] = qn;
        }
        fz_lo[m] = fz_up[m];
        az_lo[m] = az_up[m];
      }
    }

    if (PD && k + 2 < nz) {
      // ---- r_lo of level k+2 on the tile and its held halo rows
      const int lev = k + 2;
      const bool top = lev + 1 == nz;
      const float rd = a.rdnw[lev];
      const float* const ql = q_at(lev);
      const float* const qu = q_at(min(lev + 1, nz - 1));
      const float* const rul = ru_at(lev);
      const float* const rvl = rv_at(lev);
      float* const rl = rls + (lev % R_RING) * l.sp;
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        const int s = threadIdx.x + m * THREADS, o = oq[m];
        const float* const q = ql + o;
        const float zu = top ? 0.0f : -flux1(-ww_n[m], q[0], qu[o]);
        const float r = factor(fmaxf(phi_n[m], 0.0f), flux1(rul[o], q[-1], q[0]),
                               flux1(rul[o + 1], q[0], q[1]), flux1(rvl[o], q[-px], q[0]),
                               flux1(rvl[o + px], q[0], q[px]), low_z[m], zu, rd, a);
        if (flags[m] & IS_HELD) rl[s] = r;
        low_z[m] = zu;
      }
    }
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      ww_a[m] = ww_b[m];
      ww_b[m] = ww_n[m];
    }
  }
}

template <int MODE, int CPT>
int launch(Args a, int clip, cudaStream_t s) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stage_kernel<MODE, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the tallest tile whose slots the block's threads cover and that leaves
  // room for the mode's resident blocks on an SM, else the tallest that fits
  // at all (2 rows at least, so that a symmetric boundary's reflected row
  // stays in the tile or its halo); tiles of even height over ny
  const int least = a.ny > 1 ? 2 : 1;
  const int most = (a.ny + TY_MAX - 1) / TY_MAX;
  const int budgets[2] = {SMEM_SM / resident(MODE) - SMEM_RESERVED, SMEM_MAX};
  int ty = 0;
  for (int b = 0; b < 2 && ty < least; ++b)
    for (ty = (a.ny + most - 1) / most; ty >= least; --ty)
      if ((ty + 2) * (a.nx + 1) <= CPT * THREADS &&
          layout(MODE, ty, a.nx, CPT * THREADS).total * (int)sizeof(float) <= budgets[b])
        break;
  if (ty < least) return -1;           // the x row is too wide for a tile
  a.ty = ty;
  a.tiles = (a.ny + ty - 1) / ty;
  const size_t bytes = (size_t)layout(MODE, ty, a.nx, CPT * THREADS).total * sizeof(float);
  stage_kernel<MODE, CPT><<<(unsigned)a.tiles * (unsigned)a.nt, THREADS, bytes, s>>>(a, clip);
  return static_cast<int>(cudaGetLastError());
}

// Four slots a thread where a tile of two rows fits that way, else eight.
template <int MODE>
int launch_mode(const Args& a, int clip, cudaStream_t s) {
  const int err = launch<MODE, 4>(a, clip, s);
  return err == -1 ? launch<MODE, 8>(a, clip, s) : err;
}

}  // namespace

// Launches on `stream` (one grid without the limiter, two with it) and
// returns the first cudaGetLastError() that is not 0, or -1 when the x row
// is too wide for the shared memory of a block.  `pt` may be null; `r_hi`
// is (nt, nz, ny, nx) scratch, unused (may be null) without the limiter.
extern "C" int advect_tracers(const float* q, const float* phi, const float* pt,
                              const float* ru, const float* rv, const float* ww,
                              const float* mu_full, const float* mu_new,
                              const float* rdnw, float* r_hi, float* out,
                              int nt, int nz, int ny, int nx, float rdx, float rdy,
                              float dts, int pd, int clip, int bcx, int bcy,
                              void* stream) {
  const Args a{q, phi, pt, ru, rv, ww, mu_full, mu_new, rdnw, r_hi, out,
               nt, nz, ny, nx, bcx, bcy, 0, 0, rdx, rdy, dts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pd) return launch_mode<PLAIN>(a, clip, s);
  const int err = launch_mode<FACTOR>(a, clip, s);
  return err != 0 ? err : launch_mode<LIMITED>(a, clip, s);
}
