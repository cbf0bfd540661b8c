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
// On a map-projected grid an optional m2 (ny, nx), the squared map factor
// at mass points, scales the horizontal part of every divergence (-div L,
// -div F) and of every outflow sum of the limiter's factors, as the
// reference's flux_div(m_h = m2), limit_low_order and pd_limit do.  The
// TPU kernel has no map factor (the reference sends projected grids
// through its plain operators); with m2 null the flat kernels run,
// instruction for instruction as before (a template parameter).
//
// Shapes (float32, contiguous): q (nt, nz, ny+6, nx+6) padded by the
// lateral boundary rule; phi_old, pt, out and the seam grids' r_hi (nt, nz,
// ny, nx);
// ru, rv (nz, ny+6, nx+6); ww (nz+1, ny, nx); mu_full, mu_new (ny, nx);
// rdnw (nz,); m2 (ny, nx) or null.
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
// Design: shared-memory planes, fixed slots and a march in z.  Two grids:
// without the limiter (`stage_kernel<PLAIN>`, RK stages 1 and 2) and the
// limited stage (`limited_kernel`, the final stage), one launch a call each;
// at the seams of a process mesh the limiter's two grids (`stage_kernel<
// FACTOR / LIMITED, RING>`, below).
//
// - A block owns a tile of rows over the whole x row (or an x tile of the
//   row) for one tracer and marches in k.  Each thread owns a few slots for
//   the whole march, so what a slot is (its flags) and where it reads (its
//   offsets) is worked out once.  Planes of q, ru and rv come by
//   asynchronous copy (cp.async), started an iteration before their use,
//   into rings in shared memory.  A plane lands shifted by up to 3 floats,
//   so that source and destination are 16-byte aligned alike and the copy
//   goes in 16-byte pieces; an x tile's rows lie at a pitch congruent to the
//   padded row's modulo 4 floats, so that one shift aligns every row.  Each
//   face flux is computed once per grid.
// - Without the limiter: 256 threads of 4 slots, the (ty + 2) x (nx + 1)
//   points of the tile with a one-row halo and one more column (x tiles:
//   (ty + 2) x (tx + 2)); slot (rr, i) is cell (j0 + rr - 1, i), its west x
//   face and its south y face.  Every slot is computed alike, without
//   branches, so that the compiler interleaves the slots' work; only the
//   stores look at the flags.  Three blocks an SM.  The plan (`make_plan`):
//   one tile over the row where a tile of two rows spans it (255 cells),
//   else x tiles (8 x 100 at config 5's 500 x 500 block).
//
// The limited stage in one grid.  The limiter's factors are those of the
// donor cells: a face's low-order flux is scaled by its donor's r_lo, its
// antidiffusive flux by its donor's r_hi, and r_hi of a cell needs the
// fluxes of all its faces.  So the update of a tile needs r_hi on the tile
// and a 1-cell ring, the fluxes on those cells' faces, r_lo on a 2-cell
// ring, and q on a 4-cell ring (the ring's outer faces read 3 cells past
// them).  The TPU kernel forms the factors in the kernel on its extended
// region (halos of 4); this grid does the same on chip, each quantity once
// a level, and nothing of the limiter leaves the chip:
//
// - Slots: the tile and its 2-cell ring, (ty + 4) x (tx + 4) with x tiles,
//   (ty + 4) x (nx + 1) over the row (its x edges map every donor onto the
//   row, so it needs no x ring); slot (rr, c) is cell (j0 + rr - 2, i0 + c
//   - 2) and owns that cell's west x face and south y face.  512 threads of
//   2 slots, one block of 16 warps an SM.
// - March iteration k: (A) the x and y faces of level k on the tile and its
//   1-ring, low-order fluxes scaled by their donors' r_lo(k) and the
//   antidiffusive ones, into shared memory; r_lo(k+1) on the 2-ring, into a
//   ring of two planes; the z face k+1 of the 1-ring's cells, low-order and
//   antidiffusive, in registers (its unscaled low-order flux is r_lo(k)'s
//   upper face, kept from the iteration before); (B) r_hi(k) on the 1-ring
//   into a plane, and the limited z face k, whose donors are the slot's own
//   r_hi(k-1) and r_hi(k); (C) the limited x and y faces of level k from the
//   donors' r_hi(k), their part of the divergence of level k (kept), and
//   the update of level k-1, whose upper z face B has just limited.  The
//   update trails the factors by a level: the march runs k = -1 (r_lo(0)
//   only) to nz (the update of level nz - 1 only).  Three barriers a level.
//   Rings: q planes k-1 .. k+3, ru and rv k .. k+2.  The slots' own omega,
//   phi_old and pt are loaded into registers at the top of an iteration.
// - The ring's work by whole warps: a slot's phases branch on what the slot
//   is, and a warp's 32 slots are a run of a slot row, so where a phase has
//   nothing for a ring row (faces in row 0, r_hi in rows 0 and ty + 3, the
//   update outside the tile) whole warps skip it; at config 5's 28 x 28
//   tiles (rows of 32 slots) that is 1, 2 and 4 of the 32 warp steps of
//   those phases.  Ring columns are idle lanes.
// - Domain edges: where a side holds no data (open, symmetric, specified)
//   a donor beyond it is read through the boundary's index map (`bc_map`)
//   at a cell of the tile or its 1-ring, whose factors the grid formed, and
//   the ring's cells there are not computed.  Beyond a periodic side the
//   ring's cells hold the far side's data, and their fluxes read q 4 cells
//   past the edge, one more than the stack's pad of 3.  That 4th row and
//   column is read through the index map, from the wrapped cell of the
//   padded array (`fetch_q_plane`), in the tiles that touch a periodic
//   edge.  So the stack keeps its pad of 3 and every caller its shapes, and
//   the cost falls on those tiles' planes alone (one row or column, 4-byte
//   copies); padding the limited call's stack by 4, the TPU kernel's K = 4,
//   would cost every call a pass over the stack.
// - Plan (`lim_plan`): of the tiles whose slots the block covers and whose
//   shared memory fits an SM, the one that holds the most cells, its height
//   even over ny and its width over nx: x tiles of 28 x 28 at config 5's
//   block (784 cells in 1,024 slots, 93 KB), 20 x 34 at 100 x 100, one tile
//   over the row of 13 rows at 50 x 50.
// - Registers: 120-128 of the 128 that 512 threads an SM allow, no spills
//   (`tracers_kernel.plan`).  The margin is thin, and what the compiler
//   keeps live is not what the source says: each of these variants, alone
//   or with others, moved some instance past 128 and spilled, and ran
//   slower: two blocks of 8 warps an SM at 4 slots a thread (2.8x at
//   config 5's block on an NVIDIA H100, `scripts/k4_limited_probe.py`);
//   the slots' omega, phi_old and pt staged by cp.async through shared
//   memory, or loaded a phase ahead, or reloaded from the cache; mu and m2
//   kept in shared memory; the copies issued after phase A; the 4th ring's
//   walk over the plane's borders alone in the one-tile instances.
//
// Tried on the card and dropped: two tracers a block sharing ru, rv and ww
// (the block's shared memory doubles: slower); a ninth warp that only
// fetches planes (the compute warps' registers shrink); bulk copies
// (cp.async.bulk) of an x tile's rows (3.4% on the limited stage's former
// two grids, for an mbarrier protocol the CPU emulation cannot check); the
// limited stage as two grids, the first writing r_hi to device memory and
// the second reading it back, both forming r_lo and the high-order fluxes;
// in this grid, the variants above and other shapes of a block (256 threads
// of 2 slots at two blocks an SM: tiles of 18 x 19; 384 threads of 3).
//
// Seams (a block of a process mesh).  Each side of the block has an edge
// code: the domain's boundary kind, or SEAM where a neighbouring block
// lies (a periodic axis split over several blocks has seams on both
// sides).  Without the limiter a seam changes nothing: the grid reads only
// its padded inputs, whose halos the exchange filled.  With it, a face at
// a seam needs the factors of the neighbour's edge cells.  Two designs
// were open: (b) the TPU kernel's, halos of 4 (q, ru, rv) and 2 (phi, ww)
// and r_hi formed on the seam ring in grid FACTOR; or (a) the reference
// plain path's, which exchanges both factor rings (hx.pad(r, 1)).  This
// kernel takes (a) (`advect_tracers_seam`, the RING instances): phi, ww
// and m2 come with their exchanged one-cell ring, so grid FACTOR forms r_lo
// on the seam rings from the neighbours' true values exactly as the
// neighbour does on its own cells; the caller exchanges the one-cell ring
// of grid FACTOR's r_hi, and grid LIMITED reads it.  Why (a): (b) needs the
// neighbour's q, ru and rv 4 cells past the seam, a wider halo exchange of
// the whole stack on every limited stage, where (a) costs an exchange of an
// nt x nz x perimeter ring per limited stage (and the rings of phi_old, ww
// and m2).  The one-block limited grid is (b) on its own block, whose
// edges are the domain's, and a seam is refused there.  The RING
// instances always run on the grid of x tiles (the plan's x-tile sizing),
// whose slots carry a halo column on each side, and read phi, ww, m2 and
// the ring of r_hi at a held slot's own place in the (ny+2) x (nx+2)
// layout.
//
// Arithmetic: every operation follows the plain PyTorch version
// (ops/tracers_kernel.py::advect_tracers_reference) in order, and the
// library is built with --fmad=false, so the two round alike.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 3;
constexpr int THREADS = 256;
constexpr int CPT = 4;                    // slots a thread
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
  const float* m2;       // may be null (flat grid)
  float* r_hi;           // the seam grids: written by FACTOR
  const float* r_ring;   // RING: r_hi with its exchanged one-cell ring, read by LIMITED
  float* out;
  int nt, nz, ny, nx;
  int edge[4];           // west, east, south, north: an Edge
  int ty, tiles;         // rows of a tile, tiles over y
  int tx, xtiles;        // x tiles: cells of a tile, tiles over x (XT)
  int pitch, ulog;       // XT: row pitch of a plane, log2 of copy units a row (of q)
  int vlog;              // the limited grid's x tiles: log2 of copy units a row of ru, rv
  float rdx, rdy, dts;
};

// Shared-memory layout in floats, the same on host and device.  A block's
// slots are the (ty + 2) x (nx + 1) points of its tile with a one-row halo
// and one more column: slot (rr, i) is cell (j0 + rr - 1, i), its west x
// face and its south y face.  With x tiles of tx cells (`xt`) they are the
// (ty + 2) x (tx + 2) points of the tile with a one-row and a one-column
// halo, and a plane's rows lie `pitch` floats apart.  Every plane starts on
// a 16-byte boundary and has room for the shift of up to 3 floats that lets
// its copy from device memory go in 16-byte pieces.  A thread computes
// every kind of flux for every slot it owns and stores only what the slot
// is, so a read may fall a row before the first q plane (`lead`) or a few
// slots after the last plane (`tail`): both are inside the block's
// allocation.
struct Layout {
  int qp, vp, sp;                   // q plane, ru/rv plane, slot plane
  int q, ru, rv, rl, rh, fx, fy;    // offsets
  int total;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Layout layout(int mode, int ty, int nx, int slots, bool xt = false,
                                         int tx = 0, int pitch = 0) {
  Layout l;
  const int px = xt ? pitch : nx + 2 * PAD, w = xt ? tx + 2 : nx + 1;
  l.qp = round4((ty + 2 * PAD) * px + 3);
  l.vp = round4((ty + 3) * px + 3);
  l.sp = round4((ty + 2) * w);
  l.q = round4(px);                                  // lead
  l.ru = l.q + (q_ahead(mode) + 2) * l.qp;
  l.rv = l.ru + (v_ahead(mode) + 1) * l.vp;
  l.rl = l.rv + (v_ahead(mode) + 1) * l.vp;
  l.rh = l.rl + (mode != PLAIN ? R_RING * l.sp : 0);
  l.fx = l.rh + (mode == LIMITED ? R_RING * l.sp : 0);
  l.fy = l.fx + (mode == FACTOR ? 2 : 1) * l.sp;     // FACTOR keeps L and A apart
  l.total = l.fy + (mode == FACTOR ? 2 : 1) * l.sp + round4(slots - l.sp + w + 1);   // tail
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

// What lies beyond a side of the block: the domain's lateral boundary
// (periodic, open or symmetric; specified takes open), or a SEAM with
// the neighbouring block of a process mesh.
enum Edge : int { PERIODIC = 0, OPEN = 1, SYMMETRIC = 2, SEAM = 3 };

// Whether the cells beyond a side hold data of their own (a periodic wrap
// or a neighbouring block) rather than a mapped copy of the block's own.
__host__ __device__ __forceinline__ bool edge_held(int e) { return e == PERIODIC || e == SEAM; }

// Cell index c in [-1, n] of a boundary-padded axis -> interior cell, by
// the edge code of the side it lies beyond (lo for c < 0, else hi).  Not
// called for a seam.
__host__ __device__ __forceinline__ int bc_map(int c, int n, int lo, int hi) {
  if (c >= 0 && c < n) return c;
  const int e = c < 0 ? lo : hi;
  if (e == PERIODIC) return c < 0 ? c + n : c - n;     // wrap
  if (e == OPEN) return c < 0 ? 0 : n - 1;             // replicate the edge
  return c < 0 ? -c : 2 * (n - 1) - c;                 // symmetric: reflect
}

// Limiter factor: min(1, avail / outflow) where there is outflow, else 1;
// m2 scales the horizontal outflow (MSF).
template <bool MSF>
__device__ __forceinline__ float factor(float avail, float xl, float xr, float yl,
                                        float yr, float zl, float zu, float rdnw, float m2,
                                        const Args& a) {
  const float out_x = fmaxf(xr, 0.0f) - fminf(xl, 0.0f);
  const float out_y = fmaxf(yr, 0.0f) - fminf(yl, 0.0f);
  const float up_c = -zu * rdnw;
  const float lo_c = zl * rdnw;
  const float out_z = fmaxf(-up_c, 0.0f) + fmaxf(-lo_c, 0.0f);
  float out_h = out_x * a.rdx + out_y * a.rdy;
  if (MSF) out_h = m2 * out_h;
  const float p_out = a.dts * (out_h + out_z);
  return p_out > 0.0f ? fminf(avail / fmaxf(p_out, 1e-30f), 1.0f) : 1.0f;
}

template <bool MSF>
__device__ __forceinline__ float divergence(float xl, float xr, float yl, float yr,
                                            float zl, float zu, float rdnw, float m2,
                                            const Args& a) {
  float hdiv = (xr - xl) * a.rdx + (yr - yl) * a.rdy;
  if (MSF) hdiv = m2 * hdiv;
  return -(hdiv + (zu - zl) * rdnw);
}

// Asynchronous copies from device to shared memory; they have landed for
// every thread of the block after `copies_land` and a barrier.  A copy
// takes its destination's shared-memory address beside its pointer: the
// block's shared memory is converted once (`smem_base`) and a copy adds 4
// bytes a float to it (converting each destination reads, on sm_90, the
// block's cluster rank every time).  The pointer serves a host build.
__device__ __forceinline__ unsigned smem_base(const float* p) {
  unsigned a = 0;
  a = (unsigned)__cvta_generic_to_shared(p);
  return a;
}
__device__ __forceinline__ void copy4_at(unsigned sa, float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sa), "l"(src) : "memory");
}
__device__ __forceinline__ void copy16_at(unsigned sa, float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_land() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
__device__ __forceinline__ int shift(const float* src) {
  return (int)(((size_t)src >> 2) & 3);
}
// A contiguous piece of n >= 4 floats goes to a 16-byte aligned plane dst
// (shared address sd) in 16-byte copies: element e lands at dst[shift(src)
// + e], so that source and destination are aligned alike; the few floats
// before the first and after the last 16-byte boundary go one by one.  NT:
// the block's threads.
template <int NT = THREADS>
__device__ __forceinline__ void plane_to(unsigned sd, float* dst, const float* src, int n) {
  const int sh = shift(src), head = (4 - sh) & 3, pieces = (n - head) >> 2;
  for (int c = threadIdx.x; c < pieces; c += NT) {
    const int e = sh + head + 4 * c;
    copy16_at(sd + 4 * e, dst + e, src + head + 4 * c);
  }
  const int e = (int)threadIdx.x < head ? (int)threadIdx.x
                                        : 4 * pieces + (int)threadIdx.x;   // head, then tail
  if (e < n) copy4_at(sd + 4 * (sh + e), dst + sh + e, src + e);
}

// n rows of len floats, row r from src + r * spitch to a plane whose rows
// are dpitch apart (dpitch = spitch modulo 4): element e of row r lands at
// dst[shift(src) + r * dpitch + e], so that every row's source and
// destination are aligned alike, and goes in 16-byte pieces but for the few
// floats before the row's first and after its last 16-byte boundary.  Each
// row takes 1 << ulog units of work (pieces, then head and tail floats).
template <int NT = THREADS>
__device__ __forceinline__ void rows_to(unsigned sd, float* dst, const float* src, int n, int len,
                                        int spitch, int dpitch, int ulog) {
  const int sh = shift(src);
  for (int c = threadIdx.x; c < (n << ulog); c += NT) {
    const int r = c >> ulog, u = c & ((1 << ulog) - 1);
    const float* const s = src + (size_t)r * spitch;
    const int head = (4 - shift(s)) & 3, pieces = (len - head) >> 2, d = sh + r * dpitch;
    if (u < pieces) {
      const int e = head + 4 * u;
      copy16_at(sd + 4 * (d + e), dst + d + e, s + e);
    } else {
      const int k = u - pieces, e = k < head ? k : 4 * pieces + k;
      if (e < len) copy4_at(sd + 4 * (d + e), dst + d + e, s + e);
    }
  }
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

// One RK stage of one tracer on one tile of rows, marching in k: the grid
// without the limiter, and the two grids of the limited stage at seams.
// Each thread owns CPT slots and computes all of them alike, without
// branches on what a slot is (so that the compiler interleaves the slots'
// work); only the stores look at the slot's flags.
//   PLAIN:   high-order fluxes, update.
//   FACTOR:  (seams) r_lo on chip, renormalised low-order and antidiffusive
//            fluxes, r_hi to device memory.
//   LIMITED: (seams) r_lo on chip again, r_hi's ring from device memory,
//            limited fluxes, update.
// XT: the tile is one of a.xtiles x tiles of the row (its planes carry the
// x halo and a row pitch of their own); else it spans the row.  MSF: a.m2
// scales the horizontal divergences and outflows.  RING (the limiter's
// grids, always with XT): phi, ww and m2 carry a one-cell ring, (ny+2) x
// (nx+2) a plane, and LIMITED reads r_hi from a.r_ring, laid out alike;
// every cell that holds data (the block's, and its halo ring beyond a
// periodic side or a seam) reads them at its own place in the ring layout.
template <int MODE, bool XT, bool MSF, bool RING>
__global__ void __launch_bounds__(THREADS, resident(MODE)) stage_kernel(Args a, int clip) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool PD = MODE != PLAIN;
  static_assert(!PD || (XT && RING), "one block's limited stage is limited_kernel");
  constexpr int QA = q_ahead(MODE), QR = QA + 2, VA = v_ahead(MODE), VR = VA + 1;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int px = nx + 2 * PAD, pyx = (ny + 2 * PAD) * px, nyx = ny * nx;
  const int hyx = RING ? (ny + 2) * (nx + 2) : nyx;      // a plane of phi, ww, r_ring
  const int j0 = (blockIdx.x % a.tiles) * a.ty;
  const int t = XT ? blockIdx.x / a.tiles / a.xtiles : blockIdx.x / a.tiles;
  const int i0 = XT ? (blockIdx.x / a.tiles % a.xtiles) * a.tx : 0;
  const int tw = XT ? min(a.tx, nx - i0) : nx;       // cells of the tile's rows
  const int w = XT ? tw + 2 : nx + 1;                // slots of a slot row
  const int pp = XT ? a.pitch : px;                  // row pitch of a plane
  const int rows = min(a.ty, ny - j0);
  const Layout l = layout(MODE, a.ty, nx, CPT * THREADS, XT, a.tx, a.pitch);
  float* const qs = smem + l.q;
  float* const rus = smem + l.ru;
  float* const rvs = smem + l.rv;
  float* const rls = smem + l.rl;
  float* const rhs = smem + l.rh;
  float* const fxs = smem + l.fx;
  float* const fys = smem + l.fy;
  const float* const q_t = a.q + (size_t)t * nz * pyx + (size_t)j0 * px + i0;
  const float* const ru_t = a.ru + (size_t)(j0 + 2) * px + i0;   // one halo row below the tile
  const float* const rv_t = a.rv + (size_t)(j0 + 2) * px + i0;
  const float* const phi_t = a.phi + (size_t)t * nz * hyx;
  const float* const pt_t = a.pt == nullptr ? nullptr : a.pt + (size_t)t * nz * nyx;
  float* const r_hi_t = PD ? a.r_hi + (size_t)t * nz * nyx : nullptr;
  const float* const r_in_t = MODE != LIMITED ? nullptr : a.r_ring + (size_t)t * nz * hyx;
  float* const out_t = MODE != FACTOR ? a.out + (size_t)t * nz * nyx : nullptr;

  const int e_w = a.edge[0], e_e = a.edge[1], e_s = a.edge[2], e_n = a.edge[3];
  // a halo row outside the block holds data only beyond a periodic side
  // (from the padding, or the far side) or a seam; otherwise its factors
  // are read at the row of the tile (or the other halo row) that the
  // boundary maps it to
  auto held = [&](int j) { return (j >= 0 && j < ny) || edge_held(j < 0 ? e_s : e_n); };
  auto plane_row = [&](int j) { return (held(j) ? j : bc_map(j, ny, e_s, e_n)) - j0 + 1; };
  // donor slots across an edge, relative to the face's slot
  const int west_edge = bc_map(-1, nx, e_w, e_e);          // donor of face 0, flux > 0
  const int east_edge = bc_map(nx, nx, e_w, e_e) - nx;     // donor of face nx, flux <= 0
  const int south_edge = (plane_row(j0 - 1) - 1) * w;      // donor of row 1's face
  const int north_edge = (plane_row(j0 + rows) - (rows + 1)) * w;
  // x tiles: slot column c is cell i0 + c - 1; its halo columns hold data
  // inside the block or beyond a periodic side or a seam, and only the
  // block's other edges map a donor through the boundary
  const bool west_mapped = XT && !edge_held(e_w), east_mapped = XT && !edge_held(e_e);

  // og: a cell's index in the (ny, nx) arrays (without RING also a held
  // halo slot's mapped cell); oh (RING): a held slot's index in the ring
  // layout, where phi, ww, m2 and the read r_hi are (`hidx`, below).
  int flags[CPT], oq[CPT], og[CPT], oh[RING ? CPT : 1] = {};
  float mu_f[CPT], mu_n[CPT], m2s[CPT];
#pragma unroll
  for (int m = 0; m < CPT; ++m) {
    const int s = threadIdx.x + m * THREADS;
    const int rr = min(s / w, rows + 1), c = s - (s / w) * w, j = j0 + rr - 1;
    const int i = XT ? i0 + c - 1 : c;
    int f = 0;
    if (s < (rows + 2) * w) {
      const bool in_tile = rr >= 1 && rr <= rows;
      const bool cell_col = XT ? c >= 1 && c <= tw : i < nx;
      const bool held_col = XT ? (i >= 0 && i < nx) || edge_held(i < 0 ? e_w : e_e) : i < nx;
      if (in_tile && (!XT || c >= 1)) f |= IS_X;
      if (rr >= 1 && cell_col) f |= IS_Y;
      if (in_tile && cell_col) f |= IS_CELL;
      if (held_col && held(j)) f |= IS_HELD;
      if (XT ? west_mapped && i == 0 && c == 1 : i == 0) f |= FIRST;
      if (XT ? east_mapped && i == nx && c == tw + 1 : i == nx) f |= LAST;
      if (rr == 1) f |= SOUTH;
      if (rr == rows + 1) f |= NORTH;
    }
    flags[m] = f;
    // a slot past the last row reads that row's q
    oq[m] = XT ? (rr + 2) * pp + c + 2 : (rr + 2) * px + i + PAD;
    if (RING) {
      og[m] = (f & IS_CELL) ? j * nx + i : 0;
      oh[m] = (f & IS_HELD) ? (j + 1) * (nx + 2) + i + 1 : 0;
    } else {
      og[m] = (f & IS_HELD) ? bc_map(j, ny, e_s, e_n) * nx + (XT ? bc_map(i, nx, e_w, e_e) : i)
                            : 0;
    }
    mu_f[m] = (f & IS_CELL) && MODE != FACTOR && pt_t != nullptr ? a.mu_full[og[m]] : 0.0f;
    mu_n[m] = (f & IS_CELL) && MODE != FACTOR ? a.mu_new[og[m]] : 1.0f;
    m2s[m] = MSF && (f & IS_HELD) ? a.m2[RING ? oh[m] : og[m]] : 1.0f;
  }
  auto hidx = [&](int m) { return RING ? oh[m] : og[m]; };

  // plane `lev` of a ring, where its copy put element 0
  auto q_at = [&](int lev) {
    return qs + (lev % QR) * l.qp + shift(q_t + (size_t)lev * pyx);
  };
  auto ru_at = [&](int lev) {       // indexed like q: two rows further down
    return rus + (lev % VR) * l.vp + shift(ru_t + (size_t)lev * pyx) - 2 * pp;
  };
  auto rv_at = [&](int lev) {
    return rvs + (lev % VR) * l.vp + shift(rv_t + (size_t)lev * pyx) - 2 * pp;
  };
  const unsigned sbase = smem_base(smem);
  auto fetch = [&](float* dst, const float* src, int n) {
    const unsigned sd = sbase + 4 * (unsigned)(dst - smem);
    if (XT) rows_to(sd, dst, src, n, tw + 2 * PAD, px, pp, a.ulog);
    else plane_to(sd, dst, src, n * px);
  };
  auto fetch_q = [&](int lev) {
    fetch(qs + (lev % QR) * l.qp, q_t + (size_t)lev * pyx, rows + 2 * PAD);
  };
  // mass fluxes of the tile's rows, one halo row below and two above
  auto fetch_v = [&](int lev) {
    fetch(rus + (lev % VR) * l.vp, ru_t + (size_t)lev * pyx, rows + 3);
    fetch(rvs + (lev % VR) * l.vp, rv_t + (size_t)lev * pyx, rows + 3);
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
      if (MODE == LIMITED && k + 2 < nz && (flags[m] & IS_HELD)) {
        float* const d = rhs + ((k + 2) % R_RING) * l.sp + s;
        copy4_at(sbase + 4 * (unsigned)(d - smem), d, r_in_t + (size_t)(k + 2) * hyx + hidx(m));
      }
      const int need = PD ? IS_HELD : IS_CELL;
      ww_n[m] = (flags[m] & need) && k + 3 >= 1 && k + 3 < nz
                    ? a.ww[(size_t)(k + 3) * hyx + hidx(m)] : 0.0f;
      phi_n[m] = PD && (flags[m] & IS_HELD) && k + 2 < nz
                     ? phi_t[(size_t)(k + 2) * hyx + hidx(m)] : 0.0f;
      const bool cell = k >= 0 && (flags[m] & IS_CELL);
      phi_0[m] = cell ? phi_t[(size_t)k * hyx + hidx(m)] : 0.0f;
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
          const float hi = flux5(vel, q[-3 * pp], q[-2 * pp], q[-pp], q[0], q[pp], q[2 * pp]);
          float flux = hi, anti = 0.0f;
          if (PD) {
            const int ds = (f & SOUTH) ? south_edge : -w, dn = (f & NORTH) ? north_edge : 0;
            const float lo = flux1(vel, q[-pp], q[0]);
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
        const float div = divergence<MSF>(fxs[s], fxs[s + 1], fys[s], fys[s + w], fz_lo[m],
                                          fz_up[m], rd, m2s[m], a);
        if (MODE == FACTOR) {
          const float phi_td = fmaxf(phi_0[m] + a.dts * div, 0.0f);
          const float r = factor<MSF>(phi_td, fxs[l.sp + s], fxs[l.sp + s + 1], fys[l.sp + s],
                                      fys[l.sp + s + w], az_lo[m], az_up[m], rd, m2s[m], a);
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
      // ---- r_lo of level k+2 on the tile and its held halo rows (and columns)
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
        const float r = factor<MSF>(fmaxf(phi_n[m], 0.0f), flux1(rul[o], q[-1], q[0]),
                                    flux1(rul[o + 1], q[0], q[1]), flux1(rvl[o], q[-pp], q[0]),
                                    flux1(rvl[o + pp], q[0], q[pp]), low_z[m], zu, rd, m2s[m],
                                    a);
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

// ---- The limited stage of one block: one grid (`limited_kernel`; the file's
// header states its design).
constexpr int SLOTS = CPT * THREADS;      // a block's slots (grid without the limiter)
constexpr int L_THREADS = 512;            // the limited grid's threads a block,
constexpr int L_CPT = 2;                  // slots a thread,
constexpr int L_SLOTS = L_CPT * L_THREADS;  // slots a block,
constexpr int L_RESIDENT = 1;             // and blocks meant to share an SM
constexpr int L_QR = 5;                   // q planes k-1 .. k+3
constexpr int L_VR = 3;                   // ru and rv planes k .. k+2

// Shared memory of the limited grid, in floats.  Every plane has the row
// pitch pp (the padded row's, or with x tiles one congruent to it modulo 4
// floats).  A q plane holds the padded rows j0 - 1 .. j0 + rows + 6 (4
// cells past the tile's rows: the y faces of its 1-ring read 3 past their
// cells), with x tiles the padded columns i0 - 1 .. i0 + tw + 6; ru and rv
// planes the padded rows j0 + 1 .. j0 + rows + 5, with x tiles the columns
// i0 + 1 .. i0 + tw + 5; a slot plane the tile's (rows + 4) slot rows and
// one more, which faces read past the last.
struct LimLayout {
  int qp, vp, sp;                              // q plane, ru/rv plane, slot plane
  int q, ru, rv, rl, lx, ax, ly, ay, rh;       // offsets: r_lo (2 levels), low and
  int total;                                   // antidiffusive x and y fluxes, r_hi
};

__host__ __device__ inline LimLayout lim_layout(int ty, int pp) {
  LimLayout l;
  l.qp = round4((ty + 8) * pp + 3);
  l.vp = round4((ty + 5) * pp + 3);
  l.sp = round4((ty + 5) * pp);
  l.q = round4(pp);                            // lead
  l.ru = l.q + L_QR * l.qp;
  l.rv = l.ru + L_VR * l.vp;
  l.rl = l.rv + L_VR * l.vp;
  l.lx = l.rl + 2 * l.sp;
  l.ax = l.lx + l.sp;
  l.ly = l.ax + l.sp;
  l.ay = l.ly + l.sp;
  l.rh = l.ay + l.sp;
  l.total = l.rh + l.sp + round4(pp + 4);      // tail
  return l;
}

// What a slot of the limited grid is, fixed for the whole march.
enum : int {
  L_FACE = 1,          // owns faces that a cell of the tile or its 1-ring reads
  L_HELD = 2,          // a cell that holds data (the block's, or beyond a periodic side)
  L_R1 = 4,            // ... of the tile or its 1-ring: its r_hi is formed
  L_CELL = 8,          // a cell of the tile: it is updated
  L_WEST = 16,         // cell column 0: its x face's west donor is mapped
  L_EAST = 32,         // cell column nx: its x face's east donor is mapped
  L_EAST_CELL = 64,    // cell column nx - 1: the east donor of its east face is mapped
  L_SOUTH = 128,       // cell row 0: its y face's south donor is mapped
  L_NORTH = 256,       // cell row ny: its y face's north donor is mapped
  L_NORTH_CELL = 512,  // cell row ny - 1: the north donor of its north face is mapped
};

__host__ __device__ __forceinline__ int wrap(int c, int n) { return ((c % n) + n) % n; }

// (address of base in floats + off) modulo 4: where element 0 of a plane
// that starts off floats past base lands in its 16-byte aligned buffer.
__device__ __forceinline__ int shift_at(const float* base, long long off) {
  return (int)((((size_t)base >> 2) + (size_t)off) & 3);
}

// Plane `base` (one level of one tracer of the padded q) into dst (shared
// address sd): rows r = 0 .. nr - 1 of padded rows j0 - 1 + r, columns e =
// 0 .. len - 1 of padded columns c0 + e, element (r, e) at dst[shift + r *
// pp + e].  Padded rows and columns that the array does not have (the 4th
// cell past the domain's edge) come from the wrapped cell beyond a
// periodic side (wy, wx) and are not fetched otherwise.  The array lacks at
// most the plane's first and last row and (x tiles) column.  With x tiles
// the loop walks just those (units 0 .. 2 len - 1 the two rows, the rest
// the two columns; a corner may come twice, the same value); over the row
// it walks the plane and skips what the array has: the shorter walk there
// takes the one-tile instances past their 128 registers.
__device__ void fetch_q_plane(unsigned sd, float* dst, const float* base, int j0, int c0, int nr,
                              int len, int px, int py, int pp, int ulog, bool xt, int ny, int nx,
                              bool wy, bool wx) {
  const int sh = shift_at(base, (long long)(j0 - 1) * px + c0);
  const int r_lo = max(0, 1 - j0), r_hi = min(nr, py + 1 - j0);   // rows the array has
  const int e_lo = max(0, -c0), e_hi = min(len, px - c0);        // columns it has
  const float* const src = base + (size_t)(j0 - 1 + r_lo) * px + c0 + e_lo;
  const int d = sh + r_lo * pp + e_lo - shift(src);              // 16-byte aligned
  if (xt) rows_to<L_THREADS>(sd + 4 * d, dst + d, src, r_hi - r_lo, e_hi - e_lo, px, pp, ulog);
  else plane_to<L_THREADS>(sd + 4 * d, dst + d, src, (r_hi - r_lo) * px);
  if (!((wy && (r_lo > 0 || r_hi < nr)) || (wx && (e_lo > 0 || e_hi < len)))) return;
  const unsigned inv = 0xffffffffu / len + 1;       // u / len = high word of u * inv
  for (int u = threadIdx.x; u < (xt ? 2 * (len + nr) : nr * len); u += L_THREADS) {
    const int v = u - 2 * len;
    const int r = !xt ? (int)(((unsigned long long)u * inv) >> 32)
                      : v < 0 ? (u < len ? 0 : nr - 1) : v >> 1;
    const int e = !xt ? u - r * len : v < 0 ? (u < len ? u : u - len) : (v & 1) ? len - 1 : 0;
    const bool row_in = r >= r_lo && r < r_hi, col_in = e >= e_lo && e < e_hi;
    if ((row_in && col_in) || (!row_in && !wy) || (!col_in && !wx)) continue;
    const int pr = row_in ? j0 - 1 + r : wrap(j0 - 4 + r, ny) + PAD;
    const int pc = col_in ? c0 + e : wrap(c0 + e - PAD, nx) + PAD;
    const int d = sh + r * pp + e;
    copy4_at(sd + 4 * d, dst + d, base + (size_t)pr * px + pc);
  }
}

// Low-order flux plus the antidiffusive one scaled by its donor's r_hi:
// the west (south) donor where anti > 0, else the east (north) one, at
// offsets dw and de from the face's slot.
__device__ __forceinline__ float limited(float low, float anti, const float* rh, int o, int dw,
                                         int de) {
  return low + anti * rh[o + (anti > 0.0f ? dw : de)];
}

// The limited stage (PD limiter, clip optional) of one tracer on one tile,
// marching in k; see above.  XT: the tile is one of a.xtiles x tiles of the
// row; else it spans the row.  MSF: a.m2 scales the horizontal divergences
// and outflows.  The slots' work is branched on what the slot is: the
// slots of a warp's step are a run of 32 in a row, so whole warps skip the
// ring's rows where a phase has nothing for them.
template <bool XT, bool MSF>
__global__ void __launch_bounds__(L_THREADS, L_RESIDENT) limited_kernel(Args a, int clip) {
  extern __shared__ __align__(16) float smem[];
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int px = nx + 2 * PAD, py = ny + 2 * PAD, pyx = py * px, nyx = ny * nx;
  const int j0 = (blockIdx.x % a.tiles) * a.ty;
  const int t = XT ? blockIdx.x / a.tiles / a.xtiles : blockIdx.x / a.tiles;
  const int i0 = XT ? (blockIdx.x / a.tiles % a.xtiles) * a.tx : 0;
  const int tw = XT ? min(a.tx, nx - i0) : nx;       // cells of the tile's rows
  const int w = XT ? tw + 4 : nx + 1;                // slots of a slot row
  const int pp = XT ? a.pitch : px;                  // row pitch of every plane
  const int xo = XT ? 2 : 3;                         // plane column of slot column 0
  const int rows = min(a.ty, ny - j0);
  const LimLayout l = lim_layout(a.ty, pp);
  const int c0q = XT ? i0 - 1 : 0, lenq = XT ? tw + 8 : px;    // padded columns of q planes
  const int c0v = XT ? i0 + 1 : 0, lenv = XT ? tw + 5 : px;    // ... of ru and rv planes
  const float* const q_t = a.q + (size_t)t * nz * pyx;
  const float* const phi_t = a.phi + (size_t)t * nz * nyx;
  const float* const pt_t = a.pt == nullptr ? nullptr : a.pt + (size_t)t * nz * nyx;
  float* const out_t = a.out + (size_t)t * nz * nyx;
  const int e_w = a.edge[0], e_e = a.edge[1], e_s = a.edge[2], e_n = a.edge[3];
  const bool wrap_x = e_w == PERIODIC, wrap_y = e_s == PERIODIC;
  // donors across the domain's edges, relative to the face's slot: where a
  // side holds no data, the boundary maps the cell beyond it onto a cell of
  // the tile or its 1-ring (over the row, x always: a periodic x edge maps
  // onto the row's far end)
  const bool x_mapped = !XT || !wrap_x;
  const int west_edge = bc_map(-1, nx, e_w, e_e);
  const int east_edge = bc_map(nx, nx, e_w, e_e) - nx;
  const int south_edge = bc_map(-1, ny, e_s, e_n) * pp;
  const int north_edge = (bc_map(ny, ny, e_s, e_n) - ny) * pp;

  // o: the slot's place in every plane (q, ru, rv and the slot planes are
  // indexed alike); og: its cell's index in the (ny, nx) arrays
  int flags[L_CPT], oq[L_CPT], og[L_CPT];
  float mu_f[L_CPT], mu_n[L_CPT], m2s[L_CPT];
#pragma unroll
  for (int m = 0; m < L_CPT; ++m) {
    const int s = threadIdx.x + m * L_THREADS;
    const int rr = min(s / w, rows + 3), c = s - (s / w) * w;
    const int j = j0 + rr - 2, i = XT ? i0 + c - 2 : c;
    const bool row_held = (j >= 0 && j < ny) || wrap_y;
    const bool col_held = (i >= 0 && i < nx) || (XT && wrap_x);
    int f = 0;
    if (s < (rows + 4) * w) {
      if (rr >= 1 && (!XT || c >= 1)) f |= L_FACE;
      if (row_held && col_held) {
        f |= L_HELD;
        if (rr >= 1 && rr <= rows + 2 && (!XT || (c >= 1 && c <= tw + 2))) f |= L_R1;
        if (rr >= 2 && rr <= rows + 1 && (!XT || (c >= 2 && c <= tw + 1))) f |= L_CELL;
      }
      if (x_mapped && i == 0) f |= L_WEST;
      if (x_mapped && i == nx) f |= L_EAST;
      if (x_mapped && i == nx - 1) f |= L_EAST_CELL;
      if (!wrap_y && j == 0) f |= L_SOUTH;
      if (!wrap_y && j == ny) f |= L_NORTH;
      if (!wrap_y && j == ny - 1) f |= L_NORTH_CELL;
    }
    flags[m] = f;
    oq[m] = (rr + 2) * pp + c + xo;
    og[m] = (f & L_HELD) ? wrap(j, ny) * nx + wrap(i, nx) : 0;
    mu_f[m] = (f & L_CELL) && pt_t != nullptr ? a.mu_full[og[m]] : 0.0f;
    mu_n[m] = (f & L_CELL) ? a.mu_new[og[m]] : 1.0f;
    m2s[m] = MSF && (f & L_HELD) ? a.m2[og[m]] : 1.0f;
  }

  // plane `lev` of a ring, indexed by a slot's o
  float* const qs = smem + l.q;
  float* const rus = smem + l.ru;
  float* const rvs = smem + l.rv;
  auto q_at = [&](int lev) -> const float* {
    return qs + (lev % L_QR) * l.qp + shift_at(q_t + (size_t)lev * pyx, (long long)(j0 - 1) * px + c0q);
  };
  auto v_at = [&](float* ring, const float* v, int lev) -> const float* {
    return ring + (lev % L_VR) * l.vp + shift(v + (size_t)lev * pyx + (size_t)(j0 + 1) * px + c0v)
           - 2 * pp - (XT ? 2 : 0);
  };
  auto slot_plane = [&](int off) { return smem + off - 2 * pp - xo; };
  float* const rl0 = slot_plane(l.rl);
  float* const rl1 = slot_plane(l.rl + l.sp);
  float* const lxs = slot_plane(l.lx);
  float* const axs = slot_plane(l.ax);
  float* const lys = slot_plane(l.ly);
  float* const ays = slot_plane(l.ay);
  float* const rhs = slot_plane(l.rh);
  const unsigned sbase = smem_base(smem);
  auto fetch_q = [&](int lev) {
    const int off = l.q + (lev % L_QR) * l.qp;
    fetch_q_plane(sbase + 4 * off, smem + off, q_t + (size_t)lev * pyx, j0, c0q, rows + 8, lenq,
                  px, py, pp, a.ulog, XT, ny, nx, wrap_y, wrap_x);
  };
  auto fetch_v = [&](int lev) {
    const size_t o = (size_t)lev * pyx + (size_t)(j0 + 1) * px + c0v;
    const int u = l.ru + (lev % L_VR) * l.vp, v = l.rv + (lev % L_VR) * l.vp;
    if (XT) {
      rows_to<L_THREADS>(sbase + 4 * u, smem + u, a.ru + o, rows + 5, lenv, px, pp, a.vlog);
      rows_to<L_THREADS>(sbase + 4 * v, smem + v, a.rv + o, rows + 5, lenv, px, pp, a.vlog);
    } else {
      plane_to<L_THREADS>(sbase + 4 * u, smem + u, a.ru + o, (rows + 5) * px);
      plane_to<L_THREADS>(sbase + 4 * v, smem + v, a.rv + o, (rows + 5) * px);
    }
  };

  // ---- before the march: the planes of iteration -1
  fetch_q(0);
  if (nz > 1) fetch_q(1);
  fetch_v(0);

  float ww_c[L_CPT];             // omega at face k+1
  float phi_c[L_CPT], phi_p[L_CPT];  // phi_old of levels k and k-1
  float lz_c[L_CPT];             // unscaled low-order flux of face k+1 (r_lo(k)'s upper face)
  float rl_c[L_CPT];             // r_lo(k) of the slot's cell
  float zl_c[L_CPT], za_c[L_CPT];  // low-order and antidiffusive flux of face k
  float rh_c[L_CPT];             // r_hi(k-1) of the slot's cell
  float fz_p[L_CPT];             // limited flux of face k-1
  float hd_c[L_CPT];             // horizontal part of the limited divergence of level k-1
#pragma unroll
  for (int m = 0; m < L_CPT; ++m)
    ww_c[m] = phi_c[m] = phi_p[m] = lz_c[m] = rl_c[m] = zl_c[m] = za_c[m] = rh_c[m] = fz_p[m] =
        hd_c[m] = 0.0f;

  for (int k = -1; k <= nz; ++k) {
    copies_land();
    __syncthreads();
    if (k + 3 < nz) fetch_q(k + 3);
    if (k + 2 < nz) fetch_v(k + 2);
    float ww_n[L_CPT], phi_n[L_CPT], pt_0[L_CPT];
#pragma unroll
    for (int m = 0; m < L_CPT; ++m) {
      const bool held = flags[m] & L_HELD;
      ww_n[m] = held && k + 2 < nz ? a.ww[(size_t)(k + 2) * nyx + og[m]] : 0.0f;
      phi_n[m] = held && k + 1 < nz ? phi_t[(size_t)(k + 1) * nyx + og[m]] : 0.0f;
      pt_0[m] = (flags[m] & L_CELL) && pt_t != nullptr && k >= 1
                    ? pt_t[(size_t)(k - 1) * nyx + og[m]] : 0.0f;
    }

    // ---- A: faces of level k; r_lo(k+1); z face k+1
    float zl_n[L_CPT], za_n[L_CPT];
#pragma unroll
    for (int m = 0; m < L_CPT; ++m) zl_n[m] = za_n[m] = 0.0f;
    if (k >= 0 && k < nz) {
      const float* const qk = q_at(k);
      const float* const ruk = v_at(rus, a.ru, k);
      const float* const rvk = v_at(rvs, a.rv, k);
      const float* const rlk = (k & 1) ? rl1 : rl0;
#pragma unroll
      for (int m = 0; m < L_CPT; ++m) {
        const int f = flags[m], o = oq[m];
        if (!(f & L_FACE)) continue;
        const float* const q = qk + o;
        {      // x face between cells i-1 and i
          const float vel = ruk[o];
          const float hi = flux5(vel, q[-3], q[-2], q[-1], q[0], q[1], q[2]);
          const int dw = (f & L_WEST) ? west_edge : -1, de = (f & L_EAST) ? east_edge : 0;
          const float lo = flux1(vel, q[-1], q[0]);
          const float low = lo * rlk[o + (lo > 0.0f ? dw : de)];
          lxs[o] = low;
          axs[o] = hi - low;
        }
        {      // y face between rows j-1 and j
          const float vel = rvk[o];
          const float hi = flux5(vel, q[-3 * pp], q[-2 * pp], q[-pp], q[0], q[pp], q[2 * pp]);
          const int ds = (f & L_SOUTH) ? south_edge : -pp, dn = (f & L_NORTH) ? north_edge : 0;
          const float lo = flux1(vel, q[-pp], q[0]);
          const float low = lo * rlk[o + (lo > 0.0f ? ds : dn)];
          lys[o] = low;
          ays[o] = hi - low;
        }
      }
    }
    if (k + 1 < nz) {
      const int lev = k + 1;
      const bool top = lev + 1 == nz;            // no flux through the model top
      const float rd = a.rdnw[lev];
      const float* const ql = q_at(lev);
      const float* const qu = q_at(min(lev + 1, nz - 1));
      const float* const qm = q_at(max(k - 1, 0));
      const float* const q0 = q_at(max(k, 0));
      const float* const rul = v_at(rus, a.ru, lev);
      const float* const rvl = v_at(rvs, a.rv, lev);
      float* const rl = (lev & 1) ? rl1 : rl0;
#pragma unroll
      for (int m = 0; m < L_CPT; ++m) {
        const int f = flags[m], o = oq[m];
        if (!(f & L_HELD)) continue;
        const float* const q = ql + o;
        const float zu = top ? 0.0f : -flux1(-ww_n[m], q[0], qu[o]);
        const float r = factor<MSF>(fmaxf(phi_n[m], 0.0f), flux1(rul[o], q[-1], q[0]),
                                    flux1(rul[o + 1], q[0], q[1]), flux1(rvl[o], q[-pp], q[0]),
                                    flux1(rvl[o + pp], q[0], q[pp]), lz_c[m], zu, rd, m2s[m], a);
        rl[o] = r;
        if (k >= 0 && (f & L_R1)) {
          // z face k+1: positive flux drains the upper cell k+1; its
          // unscaled low-order flux is r_lo(k)'s upper face
          const float hi = -flux3(-ww_c[m], qm[o], q0[o], q[0], qu[o]);
          const float lo = lz_c[m];
          const float low = lo * (lo > 0.0f ? r : rl_c[m]);
          zl_n[m] = low;
          za_n[m] = hi - low;
        }
        lz_c[m] = zu;
        rl_c[m] = r;
      }
    }
    __syncthreads();

    // ---- B: r_hi(k) on the tile and its 1-ring; the limited z face k
    float fz_c[L_CPT];
#pragma unroll
    for (int m = 0; m < L_CPT; ++m) fz_c[m] = 0.0f;
    if (k >= 0 && k < nz) {
      const float rd = a.rdnw[k];
#pragma unroll
      for (int m = 0; m < L_CPT; ++m) {
        const int o = oq[m];
        if (flags[m] & L_R1) {
          const float div = divergence<MSF>(lxs[o], lxs[o + 1], lys[o], lys[o + pp], zl_c[m],
                                            zl_n[m], rd, m2s[m], a);
          const float phi_td = fmaxf(phi_c[m] + a.dts * div, 0.0f);
          const float r = factor<MSF>(phi_td, axs[o], axs[o + 1], ays[o], ays[o + pp], za_c[m],
                                      za_n[m], rd, m2s[m], a);
          rhs[o] = r;
          fz_c[m] = zl_c[m] + za_c[m] * (za_c[m] > 0.0f ? r : rh_c[m]);
          rh_c[m] = r;
        }
        zl_c[m] = zl_n[m];
        za_c[m] = za_n[m];
      }
    }
    __syncthreads();

    // ---- C: horizontal limited divergence of level k; update of level k-1
    const float rdp = k >= 1 ? a.rdnw[k - 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < L_CPT; ++m) {
      const int f = flags[m], o = oq[m];
      if (f & L_CELL) {
        float hd = 0.0f;
        if (k < nz) {
          const float xl = limited(lxs[o], axs[o], rhs, o, (f & L_WEST) ? west_edge : -1, 0);
          const float xr = limited(lxs[o + 1], axs[o + 1], rhs, o + 1, -1,
                                   (f & L_EAST_CELL) ? east_edge : 0);
          const float yl = limited(lys[o], ays[o], rhs, o, (f & L_SOUTH) ? south_edge : -pp, 0);
          const float yr = limited(lys[o + pp], ays[o + pp], rhs, o + pp, -pp,
                                   (f & L_NORTH_CELL) ? north_edge : 0);
          hd = (xr - xl) * a.rdx + (yr - yl) * a.rdy;
          if (MSF) hd = m2s[m] * hd;
        }
        if (k >= 1) {
          const float fz_up = k < nz ? fz_c[m] : 0.0f;
          float tend = -(hd_c[m] + (fz_up - fz_p[m]) * rdp);
          if (pt_t != nullptr) tend = tend + mu_f[m] * pt_0[m];
          float qn = (phi_p[m] + a.dts * tend) / mu_n[m];
          if (clip) qn = fmaxf(qn, 0.0f);
          out_t[(size_t)(k - 1) * nyx + og[m]] = qn;
          fz_p[m] = fz_up;
        }
        hd_c[m] = hd;
      }
      ww_c[m] = ww_n[m];
      phi_p[m] = phi_c[m];
      phi_c[m] = phi_n[m];
    }
  }
}

// The tallest tile whose slots the block's threads cover and that leaves
// room for the mode's resident blocks on an SM, else the tallest that fits
// at all (2 rows at least, so that a symmetric boundary's reflected row
// stays in the tile or its halo); tiles of even height over ny.  With one
// tile over the row (xt false) the row must fit; with x tiles (xt) each is
// as wide as the slots allow at that height, its width in *tx.  Returns the
// tile height, or 0 where none fits.  The grid without the limiter, and the
// seam grids.
template <int MODE>
int tile_rows(const Args& a, bool xt, int* tx) {
  const int least = a.ny > 1 ? 2 : 1;
  const int most = (a.ny + TY_MAX - 1) / TY_MAX;
  const int budgets[2] = {SMEM_SM / resident(MODE) - SMEM_RESERVED, SMEM_MAX};
  for (int b = 0; b < 2; ++b)
    for (int ty = (a.ny + most - 1) / most; ty >= least; --ty) {
      if (!xt) {
        if ((ty + 2) * (a.nx + 1) <= SLOTS &&
            layout(MODE, ty, a.nx, SLOTS).total * (int)sizeof(float) <= budgets[b])
          return ty;
        continue;
      }
      for (int w = SLOTS / (ty + 2) - 2; w >= 2; --w)
        if (layout(MODE, ty, a.nx, SLOTS, true, w, w + 2 * PAD + 3).total *
            (int)sizeof(float) <= budgets[b]) {
          *tx = w;
          return ty;
        }
    }
  return 0;
}

struct Plan {
  bool xt;              // x tiles, else one tile over the row
  int ty, tx;           // rows of a tile, cells of its rows
  int tiles, xtiles;    // tiles over y and over x
  int pitch, ulog;      // x tiles: row pitch of a plane, log2 of copy units a row
  int vlog;             // the limited grid's x tiles: the same for ru and rv
  int bytes;            // dynamic shared memory of a block
  int threads, cpt;     // threads a block, slots a thread
};

// log2 of the copy units of a row of len floats (rows_to): its 16-byte
// pieces and the few floats before and after them.
int units_log(int len) {
  int u = 0;
  while ((1 << u) < (len >> 2) + 6) ++u;
  return u;
}

// The launch plan of the mode's grid: one tile over the row where one
// spans it, else x tiles of even width (RING: the seam grids, x tiles
// only); ty = 0 where no grid fits.
template <int MODE, bool RING>
Plan make_plan(const Args& a) {
  Plan p{};
  p.threads = THREADS;
  p.cpt = CPT;
  p.tx = a.nx;
  p.ty = RING ? 0 : tile_rows<MODE>(a, false, nullptr);
  p.xt = p.ty == 0;
  if (p.xt) p.ty = tile_rows<MODE>(a, true, &p.tx);
  if (p.ty == 0) return p;
  p.tiles = (a.ny + p.ty - 1) / p.ty;
  p.xtiles = (a.nx + p.tx - 1) / p.tx;
  p.tx = (a.nx + p.xtiles - 1) / p.xtiles;
  if (p.xt) {
    const int px = a.nx + 2 * PAD;
    p.pitch = p.tx + 2 * PAD + ((px - p.tx - 2 * PAD) & 3);   // = px modulo 4
    p.ulog = units_log(p.tx + 2 * PAD);
  }
  p.bytes = layout(MODE, p.ty, a.nx, SLOTS, p.xt, p.tx, p.pitch).total * (int)sizeof(float);
  return p;
}

// The launch plan of the limited grid: of the tiles whose slots (the tile
// and its 2-ring) the block's threads cover and whose shared memory leaves
// room for L_RESIDENT blocks on an SM, the one that holds the most cells,
// at even heights over ny and widths over nx: the tallest tile over the row
// (its slots have no x ring), or x tiles of the height that gives the
// largest; one tile over the row where it holds as many cells.
Plan lim_plan(const Args& a) {
  Plan p{};
  const int px = a.nx + 2 * PAD;
  const int budget = SMEM_SM / L_RESIDENT - SMEM_RESERVED;
  auto bytes = [](int ty, int pp) { return lim_layout(ty, pp).total * (int)sizeof(float); };
  for (int ty = min(a.ny, L_SLOTS / (a.nx + 1) - 4); ty >= 1; --ty) {
    const int tiles = (a.ny + ty - 1) / ty, te = (a.ny + tiles - 1) / tiles;
    if (bytes(te, px) <= budget) {
      p = {false, te, a.nx, tiles, 1, 0, 0, 0, bytes(te, px), L_THREADS, L_CPT};
      break;
    }
  }
  for (int ty = 1; ty <= a.ny && L_SLOTS / (ty + 4) - 4 >= 1; ++ty) {
    const int widest = L_SLOTS / (ty + 4) - 4;
    const int xtiles = (a.nx + widest - 1) / widest, tx = (a.nx + xtiles - 1) / xtiles;
    const int tiles = (a.ny + ty - 1) / ty, te = (a.ny + tiles - 1) / tiles;
    const int pitch = tx + 8 + ((px - tx - 8) & 3);            // = px modulo 4
    if (te * tx <= p.ty * p.tx || bytes(te, pitch) > budget) continue;
    p = {true, te, tx, tiles, xtiles, pitch, units_log(tx + 8), units_log(tx + 5),
         bytes(te, pitch), L_THREADS, L_CPT};
  }
  return p;
}

// Calls f with the kernel instance that runs plan p (msf: with a map
// factor) and returns what f returns.
template <int MODE, bool RING, class F>
int with_kernel(const Plan& p, bool msf, F f) {
  if (p.xt)
    return msf ? f(stage_kernel<MODE, true, true, RING>) : f(stage_kernel<MODE, true, false, RING>);
  if constexpr (!RING)
    return msf ? f(stage_kernel<MODE, false, true, false>)
               : f(stage_kernel<MODE, false, false, false>);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

template <class F>
int with_limited(const Plan& p, bool msf, F f) {
  if (p.xt) return msf ? f(limited_kernel<true, true>) : f(limited_kernel<true, false>);
  return msf ? f(limited_kernel<false, true>) : f(limited_kernel<false, false>);
}

// Launches the grid of plan p through `with` (with_kernel or with_limited).
template <class W>
int launch_plan(const Plan& p, Args a, int clip, cudaStream_t s, W with) {
  if (p.ty == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t blocks = (size_t)p.tiles * p.xtiles * a.nt;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.ty = p.ty;
  a.tiles = p.tiles;
  a.tx = p.tx;
  a.xtiles = p.xtiles;
  a.pitch = p.pitch;
  a.ulog = p.ulog;
  a.vlog = p.vlog;
  return with(p, a.m2 != nullptr, [&](auto kernel) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<(unsigned)blocks, (unsigned)p.threads, (size_t)p.bytes, s>>>(a, clip);
    return static_cast<int>(cudaGetLastError());
  });
}

template <int MODE, bool RING = false>
int launch(const Args& a, int clip, cudaStream_t s) {
  return launch_plan(make_plan<MODE, RING>(a), a, clip, s,
                     [](const Plan& p, bool msf, auto f) { return with_kernel<MODE, RING>(p, msf, f); });
}

int launch_limited(const Args& a, int clip, cudaStream_t s) {
  return launch_plan(lim_plan(a), a, clip, s,
                     [](const Plan& p, bool msf, auto f) { return with_limited(p, msf, f); });
}

// The plan p of a grid run through `with` into out[12] (advect_tracers_plan).
template <class W>
int report_plan(const Plan& p, const Args& a, int* out, W with) {
  if (p.ty == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = p.xt;
  out[1] = p.cpt;
  out[2] = p.ty;
  out[3] = p.tx;
  out[4] = p.tiles;
  out[5] = p.xtiles;
  out[6] = p.tiles * p.xtiles * a.nt;
  out[7] = p.bytes;
  out[11] = p.threads;
  return with(p, a.m2 != nullptr, [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], kernel, p.threads,
                                                        (size_t)p.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[9] = attr.numRegs;
    out[10] = (int)attr.localSizeBytes;
    return 0;
  });
}

template <int MODE, bool RING>
int report(const Args& a, int* out) {
  return report_plan(make_plan<MODE, RING>(a), a, out,
                     [](const Plan& p, bool msf, auto f) { return with_kernel<MODE, RING>(p, msf, f); });
}

int report_limited(const Args& a, int* out) {
  return report_plan(lim_plan(a), a, out,
                     [](const Plan& p, bool msf, auto f) { return with_limited(p, msf, f); });
}

Args make_args(const float* q, const float* phi, const float* pt, const float* ru,
               const float* rv, const float* ww, const float* mu_full, const float* mu_new,
               const float* rdnw, const float* m2, float* r_hi, const float* r_ring,
               float* out, int nt, int nz, int ny, int nx, float rdx, float rdy, float dts,
               const int edge[4]) {
  Args a{};
  a.q = q; a.phi = phi; a.pt = pt; a.ru = ru; a.rv = rv; a.ww = ww;
  a.mu_full = mu_full; a.mu_new = mu_new; a.rdnw = rdnw; a.m2 = m2;
  a.r_hi = r_hi; a.r_ring = r_ring; a.out = out;
  a.nt = nt; a.nz = nz; a.ny = ny; a.nx = nx;
  for (int e = 0; e < 4; ++e) a.edge[e] = edge[e];
  a.xtiles = 1;
  a.rdx = rdx; a.rdy = rdy; a.dts = dts;
  return a;
}

bool edges_valid(const int edge[4]) {
  for (int e = 0; e < 4; ++e)
    if (edge[e] < PERIODIC || edge[e] > SEAM) return false;
  // a periodic axis wraps within the block on both sides or neither
  return (edge[0] == PERIODIC) == (edge[1] == PERIODIC) &&
         (edge[2] == PERIODIC) == (edge[3] == PERIODIC);
}

}  // namespace

// Launches one grid on `stream` (without the limiter, or the limited stage)
// and returns cudaGetLastError() if it is not 0.  `pt` and `m2` may be
// null; `r_hi` is unused (may be null).  west .. north: the Edge beyond each
// side of the block.  A seam is refused with the limiter: its factors come
// from the neighbouring block (advect_tracers_seam).
extern "C" int advect_tracers(const float* q, const float* phi, const float* pt,
                              const float* ru, const float* rv, const float* ww,
                              const float* mu_full, const float* mu_new,
                              const float* rdnw, const float* m2, float* r_hi, float* out,
                              int nt, int nz, int ny, int nx, float rdx, float rdy,
                              float dts, int pd, int clip, int west, int east, int south,
                              int north, void* stream) {
  const int edge[4] = {west, east, south, north};
  if (!edges_valid(edge)) return static_cast<int>(cudaErrorInvalidValue);
  if (pd && (west == SEAM || east == SEAM || south == SEAM || north == SEAM))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, phi, pt, ru, rv, ww, mu_full, mu_new, rdnw, m2, r_hi, nullptr,
                           out, nt, nz, ny, nx, rdx, rdy, dts, edge);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pd ? launch_limited(a, clip, s) : launch<PLAIN>(a, clip, s);
}

// One grid of the limited update on a block of a process mesh (RING):
// grid 1 (FACTOR) writes r_hi (nt, nz, ny, nx); the caller then gives it
// its one-cell ring from the neighbouring blocks (r_ring, (nt, nz, ny+2,
// nx+2)) and launches grid 2 (LIMITED), which reads r_ring and writes
// out.  phi (nt, nz, ny+2, nx+2), ww (nz+1, ny+2, nx+2) and m2 (ny+2,
// nx+2, or null) carry the same exchanged ring; the other arrays are as
// in advect_tracers.  Always the grid of x tiles, whose slots include a
// halo column on each side.
extern "C" int advect_tracers_seam(int grid, const float* q, const float* phi,
                                   const float* pt, const float* ru, const float* rv,
                                   const float* ww, const float* mu_full,
                                   const float* mu_new, const float* rdnw, const float* m2,
                                   float* r_hi, const float* r_ring, float* out, int nt,
                                   int nz, int ny, int nx, float rdx, float rdy, float dts,
                                   int clip, int west, int east, int south, int north,
                                   void* stream) {
  const int edge[4] = {west, east, south, north};
  if (!edges_valid(edge)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, phi, pt, ru, rv, ww, mu_full, mu_new, rdnw, m2, r_hi, r_ring,
                           out, nt, nz, ny, nx, rdx, rdy, dts, edge);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == FACTOR) return launch<FACTOR, true>(a, clip, s);
  if (grid == LIMITED) return launch<LIMITED, true>(a, clip, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The widest x row (cells) that one tile spans at ny rows (pd 0: the grid
// without the limiter) or up to which every row takes one tile (pd 1: the
// limited grid): up to it the plan takes one tile over the row, past it x
// tiles.
extern "C" int advect_tracers_widest_row(int pd, int ny) {
  Args a{};
  a.ny = ny;
  if (pd) {
    for (a.nx = 1; a.nx < 4096 && !lim_plan(a).xt; ++a.nx) {
    }
    return a.nx - 1;
  }
  int lo = 0, hi = 4096;                   // fits at lo (or lo = 0), not at hi
  while (hi - lo > 1) {
    a.nx = (lo + hi) / 2;
    (tile_rows<PLAIN>(a, false, nullptr) > 0 ? lo : hi) = a.nx;
  }
  return lo;
}

// The plan of the grid of `advect_tracers` (seam 0: `grid` 0 without the
// limiter, 2 the limited stage) or of one of `advect_tracers_seam` (seam 1:
// `grid` 1 FACTOR or 2 LIMITED) at (nt, nz, ny, nx), with a map factor if
// msf.  Into plan[12]: {x tiles (1) or one tile over the row (0), slots a
// thread, rows of a tile, cells of a tile's rows, tiles over y, tiles over
// x, blocks, dynamic shared memory of a block (bytes), blocks an SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers a thread and
// local (spill) bytes a thread by cudaFuncGetAttributes, threads a block}.  Returns 0, or
// the CUDA error (cudaErrorInvalidConfiguration where the grid does not
// fit).
extern "C" int advect_tracers_plan(int grid, int seam, int nt, int nz, int ny, int nx, int msf,
                                   int* plan) {
  if (nt < 1 || nz < 1 || ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int edge[4] = {OPEN, OPEN, OPEN, OPEN};
  static const float m2 = 1.0f;          // a map factor's pointer picks the instance
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, msf ? &m2 : nullptr, nullptr, nullptr, nullptr, nt,
                           nz, ny, nx, 0.0f, 0.0f, 0.0f, edge);
  if (seam) {
    if (grid == FACTOR) return report<FACTOR, true>(a, plan);
    if (grid == LIMITED) return report<LIMITED, true>(a, plan);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid == PLAIN) return report<PLAIN, false>(a, plan);
  if (grid == LIMITED) return report_limited(a, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}
