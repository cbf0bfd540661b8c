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
// lateral boundary rule; phi_old, pt, r_hi, out (nt, nz, ny, nx);
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
// Design: shared-memory planes, fixed slots and a march in z.
//
// - A block owns a tile of rows over the whole x row (or an x tile of the
//   row, below) for one tracer and marches from k = 0 to nz - 1.  Its slots
//   are the (ty + 2) x (nx + 1) points of the tile with a one-row halo and
//   one more column; slot (rr, i) is cell (j0 + rr - 1, i), its west x face
//   and its south y face.  Each thread owns four slots for the whole march,
//   so what a slot is (its flags) and where it reads (two offsets) is
//   worked out once, and no lane idles on a ragged x tile.  A thread
//   computes all of its slots alike, without branches on what a slot is, so
//   that the compiler interleaves their work; only the stores look at the
//   flags.  The tile height divides ny evenly and shrinks for rows too wide
//   for the shared memory.
// - The launch plan (`make_plan`): one tile over the row where a tile of
//   two rows spans it (`widest_row_of`: 255 cells in every grid), else x
//   tiles.  Eight slots a thread, which let one tile span rows up to 511
//   cells, are gone: at config 5's per-card block (500 x 500) the grid
//   without the limiter took one tile of 2 rows that way, 142 KB of shared
//   memory, one block an SM, q planes of 8 rows for 2 rows of cells and 472
//   bytes of spills (90.7 ms a call on the H100); x tiles of 8 x 100 cells,
//   three blocks an SM, take a quarter of that.  A cost model over the
//   halo's share, the q rows fetched per row of cells and the blocks an SM
//   picked the same grids as this rule on every shape a path runs (rows of
//   45, 50, 90, 100, 500 and 1,000 cells), so the rule stands in its place.
// - An x tile is at most as wide as four slots a thread cover at its height
//   (254 cells at 2 rows, 100 at 8) and as tall as the shared memory
//   allows.  A tile of tw
//   cells carries the 3-cell x halo in its q, ru and rv planes, and its
//   slots are (ty + 2) x (tw + 2): one more column on each side, cells
//   i0 - 1 and i0 + tw, whose factors the faces at the tile's edges read.
//   Such a column forms r_lo on the tile, as the y halo rows do, and in
//   grid LIMITED reads r_hi from device memory.  Each cell, and so each
//   store, belongs to exactly one tile; a face that two tiles share is
//   computed by both, in shared memory only.  A tile's rows do not form one
//   piece of the padded array, so a plane is copied row by row, its rows in
//   shared memory at a pitch congruent to the padded row's modulo 4 floats:
//   the one shift of the plane then aligns every row's 16-byte pieces.
// - Planes come by asynchronous copy (cp.async), started at least one
//   iteration before their use, into rings in shared memory: q (with one
//   tile over the row, the tile's rows and three halo rows are one
//   contiguous piece of the padded array, so a plane is a linear copy), ru
//   and rv (likewise), and r_hi.  A plane lands shifted by up to 3 floats,
//   so that source and destination are 16-byte aligned alike and the copy
//   goes in 16-byte pieces.  The few per-cell values (ww, phi, pt) are
//   loaded into registers a phase before their use.  A level costs two
//   barriers.
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
//   by one cell gives for every boundary kind.  In x, with one tile over
//   the row, the mapped cell is always in the block's row.  With x tiles
//   the map applies at the domain's two x edges only: an open or symmetric
//   boundary maps the halo column onto a column of the edge tile (or the
//   tile's other halo column), and a periodic one forms r_lo there from the
//   periodic padding of q (phi and ww read at the wrapped column) and reads
//   r_hi from the far side.  In y an open or symmetric boundary maps the
//   halo row onto a row of the tile or its other halo row; a periodic one
//   forms r_lo from the periodic padding of q (phi and ww read at the
//   wrapped row), which gives the far side's value bit for bit, and reads
//   r_hi from the far side.
// - The map factor of a slot's cell (the mapped cell for a halo slot) is
//   loaded once, before the march, into a register beside mu_full and
//   mu_new; it costs one multiply in each divergence and each factor.
// - A specified lateral boundary (real-data runs) pads like an open one
//   (edge replication), so it takes the open boundary's index map.
// - Residency: three blocks on an SM without the limiter, two with it
//   (registers by launch bound, shared memory by the tile height).
// - Tried on the card and dropped: two tracers a block sharing ru, rv and ww
//   (6.7 MB at 100x100x50, they stay in L2; the block's shared memory
//   doubles and a block less fits an SM: slower), and a ninth warp that only
//   fetches planes (the compute warps' registers shrink: slower with the
//   limiter).  A producer warp that gives its registers to the compute
//   warps (setmaxnreg) was not built: with two blocks of 8 + 1 warps an SM
//   and the producer at 24 registers, a compute thread can get at most 120
//   (a multiple of 8 under 65,536 / 2 less the producers', over 512
//   threads), under the 128 the limiter's grids use now.  Bulk copies
//   (cp.async.bulk, counted on an mbarrier per ring slot; no tensor map: the
//   padded row's pitch, (nx + 6) x 4 bytes, is not a multiple of 16): of one
//   tile's contiguous planes, up to 7% slower than every thread's cp.async
//   at 100x100x50 and 50x50x50; of an x tile's rows, one thread a row, 3.4%
//   faster in the limited pair at config 5's block (81.6 -> 78.8 ms, H100),
//   about 3 ms of a main step that varies by more between runs, for an
//   mbarrier protocol the CPU emulation cannot check.  The grids with no
//   plane copied at all (a wrong result, timed) are 14% under the limited
//   pair there (70.4 ms): no copy path can give it more than that.  What
//   bounds the kernel is instruction rate: ~190 float instructions per slot
//   and level with the limiter (no fused multiply-add, so that it rounds
//   like its plain version), and the loads from shared memory around them.
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
// of grid FACTOR's r_hi, and grid LIMITED reads it.  Why (a): the limiter's
// grids already fill the shared memory that (b)'s wider planes (two more
// rows and columns of q, ru and rv, and of r_hi) would need, so (b) would
// cost tile height on every launch, seam or not; (a) leaves the one-block
// instances as they were and costs an exchange of an nt x nz x perimeter
// ring per limited stage (and the rings of phi_old, ww and m2).  The RING
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
  float* r_hi;           // written by FACTOR (and read by LIMITED unless RING)
  const float* r_ring;   // RING: r_hi with its exchanged one-cell ring, read by LIMITED
  float* out;
  int nt, nz, ny, nx;
  int edge[4];           // west, east, south, north: an Edge
  int ty, tiles;         // rows of a tile, tiles over y
  int tx, xtiles;        // x tiles: cells of a tile, tiles over x (XT)
  int pitch, ulog;       // XT: row pitch of a plane, log2 of copy units a row
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

// n rows of len floats, row r from src + r * spitch to a plane whose rows
// are dpitch apart (dpitch = spitch modulo 4): element e of row r lands at
// dst[shift(src) + r * dpitch + e], so that every row's source and
// destination are aligned alike, and goes in 16-byte pieces but for the few
// floats before the row's first and after its last 16-byte boundary.  Each
// row takes 1 << ulog units of work (pieces, then head and tail floats).
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n, int len,
                                          int spitch, int dpitch, int ulog) {
  dst += shift(src);
  for (int c = threadIdx.x; c < (n << ulog); c += THREADS) {
    const int r = c >> ulog, u = c & ((1 << ulog) - 1);
    const float* const s = src + (size_t)r * spitch;
    float* const d = dst + r * dpitch;
    const int head = (4 - shift(s)) & 3, pieces = (len - head) >> 2;
    if (u < pieces) {
      copy_async16(d + head + 4 * u, s + head + 4 * u);
    } else {
      const int k = u - pieces, e = k < head ? k : 4 * pieces + k;
      if (e < len) copy_async(d + e, s + e);
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

// One RK stage of one tracer on one tile of rows, marching in k.  Each
// thread owns CPT slots and computes all of them alike, without branches on
// what a slot is (so that the compiler interleaves the slots' work); only
// the stores look at the slot's flags.
//   PLAIN:   high-order fluxes, update.
//   FACTOR:  r_lo on chip, renormalised low-order and antidiffusive fluxes,
//            r_hi to device memory.
//   LIMITED: r_lo on chip again, r_hi from device memory, limited fluxes,
//            update.
// XT: the tile is one of a.xtiles x tiles of the row (its planes carry the
// x halo and a row pitch of their own); else it spans the row.  MSF: a.m2
// scales the horizontal divergences and outflows.  RING (with XT, limiter
// grids only): phi, ww and m2 carry a one-cell ring, (ny+2) x (nx+2) a
// plane, and LIMITED reads r_hi from a.r_ring, laid out alike; every cell
// that holds data (the block's, and its halo ring beyond a periodic side or
// a seam) reads them at its own place in the ring layout.
template <int MODE, bool XT, bool MSF, bool RING>
__global__ void __launch_bounds__(THREADS, resident(MODE)) stage_kernel(Args a, int clip) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool PD = MODE != PLAIN;
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
  const float* const r_in_t = MODE != LIMITED ? nullptr
                              : RING ? a.r_ring + (size_t)t * nz * hyx : r_hi_t;
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
  auto fetch = [&](float* dst, const float* src, int n) {
    if (XT) copy_rows(dst, src, n, tw + 2 * PAD, px, pp, a.ulog);
    else copy_plane(dst, src, n * px);
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
      if (MODE == LIMITED && k + 2 < nz && (flags[m] & IS_HELD))
        copy_async(rhs + ((k + 2) % R_RING) * l.sp + s, r_in_t + (size_t)(k + 2) * hyx + hidx(m));
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

// The tallest tile whose slots the block's threads cover and that leaves
// room for the mode's resident blocks on an SM, else the tallest that fits
// at all (2 rows at least, so that a symmetric boundary's reflected row
// stays in the tile or its halo); tiles of even height over ny.  With one
// tile over the row (xt false) the row must fit; with x tiles (xt) each is
// as wide as the slots allow at that height, its width in *tx.  Returns the
// tile height, or 0 where none fits.
template <int MODE>
int tile_rows(const Args& a, bool xt, int* tx) {
  const int least = a.ny > 1 ? 2 : 1;
  const int most = (a.ny + TY_MAX - 1) / TY_MAX;
  const int budgets[2] = {SMEM_SM / resident(MODE) - SMEM_RESERVED, SMEM_MAX};
  for (int b = 0; b < 2; ++b)
    for (int ty = (a.ny + most - 1) / most; ty >= least; --ty) {
      if (!xt) {
        if ((ty + 2) * (a.nx + 1) <= CPT * THREADS &&
            layout(MODE, ty, a.nx, CPT * THREADS).total * (int)sizeof(float) <= budgets[b])
          return ty;
        continue;
      }
      for (int w = CPT * THREADS / (ty + 2) - 2; w >= 2; --w)
        if (layout(MODE, ty, a.nx, CPT * THREADS, true, w, w + 2 * PAD + 3).total *
            (int)sizeof(float) <= budgets[b]) {
          *tx = w;
          return ty;
        }
    }
  return 0;
}

// The widest x row that one tile of the mode's grid spans (whether a row
// fits only narrows as it widens): up to it the plan takes one tile, past
// it x tiles.
template <int MODE>
int widest_row_of(int ny) {
  Args a{};
  a.ny = ny;
  int lo = 0, hi = 4096;                   // fits at lo (or lo = 0), not at hi
  while (hi - lo > 1) {
    a.nx = (lo + hi) / 2;
    (tile_rows<MODE>(a, false, nullptr) > 0 ? lo : hi) = a.nx;
  }
  return lo;
}

struct Plan {
  bool xt;              // x tiles, else one tile over the row
  int ty, tx;           // rows of a tile, cells of its rows
  int tiles, xtiles;    // tiles over y and over x
  int pitch, ulog;      // x tiles: row pitch of a plane, log2 of copy units a row
  int bytes;            // dynamic shared memory of a block
};

// The launch plan of the mode's grid: one tile over the row where one
// spans it, else x tiles of even width (RING: the seam grids, x tiles
// only); ty = 0 where no grid fits.
template <int MODE, bool RING>
Plan make_plan(const Args& a) {
  Plan p{};
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
    while ((1 << p.ulog) < ((p.tx + 2 * PAD) >> 2) + 6) ++p.ulog;
  }
  p.bytes = layout(MODE, p.ty, a.nx, CPT * THREADS, p.xt, p.tx, p.pitch).total *
            (int)sizeof(float);
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

// Launches the mode's grid by its plan.
template <int MODE, bool RING = false>
int launch(Args a, int clip, cudaStream_t s) {
  const Plan p = make_plan<MODE, RING>(a);
  if (p.ty == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t blocks = (size_t)p.tiles * p.xtiles * a.nt;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.ty = p.ty;
  a.tiles = p.tiles;
  a.tx = p.tx;
  a.xtiles = p.xtiles;
  a.pitch = p.pitch;
  a.ulog = p.ulog;
  return with_kernel<MODE, RING>(p, a.m2 != nullptr, [&](auto kernel) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<(unsigned)blocks, THREADS, (size_t)p.bytes, s>>>(a, clip);
    return static_cast<int>(cudaGetLastError());
  });
}

// The plan of the mode's grid into out[11] (advect_tracers_plan).
template <int MODE, bool RING>
int report_plan(const Args& a, int* out) {
  const Plan p = make_plan<MODE, RING>(a);
  if (p.ty == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  out[0] = p.xt;
  out[1] = CPT;
  out[2] = p.ty;
  out[3] = p.tx;
  out[4] = p.tiles;
  out[5] = p.xtiles;
  out[6] = p.tiles * p.xtiles * a.nt;
  out[7] = p.bytes;
  return with_kernel<MODE, RING>(p, a.m2 != nullptr, [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], kernel, THREADS,
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

// Launches on `stream` (one grid without the limiter, two with it) and
// returns the first cudaGetLastError() that is not 0.  `pt` and `m2` may be
// null; `r_hi` is (nt, nz, ny, nx) scratch, unused (may be null) without
// the limiter.  west .. north: the Edge beyond each side of the block.  A
// seam is refused with the limiter: its factors come from the neighbouring
// block (advect_tracers_seam).
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
  if (!pd) return launch<PLAIN>(a, clip, s);
  const int err = launch<FACTOR>(a, clip, s);
  return err != 0 ? err : launch<LIMITED>(a, clip, s);
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

// The widest x row (cells) that one tile spans at ny rows in every grid of
// a call: up to it the plan takes one tile over the row, past it x tiles.
extern "C" int advect_tracers_widest_row(int pd, int ny) {
  return pd ? min(widest_row_of<FACTOR>(ny), widest_row_of<LIMITED>(ny))
            : widest_row_of<PLAIN>(ny);
}

// The plan of one grid of `advect_tracers` (seam 0) or of
// `advect_tracers_seam` (seam 1) at (nt, nz, ny, nx), with a map factor if
// msf: `grid` 0 (without the limiter), 1 (FACTOR) or 2 (LIMITED).  Into
// plan[11]: {x tiles (1) or one tile over the row (0), slots a thread, rows
// of a tile, cells of a tile's rows, tiles over y, tiles over x, blocks,
// dynamic shared memory of a block (bytes), blocks an SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers a thread and
// local (spill) bytes a thread by cudaFuncGetAttributes}.  Returns 0, or
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
    if (grid == FACTOR) return report_plan<FACTOR, true>(a, plan);
    if (grid == LIMITED) return report_plan<LIMITED, true>(a, plan);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid == PLAIN) return report_plan<PLAIN, false>(a, plan);
  if (grid == FACTOR) return report_plan<FACTOR, false>(a, plan);
  if (grid == LIMITED) return report_plan<LIMITED, false>(a, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}
