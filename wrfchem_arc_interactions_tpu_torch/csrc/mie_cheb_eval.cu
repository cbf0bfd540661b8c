// Fast-Mie Chebyshev evaluator, for Hopper (sm_90a).
//
// Replaces the TPU kernel `wrfchem_arc_interactions_tpu/ops/pallas_mie.py::
// cheb_eval_pallas` (body in `_eval_fn`), which computes the same function
// as `chem/optics.py::_cheb_eval_bands(G, nr_n, u, t)`: for every element of
// the flattened (band, cell) axis, from the normalised refractive index
// nr_n in [0, 1], absorption u in [0, 1] and Chebyshev argument t in [-1, 1],
//
//   w[a*10+b]  = max(0, 1-|7 nr_n - a|) * max(0, 1-|9 u - b|)   (80 hat weights)
//   c[r]       = sum_j G[r, j] w[j]                             (r < 90)
//   out_i      = Clenshaw(c[30 i .. 30 i + 29], t)              (i = 0, 1, 2)
//
// giving (ln Q_ext, ln Q_sca, g_raw).  G is the (90, 80) float32 matrix of
// chem/mie.py::build_grid_matrix.
//
// Bound: 24 bytes per element (three inputs, three outputs), 360 MB for
// one bin of 30 bands x 500,000 cells (107 us at 3.35 TB/s), against ~935
// float operations per element counting only the four live columns
// (14 GFLOP, 0.21 ms at 67 TFLOP/s): on paper operations set the bound.
// What set the first design's time on the card was the shared-memory
// pipe, one wavefront a clock per SM (NVIDIA H100 80GB HBM3, 700 W;
// scripts/kernel_ab_gpu.py): it read four 4-byte words of G per
// coefficient, 360 loads an element, 0.73 ms where a warp's lanes share a
// floor cell and 1.51 ms on random inputs, whose lanes' reads conflict.
//
// Design: one thread evaluates one element at a time, on a persistent grid
// of BLOCKS_PER_SM blocks per SM that walks tiles of TILE elements.
//
// - Packed corner table.  At most two hat weights per axis are non-zero, so
//   an element reads four columns of G: those of its floor cell (ja, jb),
//   ja in [0, 6], jb in [0, 8].  The host packs, for each of the 63 cells
//   and each of the 90 rows, the four entries G[r, c00], G[r, c00 + 1],
//   G[r, c00 + 10], G[r, c00 + 11] (c00 = 10 ja + jb) into one float4, in
//   the order of the weights w00, w01, w10, w11 (ops/mie_kernel.py::
//   packed_table).  A coefficient is then one 16-byte shared-memory load
//   instead of four 4-byte ones: 90 loads per element.  A warp's load takes
//   one pass when its distinct addresses fall in different 16-byte bank
//   groups: when its lanes share a cell (a broadcast) or each of its
//   quarter-warps shares one, as config 4's own inputs mostly do (0.42 ms
//   on those, on warp-coherent inputs, and on runs of 8 elements in one
//   cell).
// - Each cell is padded to CELL_STRIDE = 91 float4s, an odd count, so that
//   neighbouring cells fall in different bank groups (an even stride of 90
//   was 27% slower on the runs of 8, a probe not kept).  The table (63 x
//   91 x 16 B = 91,728 B) is dynamic shared memory, filled once per block
//   by 16-byte asynchronous copies (cp.async.cg); two blocks fit an SM
//   with their tile staging.
// - Tile sort.  On random inputs a quarter-warp's lanes fall in up to 8
//   cells whose loads conflict (1.58 ms with the table alone, slower than
//   the first design).  So a tile in which more than SORT_MIN of the
//   quarter-warps span more than one cell is sorted by cell before it is
//   evaluated: a counting sort in shared memory (a histogram by atomics, a
//   scan by one warp, a permutation), the inputs and then the results staged
//   there, so that the loads and stores of device memory stay coalesced.
//   Sorted, a quarter-warp's lanes share a cell or two neighbouring ones:
//   0.69 ms on random inputs.  A tile whose quarter-warps mostly share a
//   cell skips the sort, which would cost it 0.06-0.10 ms (a probe with
//   every tile sorted: 0.48 ms on the runs of 8, 0.52 ms on coherent
//   inputs).
// - The three Clenshaw recurrences run side by side in registers (three
//   independent chains per step), and each step of a chain is five fused
//   multiply-adds: c_k - b_{k+2} is built onto the four weighted corners,
//   then 2 t b_{k+1} is added.  The last step folds the closing formula:
//   out = c_0 / 2 + t b_1 - b_2.  The next tile's inputs are loaded while
//   the current one is evaluated.
//
// What bounds this design is instruction issue, not the shared-memory pipe
// (probes, not kept): two elements of one cell sharing each table load
// took as long, and 24 or 32 warps an SM in blocks of 768 or 1,024
// threads with fewer registers each took longer (0.43-0.49 ms).  The SASS
// issues ~465 fused multiply-adds, 90 table loads and ~45 other
// instructions an element, ~600 in all: at 4 instructions a clock per SM
// that is 0.27-0.30 ms for 15 M elements at 1.98-1.755 GHz, and the 0.42
// ms measured is 65-72% of it.  Operations still set the bound above.
//
// Arithmetic: the library is built with multiply-add contraction (without
// --fmad=false, ops/build.py) and the recurrences call fmaf, so the result
// differs from the plain version's (a matrix product, then unfused
// Clenshaw steps) by a few float32 roundings of ln Q (|ln Q| up to ~30);
// the card's comparison holds it to 3.2e-4, the bound the TPU kernel was
// held to.  Clamping is as in the plain version's hat weights: the cell
// index is clamped to [0, 6] x [0, 8] before the integer cast (NaN maps to
// cell 0), so nr_n = 1 or u = 1 lands on the top node with weight 1.  An
// element's result does not depend on the path or the order of its tile.

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 30;                  // Chebyshev terms per table
constexpr int NNR = 8;                   // refractive-index grid nodes
constexpr int NNI = 10;                  // absorption grid nodes
constexpr int CELLS = (NNR - 1) * (NNI - 1);   // 63 floor cells
constexpr int CELL_STRIDE = 91;          // float4s per cell: 90 rows and 1 of padding
constexpr int TABLE_BYTES = CELLS * CELL_STRIDE * 16;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int EPT = 4;                   // elements of a tile per thread
constexpr int TILE = THREADS * EPT;      // elements of a tile
constexpr int SORT_MIN = 16;             // a tile is sorted when more of its quarter-warps are mixed
constexpr int HIST = 64;                 // counters of the cell histogram (63 used)
// dynamic shared memory: the table, the tile's three staged inputs (then
// outputs), its permutation, the histogram and its exclusive scan
constexpr int SMEM_BYTES = TABLE_BYTES + 3 * TILE * 4 + TILE * 2 + 2 * HIST * 4;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE <= 65536, "the permutation is 16-bit");
static_assert(THREADS % 32 == 0 && EPT <= 8, "a warp's lanes flag its quarter-warps");

__device__ __forceinline__ float hat(float s) { return fmaxf(0.0f, 1.0f - fabsf(s)); }

// Asynchronous 16-byte copy from device to shared memory; every copy of the
// block has landed after `copies_land` and a barrier.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_land() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The floor cell 9 ja + jb of an element, clamped before the integer cast
// (NaN maps to cell 0).
__device__ __forceinline__ void floor_cell(float nr, float u, float& fr, float& fi, int& ja,
                                           int& jb) {
  fr = nr * (float)(NNR - 1);
  fi = u * (float)(NNI - 1);
  ja = (int)fminf(fmaxf(floorf(fr), 0.0f), (float)(NNR - 2));
  jb = (int)fminf(fmaxf(floorf(fi), 0.0f), (float)(NNI - 2));
}

__device__ __forceinline__ int cell_of(float nr, float u) {
  float fr, fi;
  int ja, jb;
  floor_cell(nr, u, fr, fi, ja, jb);
  return ja * (NNI - 1) + jb;
}

// One element: the four live hat weights, then the three recurrences side
// by side, each coefficient one 16-byte load of the packed table.
__device__ __forceinline__ void evaluate(const float4* __restrict__ tab, float nr, float u,
                                         float t, float& qe, float& qs, float& g) {
  float fr, fi;
  int ja, jb;
  floor_cell(nr, u, fr, fi, ja, jb);
  const float wa0 = hat(fr - (float)ja);
  const float wa1 = hat(fr - (float)(ja + 1));
  const float wb0 = hat(fi - (float)jb);
  const float wb1 = hat(fi - (float)(jb + 1));
  const float w00 = wa0 * wb0;
  const float w01 = wa0 * wb1;
  const float w10 = wa1 * wb0;
  const float w11 = wa1 * wb1;
  const float4* const cell = tab + (ja * (NNI - 1) + jb) * CELL_STRIDE;
  const float t2 = 2.0f * t;

  float b0[3] = {0.0f, 0.0f, 0.0f}, b1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = NCH - 1; k >= 1; --k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 c = cell[i * NCH + k];
      float acc = fmaf(w00, c.x, -b1[i]);        // c_k - b_{k+2}
      acc = fmaf(w01, c.y, acc);
      acc = fmaf(w10, c.z, acc);
      acc = fmaf(w11, c.w, acc);
      b1[i] = b0[i];
      b0[i] = fmaf(t2, b0[i], acc);             // b_k
    }
  }
  float res[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 c = cell[i * NCH];
    float c0 = w00 * c.x;
    c0 = fmaf(w01, c.y, c0);
    c0 = fmaf(w10, c.z, c0);
    c0 = fmaf(w11, c.w, c0);
    res[i] = fmaf(t, b0[i], fmaf(0.5f, c0, -b1[i]));   // c_0/2 + t b_1 - b_2
  }
  qe = res[0];
  qs = res[1];
  g = res[2];
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
mie_cheb_eval_kernel(const float* __restrict__ table, const float* __restrict__ nr,
                     const float* __restrict__ u, const float* __restrict__ t,
                     float* __restrict__ qe, float* __restrict__ qs,
                     float* __restrict__ gout, long long n) {
  extern __shared__ __align__(16) float4 tab[];
  float* const stage = reinterpret_cast<float*>(tab + CELLS * CELL_STRIDE);   // [3][TILE]
  unsigned short* const perm = reinterpret_cast<unsigned short*>(stage + 3 * TILE);
  int* const hist = reinterpret_cast<int*>(perm + TILE);
  int* const off = hist + HIST;
  const int tid = threadIdx.x, lane = tid & 31;
  {
    float* const tab_f = reinterpret_cast<float*>(tab);
    for (int c = tid; c < CELLS * CELL_STRIDE; c += THREADS)
      copy_async16(tab_f + 4 * c, table + 4 * c);
  }
  if (tid < HIST) hist[tid] = 0;
  copies_land();
  __syncthreads();

  const long long tiles = (n + TILE - 1) / TILE;
  float nr_n[EPT], u_n[EPT], t_n[EPT];        // the next tile's inputs
  auto fetch = [&](long long tile) {
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const long long e = tile * TILE + s * THREADS + tid;
      const bool in = tile < tiles && e < n;
      nr_n[s] = in ? nr[e] : 0.0f;
      u_n[s] = in ? u[e] : 0.0f;
      t_n[s] = in ? t[e] : 0.0f;
    }
  };
  fetch(blockIdx.x);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * TILE;
    float nr_e[EPT], u_e[EPT], t_e[EPT];
    int cell[EPT];
    // lane 4 s + q flags quarter q of this warp's run s if its 8 lanes span
    // more than one cell: a 16-byte shared-memory load serves a quarter-warp
    // in one wavefront when its lanes read one address
    bool mixed_quarter = false;
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      nr_e[s] = nr_n[s];
      u_e[s] = u_n[s];
      t_e[s] = t_n[s];
      cell[s] = cell_of(nr_e[s], u_e[s]);
      const unsigned differs =
          __ballot_sync(FULL, cell[s] != __shfl_sync(FULL, cell[s], lane & ~7));
      if ((lane >> 2) == s) mixed_quarter = (differs >> (8 * (lane & 3))) & 0xffu;
    }
    fetch(tile + gridDim.x);
    const int mixed_quarters = __syncthreads_count(mixed_quarter);
    if (mixed_quarters <= SORT_MIN) {
      // the quarter-warps' lanes mostly share a cell: a table load is one
      // wavefront a quarter-warp
#pragma unroll
      for (int s = 0; s < EPT; ++s) {
        const long long e = base + s * THREADS + tid;
        float a, b, c;
        evaluate(tab, nr_e[s], u_e[s], t_e[s], a, b, c);
        if (e < n) {
          qe[e] = a;
          qs[e] = b;
          gout[e] = c;
        }
      }
      continue;
    }
    // Sort the tile's elements by cell (a counting sort in shared memory)
    // and evaluate them in that order, so that a warp's lanes share one or
    // two cells; the results go back through shared memory.
    int rank[EPT];
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int loc = s * THREADS + tid;
      rank[s] = atomicAdd(&hist[cell[s]], 1);
      stage[loc] = nr_e[s];
      stage[TILE + loc] = u_e[s];
      stage[2 * TILE + loc] = t_e[s];
    }
    __syncthreads();
    if (tid < 32) {                           // exclusive scan of the histogram
      const int h0 = hist[2 * lane], h1 = hist[2 * lane + 1];
      int incl = h0 + h1;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      off[2 * lane] = incl - h0 - h1;
      off[2 * lane + 1] = incl - h1;
      hist[2 * lane] = 0;
      hist[2 * lane + 1] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < EPT; ++s) perm[off[cell[s]] + rank[s]] = (unsigned short)s * THREADS + tid;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      // element `loc` is read and its results written by this thread only
      const int loc = perm[s * THREADS + tid];
      float a, b, c;
      evaluate(tab, stage[loc], stage[TILE + loc], stage[2 * TILE + loc], a, b, c);
      stage[loc] = a;
      stage[TILE + loc] = b;
      stage[2 * TILE + loc] = c;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int loc = s * THREADS + tid;
      const long long e = base + loc;
      if (e < n) {
        qe[e] = stage[loc];
        qs[e] = stage[TILE + loc];
        gout[e] = stage[2 * TILE + loc];
      }
    }
    // the next tile writes the stage only after its __syncthreads_count
  }
}

}  // namespace

// `table` is the packed corner table (CELLS x CELL_STRIDE float4s, 16-byte
// aligned).  Launches `blocks` blocks on `stream` and returns the first
// CUDA error (0 on success).
extern "C" int mie_cheb_eval(const float* table, const float* nr_n, const float* u,
                             const float* t, float* ln_qext, float* ln_qsca,
                             float* g_raw, long long n, int blocks, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      mie_cheb_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mie_cheb_eval_kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(table, nr_n, u, t, ln_qext, ln_qsca, g_raw, n);
  return static_cast<int>(cudaGetLastError());
}

// The launch constants and the table's layout: {threads per block, blocks
// per SM, elements of a tile, float4s per cell of the packed table,
// dynamic shared memory of a block in bytes}.
extern "C" void mie_cheb_eval_shape(int* shape) {
  shape[0] = THREADS;
  shape[1] = BLOCKS_PER_SM;
  shape[2] = TILE;
  shape[3] = CELL_STRIDE;
  shape[4] = SMEM_BYTES;
}
