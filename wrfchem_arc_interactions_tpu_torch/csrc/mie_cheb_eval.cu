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
// one bin of config 3's 30 bands x 500,000 cells (107 us at 3.35 TB/s),
// against ~1,000 float operations per element counting only the four live
// columns (15 GFLOP, 0.23 ms at 67 TFLOP/s): operations set the bound.
//
// Design: the TPU kernel's dense 80-wide product and its 3-pass bf16 split
// were workarounds for the TPU's compiler; here one thread evaluates one
// element.  Each block copies G (28.8 KB) into shared memory once and walks
// a grid-stride loop.  A thread takes the floor cell and the two hat
// weights on each axis (at most two weights per axis are non-zero, so only
// four of the 80 columns are live), forms the 90 coefficients from those
// four columns in float32 and runs the three 30-term Clenshaw recurrences
// in registers.  The cell index is clamped to [0, 6] x [0, 8]: nr_n = 1 or
// u = 1 lands on the top node with weight 1 on the upper node, as the hat
// weights give it.  The library is built with --fmad=false, so the
// Clenshaw steps round where the plain version's do; the coefficient sums
// may differ from the plain version's matrix product in summation order.

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 30;           // Chebyshev terms per table
constexpr int NNR = 8;            // refractive-index grid nodes
constexpr int NNI = 10;           // absorption grid nodes
constexpr int NW = NNR * NNI;     // 80 columns of G
constexpr int NROW = 3 * NCH;     // 90 rows of G
constexpr int THREADS = 256;

__device__ __forceinline__ float hat(float s) { return fmaxf(0.0f, 1.0f - fabsf(s)); }

__global__ void __launch_bounds__(THREADS)
mie_cheb_eval_kernel(const float* __restrict__ G, const float* __restrict__ nr,
                     const float* __restrict__ u, const float* __restrict__ t,
                     float* __restrict__ qe, float* __restrict__ qs,
                     float* __restrict__ gout, long long n) {
  __shared__ float gs[NROW * NW];
  for (int i = threadIdx.x; i < NROW * NW; i += blockDim.x) gs[i] = G[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const float fr = nr[e] * (float)(NNR - 1);
    const float fi = u[e] * (float)(NNI - 1);
    // floor cell, clamped before the integer cast (NaN maps to cell 0)
    const int ja = (int)fminf(fmaxf(floorf(fr), 0.0f), (float)(NNR - 2));
    const int jb = (int)fminf(fmaxf(floorf(fi), 0.0f), (float)(NNI - 2));
    const float wa0 = hat(fr - (float)ja);
    const float wa1 = hat(fr - (float)(ja + 1));
    const float wb0 = hat(fi - (float)jb);
    const float wb1 = hat(fi - (float)(jb + 1));
    const float w00 = wa0 * wb0;
    const float w01 = wa0 * wb1;
    const float w10 = wa1 * wb0;
    const float w11 = wa1 * wb1;
    const int c00 = ja * NNI + jb;
    const float tt = t[e];
    const float t2 = 2.0f * tt;

    float res[3];
#pragma unroll
    for (int tab = 0; tab < 3; ++tab) {
      float b0 = 0.0f, b1 = 0.0f, c0 = 0.0f;
#pragma unroll 6
      for (int k = NCH - 1; k >= 0; --k) {
        const float* row = gs + (tab * NCH + k) * NW + c00;
        const float ck = row[0] * w00 + row[1] * w01 + row[NNI] * w10 + row[NNI + 1] * w11;
        const float nb0 = t2 * b0 - b1 + ck;
        b1 = b0;
        b0 = nb0;
        c0 = ck;  // the last assignment is k = 0
      }
      res[tab] = b0 - tt * b1 - 0.5f * c0;
    }
    qe[e] = res[0];
    qs[e] = res[1];
    gout[e] = res[2];
  }
}

}  // namespace

// Launches `blocks` blocks on `stream` and returns cudaGetLastError().
extern "C" int mie_cheb_eval(const float* G, const float* nr_n, const float* u,
                             const float* t, float* ln_qext, float* ln_qsca,
                             float* g_raw, long long n, int blocks, void* stream) {
  mie_cheb_eval_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      G, nr_n, u, t, ln_qext, ln_qsca, g_raw, n);
  return static_cast<int>(cudaGetLastError());
}
