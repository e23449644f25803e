// fused_l2_argmin: fused L2 distance + argmin (1-NN) for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_l2_argmin.py:
// fused_l2_argmin_pallas (_make_kernel :40, pallas_call at :114, lane
// reduction :132-141). For each row i of an f32 (m, k) x, the row j of an
// f32 (n, k) y minimizing d_ij = max(xn_i + (yn_j + <x_i, y2_j>), 0) with
// y2 = -2y (exact) and xn, yn the squared row norms (the augmented
// product [x, 1] . [-2y, yn]): the (m,) minimum, its sqrt if asked, and
// the (m,) int32 index. The clamp comes before the comparison, so every
// candidate that rounds below zero ties at 0.0 and the lowest index wins;
// the lowest index wins every exact tie. The (m, n) distances never reach
// device memory.
//
// What bounds it on the H100: 2 m n (k + 1) f32 operations (multiply-adds
// on the CUDA cores, 66.9 TFLOP/s with an FMA as two; no TF32, as the
// reference multiplies at Precision.HIGHEST), against (m + n) k 4 input
// bytes. At the k-means labelling shape (1M x 1024 x 96) the operations
// bound it. Emulated f32 on the tensor cores is later work.
//
// Design: a SIMT f32 tile product. A block owns 128 rows of x and walks
// all n columns in 128-wide tiles; its 256 threads stage 16-deep slices of
// the x and y2 rows in shared memory (depth major, stride 129 floats) and
// each thread keeps an 8 x 8 register tile of dots for rows ty + 16 i and
// columns tx + 16 j, started at yn_j. After a tile each thread folds its
// columns, in ascending order with a strict <, into one running (best,
// index) per row; the 16 threads of a row then reduce on (distance,
// index) in lexicographic order by shuffles. No atomics: the result is
// deterministic. The first candidate a thread sees always enters (so a
// row whose distances are all +inf reports index 0, as the reference's
// argmin does); columns past n never enter, rows past m are not stored.
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rfl {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kSide = 16;
constexpr int kTile = 128;          // x rows per block, y rows per tile
constexpr int kPer = kTile / kSide; // rows and columns per thread
constexpr int kKStep = 16;          // depth per staged slice
constexpr int kStride = kTile + 1;  // floats per staged depth row
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 2)
    l2_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y2,
                     const float* __restrict__ xn, const float* __restrict__ yn,
                     float* __restrict__ dist, int* __restrict__ idx, int m, int n, int k,
                     int take_sqrt) {
  __shared__ float xs[kKStep][kStride];
  __shared__ float ys[kKStep][kStride];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int row0 = blockIdx.x * kTile;
  float xr[kPer], best[kPer];
  int bidx[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + kSide * i;
    xr[i] = r < m ? xn[r] : 0.f;
    best[i] = CUDART_INF_F;
    bidx[i] = -1;  // no candidate yet
  }

  for (int col0 = 0; col0 < n; col0 += kTile) {
    float acc[kPer][kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + kSide * j;
      const float ynj = c < n ? yn[c] : 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i][j] = ynj;
    }
    for (int k0 = 0; k0 < k; k0 += kKStep) {
      // zeros past k add exact zeros to the dots
      for (int e = threadIdx.x; e < kTile * kKStep; e += kThreads) {
        const int r = e / kKStep, c = e % kKStep, kc = k0 + c;
        const bool in_k = kc < k;
        xs[c][r] = (in_k && row0 + r < m) ? x[(size_t)(row0 + r) * k + kc] : 0.f;
        ys[c][r] = (in_k && col0 + r < n) ? y2[(size_t)(col0 + r) * k + kc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKStep; ++kk) {
        float a[kPer], b[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) a[i] = xs[kk][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kPer; ++j) b[j] = ys[kk][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    // fold this tile's columns, ascending, strict <, after the clamp
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + kSide * j;
      if (c >= n) break;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float d = fmaxf(xr[i] + acc[i][j], 0.f);
        if (bidx[i] < 0 || d < best[i]) {
          best[i] = d;
          bidx[i] = c;
        }
      }
    }
  }

  // the 16 threads of a row (lanes tx of one half-warp): lexicographic min
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float v = bidx[i] < 0 ? CUDART_INF_F : best[i];
    int id = bidx[i] < 0 ? INT_MAX : bidx[i];
#pragma unroll
    for (int off = kSide / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oid = __shfl_xor_sync(kFull, id, off);
      if (ov < v || (ov == v && oid < id)) {
        v = ov;
        id = oid;
      }
    }
    const int r = row0 + ty + kSide * i;
    if (tx == 0 && r < m) {
      dist[r] = take_sqrt ? sqrtf(v) : v;
      idx[r] = id;
    }
  }
}

}  // namespace rfl

// Returns the launch's cudaError_t.
extern "C" int fused_l2_argmin_launch(const void* x, const void* y2, const void* xn,
                                      const void* yn, void* dist, void* idx, int m, int n,
                                      int k, int take_sqrt, void* stream) {
  using namespace rfl;
  if (m == 0) return 0;
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)m + kTile - 1) / kTile);
  l2_argmin_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y2),
      static_cast<const float*>(xn), static_cast<const float*>(yn), static_cast<float*>(dist),
      static_cast<int*>(idx), m, n, k, take_sqrt);
  return (int)cudaGetLastError();
}
