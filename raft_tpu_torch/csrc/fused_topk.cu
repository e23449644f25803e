// fused_topk: flat fused distance + exact top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_topk
// (_make_flat_kernel :170, pallas_call at :267, epilogue _extract_topk
// :136). Every query row x_i is scored against every dataset row y_j,
// score = base_j - c * <x_i, y_j> (c = 2 for L2 with base_j = |y_j|^2 of
// the bf16-rounded row, c = 1 and base 0 for inner product), and the k
// lexicographically smallest (score, j) pairs per query are written
// best-first into an (m, kbuf) buffer padded with (+inf, 2^31-1). The
// (m, n) score matrix never reaches device memory.
//
// What bounds it on the H100: brute-force ground truth on the main path
// (m 4096, n 1M, d 96) is m * n * d multiply-adds over operands read
// once, so arithmetic bounds it; this version does the dots on the CUDA
// cores in f32, not on the tensor cores, and stays well below that
// bound.
//
// Design: the TPU kernel carries its top-k buffer across a sequential
// grid axis, which Hopper blocks cannot do. Here one block owns kRows
// queries and loops over all n rows itself (fused_common.cuh's
// scan_topk), keeping each query's running top-k list in its warp's
// registers; a tile's scores enter only below the row's current k-th
// entry, which almost none do once the list has filled. 4096 queries
// make 256 blocks, about two per SM, so one launch fills the card
// without splitting n.
#include "fused_common.cuh"

namespace rtt {

template <int KR>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ base, float* __restrict__ vals,
                int* __restrict__ idx, int m, int n, int d, int k, int kbuf, float coef) {
  extern __shared__ float4 smem4[];
  const int row0 = blockIdx.x * kRows;
  scan_topk<__nv_bfloat16, KR>(reinterpret_cast<float*>(smem4), x + (size_t)row0 * d,
                               min(kRows, m - row0), y, base, n, d, k, kbuf, coef,
                               vals + (size_t)row0 * kbuf, idx + (size_t)row0 * kbuf);
}

}  // namespace rtt

// Returns the launch's cudaError_t.
extern "C" int fused_topk_launch(const void* x, const void* y, const void* base, void* vals,
                                 void* idx, int m, int n, int d, int k, int kbuf,
                                 int inner_product, void* stream) {
  using namespace rtt;
  if (m == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes(d);
  const dim3 grid((m + kRows - 1) / kRows);
  return with_list_width(k, [&](auto kr) {
    constexpr int KR = decltype(kr)::value;
    cudaError_t err = cudaFuncSetAttribute(flat_kernel<KR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flat_kernel<KR><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(y),
        static_cast<const float*>(base), static_cast<float*>(vals), static_cast<int*>(idx), m,
        n, d, k, kbuf, inner_product ? 1.f : 2.f);
    return (int)cudaGetLastError();
  });
}
