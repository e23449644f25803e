// fused_list_topk_int8: list-major fused int8 distance + exact top-k for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_list_topk_int8
// (_make_list_kernel_int8 :463, pallas_call at :575). The contract is
// fused_list_topk's (fused_list_topk.cu) with int8 operands: for each
// chunk i of int8 query rows it scores every slot of the one list lof[i]
// of an int8 store, idot = <q8, v> in int32, then
// score = base - c * (f32(idot) * q_scale[row]) (c = 2 for L2, 1 for inner
// product; base = +inf on invalid slots), rounded as the reference rounds
// it (fused_common.cuh: int8_score), and writes the k lexicographically
// smallest (score, slot) pairs per row, best-first, into a (chunk, kbuf)
// buffer padded with (+inf, 2^31-1).
//
// What bounds it on the H100: at the IVF-PQ trim shape (chunk 128, rot
// 96, a store lane-padded to its largest list) each chunk does
// chunk * L * rot int8 multiply-adds on operands read once, far above the
// card's bytes-to-operations line, so arithmetic bounds it. This version
// takes the dots with __dp4a on the CUDA cores (four int8 products a
// lane an instruction, not the tensor cores), so it sits well below that
// bound.
//
// Design: fused_common.cuh's scan_topk_dots with the Int8Dots policy. A
// block stages its query rows and their scales once and each 128-slot
// store tile over the whole depth as bytes (one contiguous run of 16-byte
// words when rot % 16 == 0), so a tile costs two barriers; int32 sums are
// exact in any order. The rest is fused_list_topk's: blocks past a
// chunk's live rows exit, +inf tiles skip their dots, and each row keeps a
// running exact top-k in its warp's registers.
#include "fused_common.cuh"

namespace rtt {

// Three blocks per SM (at most 80 registers a thread), as fused_list_topk.
template <int KR>
__global__ void __launch_bounds__(kThreads, 3)
    list_kernel_i8(const int* __restrict__ lof, const int8_t* __restrict__ q8,
                   const int8_t* __restrict__ store, const float* __restrict__ base,
                   const float* __restrict__ q_scale, const int* __restrict__ live_rows,
                   float* __restrict__ vals, int* __restrict__ idx, int chunk, int rot, int L,
                   int k, int kbuf, bool ip) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kbuf;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kbuf, kSentinel);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const size_t q0 = (size_t)c * chunk + row0;
  float* sc = reinterpret_cast<float*>(smem4);
  Int8Dots dots(sc + kRows * kTileSlots, q8 + q0 * rot, q_scale + q0, live, rot, ip);
  scan_topk_dots<KR>(sc, dots, live, store + (size_t)list * L * rot, base + (size_t)list * L, L,
                     k, kbuf, vals + out0, idx + out0);
}

}  // namespace rtt

// live_rows (ncb,) or null: rows at or past live_rows[i] of chunk i hold
// (+inf, 2^31-1) and cost no work. Returns the launch's cudaError_t.
extern "C" int fused_list_topk_int8_launch(const void* lof, const void* q8, const void* store,
                                           const void* base, const void* q_scale,
                                           const void* live_rows, void* vals, void* idx,
                                           int ncb, int chunk, int rot, int L, int k, int kbuf,
                                           int inner_product, void* stream) {
  using namespace rtt;
  if (ncb == 0 || chunk == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k) return (int)cudaErrorInvalidValue;
  const size_t smem = topk_smem_bytes<Int8Dots>(rot);
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  return with_list_width(k, [&](auto kr) {
    constexpr int KR = decltype(kr)::value;
    cudaError_t err = cudaFuncSetAttribute(
        list_kernel_i8<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    list_kernel_i8<KR><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lof), static_cast<const int8_t*>(q8),
        static_cast<const int8_t*>(store), static_cast<const float*>(base),
        static_cast<const float*>(q_scale), static_cast<const int*>(live_rows),
        static_cast<float*>(vals), static_cast<int*>(idx), chunk, rot, L, k, kbuf,
        inner_product != 0);
    return (int)cudaGetLastError();
  });
}
