// fused_list_topk: list-major fused distance + exact top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_list_topk
// (_make_list_kernel, pallas_call at :443, epilogue _extract_topk :136).
// For each chunk i of query rows it scores every slot of the one list
// lof[i] of a slot-table store, score = base - c * <q, v> (c = 2 for L2,
// 1 for inner product; base = +inf on invalid slots), and writes the k
// lexicographically smallest (score, slot) pairs per row, best-first,
// into a (chunk, kbuf) buffer padded with (+inf, 2^31-1).
//
// What bounds it on the H100: on the IVF-PQ main path (chunk 128, rot 96,
// an int8 store lane-padded to its largest list) each chunk does
// chunk * L * rot multiply-adds on operands read once from device
// memory; per byte that is far above the card's bytes-to-operations
// line, so arithmetic bounds it. This version runs the dots on the CUDA
// cores in f32 (not the tensor cores), so it sits well below that bound.
//
// Design: Hopper has no scalar prefetch, so each block reads lof[i] and
// its chunk's live-row count itself. A chunk's live rows are a prefix
// (the inverted probe pairs fill chunks from the front), so a block past
// them writes (+inf, sentinel) and returns: at n_probes 8 about three
// quarters of the 128 rows of a chunk are padding, and an empty chunk
// (the wrapper's chunk_valid == 0) has none live. One block owns (chunk i,
// kRows query rows) and runs fused_common.cuh's scan_topk over the list:
// slot tiles are staged in shared memory and scored, tiles of pad slots
// (+inf base: the store is padded to its LARGEST list, so most of a
// typical list's slots are pad) skip their dots, and each row keeps a
// running exact top-k in its warp's registers, so neither the scores nor
// a (rows, L) strip need to be held.
#include "fused_common.cuh"

namespace rtt {

// Three blocks per SM (at most 80 registers a thread): the trim's blocks
// are short and many, and with one or two resident per SM their staging
// barriers leave the SM idle.
template <typename T, int KR>
__global__ void __launch_bounds__(kThreads, 3)
    list_kernel(const int* __restrict__ lof, const float* __restrict__ qres,
                const T* __restrict__ store, const float* __restrict__ base,
                const int* __restrict__ live_rows, float* __restrict__ vals,
                int* __restrict__ idx, int chunk, int rot, int L, int k, int kbuf,
                float coef) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kbuf;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kbuf, kSentinel);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  scan_topk<T, KR>(reinterpret_cast<float*>(smem4), qres + ((size_t)c * chunk + row0) * rot,
                   live, store + (size_t)list * L * rot, base + (size_t)list * L, L, rot, k,
                   kbuf, coef, vals + out0, idx + out0);
}

template <typename T>
int launch(const int* lof, const float* qres, const void* store, const float* base,
           const int* live_rows, float* vals, int* idx, int ncb, int chunk, int rot, int L,
           int k, int kbuf, float coef, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(rot);
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  return with_list_width(k, [&](auto kr) {
    constexpr int KR = decltype(kr)::value;
    cudaError_t err = cudaFuncSetAttribute(
        list_kernel<T, KR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    list_kernel<T, KR><<<grid, kThreads, smem, stream>>>(
        lof, qres, static_cast<const T*>(store), base, live_rows, vals, idx, chunk, rot, L, k,
        kbuf, coef);
    return (int)cudaGetLastError();
  });
}

}  // namespace rtt

// store_kind: 0 int8, 1 bf16, 2 float32. live_rows (ncb,) or null: rows
// at or past live_rows[i] of chunk i hold (+inf, 2^31-1) and cost no work.
// Returns the launch's cudaError_t.
extern "C" int fused_list_topk_launch(const void* lof, const void* qres, const void* store,
                                      int store_kind, const void* base, const void* live_rows,
                                      void* vals, void* idx, int ncb, int chunk, int rot,
                                      int L, int k, int kbuf, int inner_product,
                                      void* stream) {
  if (ncb == 0 || chunk == 0) return 0;
  if (k < 1 || k > rtt::kMaxK || kbuf < k) return (int)cudaErrorInvalidValue;
  const float coef = inner_product ? 1.f : 2.f;
  const auto* lo = static_cast<const int*>(lof);
  const auto* q = static_cast<const float*>(qres);
  const auto* b = static_cast<const float*>(base);
  const auto* lr = static_cast<const int*>(live_rows);
  auto* v = static_cast<float*>(vals);
  auto* i = static_cast<int*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  switch (store_kind) {
    case 0:
      return rtt::launch<int8_t>(lo, q, store, b, lr, v, i, ncb, chunk, rot, L, k, kbuf, coef, s);
    case 1:
      return rtt::launch<__nv_bfloat16>(lo, q, store, b, lr, v, i, ncb, chunk, rot, L, k, kbuf,
                                        coef, s);
    case 2:
      return rtt::launch<float>(lo, q, store, b, lr, v, i, ncb, chunk, rot, L, k, kbuf, coef, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
