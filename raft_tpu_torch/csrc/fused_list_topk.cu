// fused_list_topk: list-major fused distance + exact top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_list_topk
// (_make_list_kernel, pallas_call at :443, epilogue _extract_topk :136).
// For each chunk i of query rows it scores every slot of the one list
// lof[i] of a slot-table store, score = base - c * <q, v> (c = 2 for L2,
// 1 for inner product; base = +inf on invalid slots), with q and v
// rounded to bf16 and f32 sums, and writes the k lexicographically
// smallest (score, slot) pairs per row, best-first, into a (chunk, kbuf)
// buffer padded with (+inf, 2^31-1).
//
// What bounds it on the H100: on the IVF-PQ trim (chunk 128, rot 96, an
// int8 store padded to its largest list, k 40) each chunk's live rows do
// rot multiply-adds with each real slot of the list; at the tensor cores'
// bf16 rate that is below the bytes of the live rows, the lists' real
// slots and the outputs, so bytes bound it. The refine (chunk 1, L 128,
// bf16 rows, k 10) is bytes too.
//
// Design: list_scan_tc.cuh, with bf16 operands. Each block reads lof[i]
// and its chunk's live-row count itself (Hopper has no scalar prefetch). A
// chunk's live rows are a prefix (the inverted probe pairs fill chunks
// from the front), so a block past them writes (+inf, sentinel) and
// returns: at n_probes 8 about three quarters of the 128 rows of a chunk
// are padding. One block owns (chunk i, kRows query rows): it scans its
// list only up to the last slot whose base is not +inf, multiplies each
// tile by wgmma m64n16k16 (store rows converted to bf16 as they are
// staged, the next tile held in registers meanwhile), and keeps each
// row's running exact top k (register lists to k 32, shared-memory lists
// past it), so neither the scores nor a (rows, L) strip are ever held.
#include "list_scan_tc.cuh"

namespace rtt {

template <typename T, int CAP>
__global__ void __launch_bounds__(kThreads, list_tc_min_blocks(CAP))
    list_kernel(const int* __restrict__ lof, const float* __restrict__ qres,
                const T* __restrict__ store, const float* __restrict__ base,
                const int* __restrict__ live_rows, float* __restrict__ vals,
                int* __restrict__ idx, int chunk, int rot, int L, int k, int kbuf,
                float coef) {
  extern __shared__ unsigned char smem_raw[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kbuf;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kbuf, kSentinel);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const int nkc = tc_chunks(rot, false);
  const TcLayout lay(smem_raw, nkc, 1);
  const float* lbase = base + (size_t)list * L;
  // the loads that need nothing first: tile 0's rows, the query rows, the base row
  RegStage<T> stage(lay.st, store + (size_t)list * L * rot, rot, L);
  stage.first();
  stage_query_bf16(lay.q, qres + ((size_t)c * chunk + row0) * rot, live, rot, nkc);
  const int nscan = scan_extent(lbase, L, reinterpret_cast<int*>(lay.sc));
  const TileOrder<TopKEpi<CAP>::kEvensFirst> ord(nscan);
  stage.start(nscan, ord);  // fences the query rows too, for wgmma
  __syncthreads();
  TopKEpi<CAP> epi(lay, live, k, kbuf, L, nscan, vals + out0, idx + out0);
  list_scan_tc<false>(lay, stage, ord, lbase, nscan, tc_ksteps(rot, false), coef, epi);
}

template <typename T>
int launch(const int* lof, const float* qres, const void* store, const float* base,
           const int* live_rows, float* vals, int* idx, int ncb, int chunk, int rot, int L,
           int k, int kbuf, float coef, cudaStream_t stream) {
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  return with_selection(k, [&](auto cap) {
    constexpr int CAP = decltype(cap)::value;
    const size_t smem = list_tc_smem_bytes(rot, false, 1, CAP);
    cudaError_t err = cudaFuncSetAttribute(
        list_kernel<T, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    list_kernel<T, CAP><<<grid, kThreads, smem, stream>>>(
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
  if (k < 1 || k > rtt::kMaxK || kbuf < k || L % rtt::kTileSlots != 0)
    return (int)cudaErrorInvalidValue;
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
