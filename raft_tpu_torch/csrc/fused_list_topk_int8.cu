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
// 96, a store padded to its largest list, k 40) the live rows' int8
// multiply-adds with the lists' real slots, at the tensor cores' int8
// rate, take less time than the bytes of the live rows, the real slots
// and the outputs: bytes bound it.
//
// Design: list_scan_tc.cuh, with int8 operands: wgmma m64n16k32 s8 x s8
// -> s32, exact in any order, so the kernel equals its plain version bit
// for bit. With rot % 16 == 0 the list's tiles arrive by TMA (boxes of
// 128 columns x 64 slots, 128-byte swizzled, zeros past rot) into a ring
// of two stages, two tiles in flight; other widths are staged byte by
// byte. The rest is fused_list_topk's: blocks past a chunk's live rows
// exit, the scan stops at the list's last slot whose base is not +inf,
// +inf tiles before it skip their products, and each row keeps a running
// exact top k.
#include "list_scan_tc.cuh"

namespace rtt {

// TMA: the store arrives by TMA (rot % 16 == 0), else byte by byte.
template <int CAP, bool TMA>
__global__ void __launch_bounds__(kThreads, list_tc_min_blocks(CAP))
    list_kernel_i8(const __grid_constant__ CUtensorMap smap, const int* __restrict__ lof,
                   const int8_t* __restrict__ q8, const int8_t* __restrict__ store,
                   const float* __restrict__ base, const float* __restrict__ q_scale,
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
  const int nkc = tc_chunks(rot, true);
  const TcLayout lay(smem_raw, nkc, TMA ? kI8Stages : 1);
  const float* lbase = base + (size_t)list * L;
  const size_t q0 = (size_t)c * chunk + row0;
  std::conditional_t<TMA, TmaStage, RegStageI8> stage =
      make_i8_stage<TMA>(&smap, lay, store + (size_t)list * L * rot, nkc, list * L, rot, L);
  // the loads that need nothing first: tile 0, the query rows and scales, the base row
  stage.first();
  stage_query_i8(lay.q, q8 + q0 * rot, live, rot, nkc);
  const int t = threadIdx.x;
  if (t < kRows) lay.rs[t] = t < live ? q_scale[q0 + t] : 0.f;
  const int nscan = scan_extent(lbase, L, reinterpret_cast<int*>(lay.sc));
  const TileOrder<TopKEpi<CAP>::kEvensFirst> ord(nscan);
  stage.start(nscan, ord);
  fence_proxy_async();  // the query rows, for wgmma
  __syncthreads();
  TopKEpi<CAP> epi(lay, live, k, kbuf, L, nscan, vals + out0, idx + out0);
  list_scan_tc<true>(lay, stage, ord, lbase, nscan, tc_ksteps(rot, true), coef, epi);
}

}  // namespace rtt

// live_rows (ncb,) or null: rows at or past live_rows[i] of chunk i hold
// (+inf, 2^31-1) and cost no work. n_lists: the store's first dimension.
// Returns the launch's cudaError_t.
extern "C" int fused_list_topk_int8_launch(const void* lof, const void* q8, const void* store,
                                           const void* base, const void* q_scale,
                                           const void* live_rows, void* vals, void* idx,
                                           int ncb, int chunk, int rot, int L, int n_lists, int k,
                                           int kbuf, int inner_product, void* stream) {
  using namespace rtt;
  if (ncb == 0 || chunk == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k || L % kTileSlots != 0) return (int)cudaErrorInvalidValue;
  // whole 16-byte rows: the store as (n_lists * L, rot) bytes for TMA
  const bool tma = rot % 16 == 0;
  CUtensorMap smap;
  memset(&smap, 0, sizeof(smap));
  if (tma) {
    if (int err = encode_tensor_map_2d(&smap, CU_TENSOR_MAP_DATA_TYPE_UINT8, store, rot,
                                       (unsigned long long)n_lists * L, rot, 128, kHalfSlots))
      return err;
  }
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  return with_selection(k, [&](auto cap) {
    constexpr int CAP = decltype(cap)::value;
    const size_t smem = list_tc_smem_bytes(rot, true, tma ? kI8Stages : 1, CAP);
    const auto kernel = tma ? list_kernel_i8<CAP, true> : list_kernel_i8<CAP, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        smap, static_cast<const int*>(lof), static_cast<const int8_t*>(q8),
        static_cast<const int8_t*>(store), static_cast<const float*>(base),
        static_cast<const float*>(q_scale), static_cast<const int*>(live_rows),
        static_cast<float*>(vals), static_cast<int*>(idx), chunk, rot, L, k, kbuf,
        inner_product ? 1.f : 2.f);
    return (int)cudaGetLastError();
  });
}
