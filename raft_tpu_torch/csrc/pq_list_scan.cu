// pq_list_scan: list-major scan + bin fold for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/pq_list_scan.py:pq_list_scan
// (_make_kernel :170, _make_kernel_packed :111, pallas_call at :303). For
// each chunk i of query rows it scores every slot of the one list lof[i]
// of a slot-table store, score = base - c * <q, v> (bf16-rounded operands,
// f32 dots; or int8 rows x an int8 store, int32 dots and the per-row
// scale, rounded as fused_list_topk_int8 rounds them), and folds each
// row's L scores into 256 bins: slot j goes to lane j % 128 of bank
// (j / 128) % 2. Each bin keeps its best and second-best (score, slot), so
// a row writes 512 candidates, laid out [bank 0 best | bank 1 best |
// bank 0 second | bank 1 second], 128 each, as the reference lays them out
// (the engine's top-k over them breaks ties by position).
//
// Folds:
//   exact   per bin, best and second best under the strict-< rule of
//           pq_list_scan.py:216-225: ties keep the earlier fold (the
//           smaller slot); +inf never enters; never-filled entries are
//           (+inf, 0).
//   packed  per bin, the two smallest int32 packings of (bf16-coarse
//           order-preserving score image | fold id), pq_list_scan.py:74-
//           108 and :145-165, unpacked to the band's lower bound and the
//           slot; a fold id >= n_folds (never filled) becomes (+inf, 0). A
//           +inf score does take a bin here.
//
// What bounds it on the H100: at the IVF-PQ trim shape the contract's
// output alone, (ncb, chunk, 512) f32 + int32, is more bytes than the
// store it reads, so bytes bound it; the dots (chunk * L * rot
// multiply-adds a chunk, on the CUDA cores here) are the other term.
//
// Design: a 128-slot store tile is exactly one fold c, and its bank is
// c & 1. A block owns (chunk i, kRows query rows) and walks the list's
// even folds, then its odd folds: the bank's order inside each walk is the
// fold order the strict-< rule needs, and only one bank's state is held at
// a time. Thread t owns lane t % 128 of the tile and kRowsHalf query rows
// (fused_common.cuh's scoring policies put exactly that dot in its
// registers), so each thread folds its own scores straight into registers
// (best and second best, or two packed minima, per row) with no shared
// memory and no barrier, and writes its lane of the bank's candidates,
// 128 neighbouring threads on 128 neighbouring words. A tile whose base is
// +inf on every slot skips its dots, not its fold: its scores are +inf
// either way. Blocks past a chunk's live rows write (+inf, 0) and exit.
#include <climits>

#include "fused_common.cuh"

namespace rtt {

constexpr int kCands = 4 * kTileSlots;

// Exact fold: per (row, lane) of one bank, the best and second-best
// (score, slot) so far.
struct ExactBins {
  float v1[kRowsHalf], v2[kRowsHalf];
  int i1[kRowsHalf], i2[kRowsHalf];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r) {
      v1[r] = v2[r] = CUDART_INF_F;
      i1[r] = i2[r] = 0;
    }
  }
  __device__ __forceinline__ void add(int r, float x, int slot, int) {
    const bool best = x < v1[r];
    const bool second = !best && x < v2[r];
    v2[r] = best ? v1[r] : (second ? x : v2[r]);
    i2[r] = best ? i1[r] : (second ? slot : i2[r]);
    v1[r] = best ? x : v1[r];
    i1[r] = best ? slot : i1[r];
  }
  // row r's candidates of this bank into the row's output ov/oi
  __device__ __forceinline__ void write(int r, float* ov, int* oi, int bank, int lane, int) const {
    const int j = bank * kTileSlots + lane;
    ov[j] = v1[r];
    oi[j] = i1[r];
    ov[2 * kTileSlots + j] = v2[r];
    oi[2 * kTileSlots + j] = i2[r];
  }
};

// _pack_scores: the order-preserving uint32 image of the score, its high
// 16 bits kept, the fold id in the low 16, xor'd so that signed min is
// the packed order.
__device__ __forceinline__ int pack_score(float x, int fold) {
  const int i = __float_as_int(x);
  const int u = i < 0 ? ~i : (i | INT_MIN);
  return ((u & (int)0xffff0000) | fold) ^ INT_MIN;
}

// Packed fold: per (row, lane) of one bank, the two smallest packings.
struct PackedBins {
  int m1[kRowsHalf], m2[kRowsHalf];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r) m1[r] = m2[r] = INT_MAX;
  }
  __device__ __forceinline__ void add(int r, float x, int, int fold) {
    const int p = pack_score(x, fold);
    m2[r] = min(m2[r], max(m1[r], p));
    m1[r] = min(m1[r], p);
  }
  // _unpack_scores, then a fold id past the list (never filled) -> (+inf, 0)
  __device__ __forceinline__ static void unpack(int packed, int lane, int n_folds, float& v,
                                                int& slot) {
    const int p = packed ^ INT_MIN;
    const int fold = p & 0xffff;
    const int u = p & (int)0xffff0000;
    if (fold >= n_folds) {
      v = CUDART_INF_F;
      slot = 0;
      return;
    }
    v = __int_as_float(u < 0 ? (u & INT_MAX) : ~u);
    slot = fold * kTileSlots + lane;
  }
  __device__ __forceinline__ void write(int r, float* ov, int* oi, int bank, int lane,
                                        int n_folds) const {
    const int j = bank * kTileSlots + lane;
    unpack(m1[r], lane, n_folds, ov[j], oi[j]);
    unpack(m2[r], lane, n_folds, ov[2 * kTileSlots + j], oi[2 * kTileSlots + j]);
  }
};

// Three blocks per SM (at most 80 registers a thread), as the list
// kernels: the blocks are short and many.
template <class Dots, class Bins>
__global__ void __launch_bounds__(kThreads, 3)
    fold_kernel(const int* __restrict__ lof, const typename Dots::Query* __restrict__ q,
                const float* __restrict__ q_scale, const typename Dots::Store* __restrict__ store,
                const float* __restrict__ base, const int* __restrict__ live_rows,
                float* __restrict__ vals, int* __restrict__ idx, int chunk, int rot, int L,
                bool ip) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kCands;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kCands, 0);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const size_t q0 = (size_t)c * chunk + row0;
  Dots dots(smem4, q + q0 * rot, q_scale == nullptr ? nullptr : q_scale + q0, live, rot, ip);
  const typename Dots::Store* y = store + (size_t)list * L * rot;
  const float* bl = base + (size_t)list * L;
  const int s = threadIdx.x % kTileSlots, half = threadIdx.x / kTileSlots;
  const int n_folds = L / kTileSlots;

  for (int bank = 0; bank < 2; ++bank) {
    Bins bins;
    bins.init();
    for (int fold = bank; fold < n_folds; fold += 2) {
      const int t0 = fold * kTileSlots;
      const float b = bl[t0 + s];
      typename Dots::Acc acc[kRowsHalf];
#pragma unroll
      for (int r = 0; r < kRowsHalf; ++r) acc[r] = 0;
      // block-uniform, and a barrier
      if (__syncthreads_or(b != CUDART_INF_F)) dots.tile(acc, y, L, t0);
#pragma unroll
      for (int r = 0; r < kRowsHalf; ++r)
        bins.add(r, dots.score(b, acc[r], half * kRowsHalf + r), t0 + s, fold);
    }
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r) {
      const int row = half * kRowsHalf + r;
      if (row < live)
        bins.write(r, vals + out0 + (size_t)row * kCands, idx + out0 + (size_t)row * kCands, bank,
                   s, n_folds);
    }
  }
}

template <class Dots, class Bins>
int launch(const void* lof, const void* q, const void* q_scale, const void* store,
           const void* base, const void* live_rows, void* vals, void* idx, int ncb, int chunk,
           int rot, int L, bool ip, cudaStream_t stream) {
  const size_t smem = Dots::smem_bytes(rot);
  cudaError_t err = cudaFuncSetAttribute(fold_kernel<Dots, Bins>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  fold_kernel<Dots, Bins><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(lof), static_cast<const typename Dots::Query*>(q),
      static_cast<const float*>(q_scale), static_cast<const typename Dots::Store*>(store),
      static_cast<const float*>(base), static_cast<const int*>(live_rows),
      static_cast<float*>(vals), static_cast<int*>(idx), chunk, rot, L, ip);
  return (int)cudaGetLastError();
}

template <class Bins>
int launch_store(int store_kind, bool q_int8, const void* lof, const void* q,
                 const void* q_scale, const void* store, const void* base,
                 const void* live_rows, void* vals, void* idx, int ncb, int chunk, int rot, int L,
                 bool ip, cudaStream_t s) {
  if (q_int8)  // int8 rows need the int8 store
    return store_kind == 0 ? launch<Int8Dots, Bins>(lof, q, q_scale, store, base, live_rows, vals,
                                                    idx, ncb, chunk, rot, L, ip, s)
                           : (int)cudaErrorInvalidValue;
  switch (store_kind) {
    case 0:
      return launch<Bf16Dots<int8_t>, Bins>(lof, q, nullptr, store, base, live_rows, vals, idx,
                                            ncb, chunk, rot, L, ip, s);
    case 1:
      return launch<Bf16Dots<__nv_bfloat16>, Bins>(lof, q, nullptr, store, base, live_rows, vals,
                                                   idx, ncb, chunk, rot, L, ip, s);
    case 2:
      return launch<Bf16Dots<float>, Bins>(lof, q, nullptr, store, base, live_rows, vals, idx,
                                           ncb, chunk, rot, L, ip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rtt

// q: (ncb, chunk, rot) float32 rows, or int8 rows when q_scale (ncb,
// chunk) float32 is given (then the store must be int8). store_kind: 0
// int8, 1 bf16, 2 float32. live_rows (ncb,) or null: rows at or past
// live_rows[i] of chunk i hold (+inf, 0) and cost no work. packed: the
// packed fold, else the exact one. Returns the launch's cudaError_t.
extern "C" int pq_list_scan_launch(const void* lof, const void* q, const void* q_scale,
                                   const void* store, int store_kind, const void* base,
                                   const void* live_rows, void* vals, void* idx, int ncb,
                                   int chunk, int rot, int L, int inner_product, int packed,
                                   void* stream) {
  using namespace rtt;
  if (ncb == 0 || chunk == 0) return 0;
  if (L % kTileSlots != 0 || L / kTileSlots > 0xffff) return (int)cudaErrorInvalidValue;
  const bool ip = inner_product != 0, q_int8 = q_scale != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  if (packed)
    return launch_store<PackedBins>(store_kind, q_int8, lof, q, q_scale, store, base, live_rows,
                                    vals, idx, ncb, chunk, rot, L, ip, s);
  return launch_store<ExactBins>(store_kind, q_int8, lof, q, q_scale, store, base, live_rows, vals,
                                 idx, ncb, chunk, rot, L, ip, s);
}
