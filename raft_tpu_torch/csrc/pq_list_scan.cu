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
// output alone, (ncb, chunk, 512) f32 + int32 for every row, live or not,
// is most of the bytes (85% at n_probes 8); the dots (each live row
// against its list's real slots) take far less at the tensor cores' rate.
//
// Design: list_scan_tc.cuh's tensor-core scan (kernels 1 and 3's), with the
// fold as its epilogue (FoldEpi). A 128-slot tile is exactly one fold t, its
// bank t & 1. Thread tid's accumulators hold the same (slot lane, query row)
// pairs in every tile (acc_slot, acc_row), so each thread keeps its 8 bins of
// one bank in registers and folds its scores straight from the accumulators:
// no score tile in shared memory, no barrier for the fold. The block scans
// the even tiles and then the odd ones (one bank's state at a time: three
// blocks an SM but for one store type, below), each in slot order, which is
// the fold order the strict-< rule needs, and writes a bank's candidates when
// its last tile is folded: 8 neighbouring lanes on 32 neighbouring bytes of a
// row (whole sectors). The scan stops at the list's last slot whose base is
// not +inf (rounded up to 64, scan_extent); every later slot scores +inf, so
// the unscanned folds are filled by rule, bit for bit as the full scan would
// fill them: the exact fold never takes +inf, and the packed fold takes
// pack(+inf, f) for each unscanned fold f, of which only the two smallest of
// each bank can be among a bin's two minima. Blocks are ordered chunk-major
// with a chunk's row blocks adjacent, so the blocks past a chunk's live rows,
// which write (+inf, 0) and exit, spread over the whole launch beside the
// live ones.
#include <climits>

#include "list_scan_tc.cuh"

namespace rtt {

constexpr int kCands = 4 * kTileSlots;

// Exact fold: per bin (this thread's slot lane and query row of
// accumulator i, one bank), the best and second-best (score, fold) so far;
// the two folds share a register (fold ids fit 16 bits).
struct ExactBins {
  float v1[8], v2[8];
  unsigned f[8];  // the best's fold in the low half, the second's in the high

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v1[i] = v2[i] = CUDART_INF_F;
      f[i] = 0;
    }
  }
  __device__ __forceinline__ void add(int i, float x, int fold) {
    const bool best = x < v1[i];
    const bool second = !best && x < v2[i];
    v2[i] = best ? v1[i] : (second ? x : v2[i]);
    // __byte_perm(a, b, 0x5410): the low half of a, then the low half of b
    f[i] = best ? __byte_perm(fold, f[i], 0x5410) : (second ? __byte_perm(f[i], fold, 0x5410) : f[i]);
    v1[i] = best ? x : v1[i];
  }
  // +inf never enters: the unscanned folds leave the bins as they are
  __device__ __forceinline__ void complete(int, int, int) {}
  // bin i's two candidates at position j (its bank's lane) of row ov/oi
  __device__ __forceinline__ void write(int i, float* ov, int* oi, int j, int lane, int) const {
    ov[j] = v1[i];
    oi[j] = v1[i] == CUDART_INF_F ? 0 : (int)(f[i] & 0xffffu) * kTileSlots + lane;
    ov[2 * kTileSlots + j] = v2[i];
    oi[2 * kTileSlots + j] = v2[i] == CUDART_INF_F ? 0 : (int)(f[i] >> 16) * kTileSlots + lane;
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

// Packed fold: per bin, the two smallest packings.
struct PackedBins {
  int m1[8], m2[8];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i) m1[i] = m2[i] = INT_MAX;
  }
  __device__ __forceinline__ void put(int i, int p) {
    m2[i] = min(m2[i], max(m1[i], p));
    m1[i] = min(m1[i], p);
  }
  __device__ __forceinline__ void add(int i, float x, int fold) { put(i, pack_score(x, fold)); }
  // Folds [T, n_folds) were not scanned: every slot there scores +inf, and
  // their packings rise with the fold, so of the bank's ones only its two
  // smallest folds f0, f0 + 2 can be among a bin's two minima.
  __device__ __forceinline__ void complete(int bank, int T, int n_folds) {
    const int f0 = T + ((T + bank) & 1);
#pragma unroll
    for (int f = f0; f < f0 + 4; f += 2) {
      if (f < n_folds) {
        const int p = pack_score(CUDART_INF_F, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) put(i, p);
      }
    }
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
  __device__ __forceinline__ void write(int i, float* ov, int* oi, int j, int lane,
                                        int n_folds) const {
    unpack(m1[i], lane, n_folds, ov[j], oi[j]);
    unpack(m2[i], lane, n_folds, ov[2 * kTileSlots + j], oi[2 * kTileSlots + j]);
  }
};

// list_scan_tc's fold epilogue: the even tiles (bank 0) first, then the
// odd ones (bank 1); a bank's candidates are written when the scan moves
// past it. T: the tiles the block scans; rows at or past `live` are not
// written (the block wrote them as (+inf, 0) before its scan).
template <class Bins>
struct FoldEpi {
  static constexpr bool kEvensFirst = true;
  Bins bins;
  int bank, T, n_folds, live;
  float* vals;  // the block's first row
  int* idx;

  __device__ FoldEpi(int T_, int n_folds_, int live_, float* vals_, int* idx_)
      : bank(0), T(T_), n_folds(n_folds_), live(live_), vals(vals_), idx(idx_) {
    bins.init();
  }
  // the bank's unscanned folds by rule, then its candidates of the live rows
  __device__ __forceinline__ void flush() {
    bins.complete(bank, T, n_folds);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = acc_row(i), lane = acc_slot(i);
      if (row < live)
        bins.write(i, vals + (size_t)row * kCands, idx + (size_t)row * kCands,
                   bank * kTileSlots + lane, lane, n_folds);
    }
  }
  // Slots past nscan (an inactive warpgroup's) score +inf, as in the full
  // scan, so every thread folds all eight.
  __device__ __forceinline__ void scores(int t, const float (&s)[8], bool) {
    if ((t & 1) != bank) {  // block-uniform: bank 0's tiles are done
      flush();
      bank = 1;
      bins.init();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) bins.add(i, s[i], t);
  }
  __device__ __forceinline__ void merge(int) const {}
  __device__ __forceinline__ void finish() {
    flush();
    if (bank == 0) {  // no odd tile was scanned: bank 1 by rule alone
      bank = 1;
      bins.init();
      flush();
    }
  }
};

// The staging of the list's rows (list_scan_tc.cuh): int8 rows against
// an int8 store (I8) by TMA (TMA) or byte by byte, as kernel 3 stages
// them; a store of T for f32 rows, converted to bf16, as kernel 1 does.
template <bool I8, bool TMA, typename T>
__device__ __forceinline__ auto make_stage(const CUtensorMap* map, const TcLayout& lay,
                                           const T* rows, int nkc, int row0, int rot, int L) {
  if constexpr (I8)
    return make_i8_stage<TMA>(map, lay, rows, nkc, row0, rot, L);
  else
    return RegStage<T>(lay.st, rows, rot, L);
}

// Blocks an SM: three (at most 80 registers a thread), but two for the
// exact fold over a bf16 store, whose bins (24 registers) and share of the
// next tile held in registers (24) do not fit in 80 beside the scan.
template <class Bins, bool I8, typename T>
constexpr int fold_min_blocks =
    std::is_same_v<Bins, ExactBins> && !I8 && std::is_same_v<T, __nv_bfloat16> ? 2 : 3;

// I8: int8 rows and their scales against an int8 store, staged by TMA (TMA)
// or byte by byte; else f32 rows rounded to bf16 against a store of T.
// Block b holds row block b % nrb of chunk b / nrb.
template <class Bins, bool I8, typename T, bool TMA>
__global__ void __launch_bounds__(kThreads, (fold_min_blocks<Bins, I8, T>))
    fold_kernel(const __grid_constant__ CUtensorMap smap, const int* __restrict__ lof,
                const void* __restrict__ q, const float* __restrict__ q_scale,
                const T* __restrict__ store, const float* __restrict__ base,
                const int* __restrict__ live_rows, float* __restrict__ vals,
                int* __restrict__ idx, int chunk, int rot, int L, int nrb, float coef) {
  extern __shared__ unsigned char smem_raw[];
  const int c = blockIdx.x / nrb;
  const int row0 = (blockIdx.x - c * nrb) * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kCands;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kCands, 0);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const int nkc = tc_chunks(rot, I8);
  const TcLayout lay(smem_raw, nkc, I8 && TMA ? kI8Stages : 1);
  const float* lbase = base + (size_t)list * L;
  const size_t q0 = (size_t)c * chunk + row0;
  const T* rows = store + (size_t)list * L * rot;
  auto stage = make_stage<I8, TMA>(&smap, lay, rows, nkc, list * L, rot, L);
  // the loads that need nothing first: tile 0, the query rows (and
  // scales), the base row
  stage.first();
  if constexpr (I8) {
    stage_query_i8(lay.q, static_cast<const int8_t*>(q) + q0 * rot, live, rot, nkc);
    const int r = threadIdx.x;
    if (r < kRows) lay.rs[r] = r < live ? q_scale[q0 + r] : 0.f;
  } else {
    stage_query_bf16(lay.q, static_cast<const float*>(q) + q0 * rot, live, rot, nkc);
  }
  const int nscan = scan_extent(lbase, L, reinterpret_cast<int*>(lay.sc));
  const TileOrder<FoldEpi<Bins>::kEvensFirst> ord(nscan);
  stage.start(nscan, ord);
  fence_proxy_async();  // the query rows, for wgmma
  __syncthreads();
  FoldEpi<Bins> epi(ord.T, L / kTileSlots, live, vals + out0, idx + out0);
  list_scan_tc<I8>(lay, stage, ord, lbase, nscan, tc_ksteps(rot, I8), coef, epi);
}

template <class Bins, bool I8, typename T, bool TMA>
int launch(const CUtensorMap& smap, const void* lof, const void* q, const void* q_scale,
           const void* store, const void* base, const void* live_rows, void* vals, void* idx,
           int ncb, int chunk, int rot, int L, bool ip, cudaStream_t stream) {
  const auto kernel = fold_kernel<Bins, I8, T, TMA>;
  const size_t smem = list_tc_smem_bytes(rot, I8, I8 && TMA ? kI8Stages : 1, 0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nrb = (chunk + kRows - 1) / kRows;
  kernel<<<(unsigned)((long long)ncb * nrb), kThreads, smem, stream>>>(
      smap, static_cast<const int*>(lof), q, static_cast<const float*>(q_scale),
      static_cast<const T*>(store), static_cast<const float*>(base),
      static_cast<const int*>(live_rows), static_cast<float*>(vals), static_cast<int*>(idx),
      chunk, rot, L, nrb, ip ? 1.f : 2.f);
  return (int)cudaGetLastError();
}

template <class Bins>
int launch_store(int store_kind, bool q_int8, const void* lof, const void* q,
                 const void* q_scale, const void* store, const void* base,
                 const void* live_rows, void* vals, void* idx, int ncb, int chunk, int rot, int L,
                 int n_lists, bool ip, cudaStream_t s) {
  CUtensorMap smap;
  memset(&smap, 0, sizeof(smap));
  if (q_int8) {  // int8 rows need the int8 store
    if (store_kind != 0) return (int)cudaErrorInvalidValue;
    if (rot % 16 != 0)  // no whole 16-byte rows for TMA
      return launch<Bins, true, int8_t, false>(smap, lof, q, q_scale, store, base, live_rows, vals,
                                               idx, ncb, chunk, rot, L, ip, s);
    // the store as (n_lists * L, rot) bytes
    if (int err = encode_tensor_map_2d(&smap, CU_TENSOR_MAP_DATA_TYPE_UINT8, store, rot,
                                       (unsigned long long)n_lists * L, rot, 128, kHalfSlots))
      return err;
    return launch<Bins, true, int8_t, true>(smap, lof, q, q_scale, store, base, live_rows, vals,
                                            idx, ncb, chunk, rot, L, ip, s);
  }
  switch (store_kind) {
    case 0:
      return launch<Bins, false, int8_t, false>(smap, lof, q, nullptr, store, base, live_rows,
                                                vals, idx, ncb, chunk, rot, L, ip, s);
    case 1:
      return launch<Bins, false, __nv_bfloat16, false>(smap, lof, q, nullptr, store, base,
                                                       live_rows, vals, idx, ncb, chunk, rot, L,
                                                       ip, s);
    case 2:
      return launch<Bins, false, float, false>(smap, lof, q, nullptr, store, base, live_rows,
                                               vals, idx, ncb, chunk, rot, L, ip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rtt

// q: (ncb, chunk, rot) float32 rows, or int8 rows when q_scale (ncb,
// chunk) float32 is given (then the store must be int8). store_kind: 0
// int8, 1 bf16, 2 float32; n_lists: the store's first dimension.
// live_rows (ncb,) or null: rows at or past live_rows[i] of chunk i hold
// (+inf, 0) and cost no work. packed: the packed fold, else the exact one.
// Returns the launch's cudaError_t.
extern "C" int pq_list_scan_launch(const void* lof, const void* q, const void* q_scale,
                                   const void* store, int store_kind, const void* base,
                                   const void* live_rows, void* vals, void* idx, int ncb,
                                   int chunk, int rot, int L, int n_lists, int inner_product,
                                   int packed, void* stream) {
  using namespace rtt;
  if (ncb == 0 || chunk == 0) return 0;
  if (L % kTileSlots != 0 || L < 2 * kTileSlots || L / kTileSlots > 0xffff)
    return (int)cudaErrorInvalidValue;
  const bool ip = inner_product != 0, q_int8 = q_scale != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  if (packed)
    return launch_store<PackedBins>(store_kind, q_int8, lof, q, q_scale, store, base, live_rows,
                                    vals, idx, ncb, chunk, rot, L, n_lists, ip, s);
  return launch_store<ExactBins>(store_kind, q_int8, lof, q, q_scale, store, base, live_rows, vals,
                                 idx, ncb, chunk, rot, L, n_lists, ip, s);
}
