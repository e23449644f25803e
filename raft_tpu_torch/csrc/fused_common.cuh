// Shared core of the CUDA-core scans: fused_topk.cu's CUDA-core variant and
// the bit-plane scan (fused_bitplane_topk.cu); the tensor-core list kernels
// (list_scan_tc.cuh) use its row lists, int8 score and element loads. A
// block scores kRows query rows against a run of store rows, 128 slots
// (one tile) at a time, and no score ever reaches device memory.
//
// Scoring is a policy with one interface (`tile` accumulates the dots of
// one tile, `score` turns a dot into the minimized score; the bit-plane
// scan brings its own):
//   Bf16Dots<T>  the block stages its query rows, rounded to bf16 (round
//                to nearest even) and held as float, in shared memory
//                once, then streams store rows in tiles of kTileSlots rows
//                x kDStep depth, each element converted to bf16-exact float
//                (four elements per load where the row width allows), and
//                accumulates f32 dots. Thread t owns store row
//                (t % kTileSlots) of the tile and kRowsHalf query rows
//                (half t / kTileSlots), so one 16-byte shared load of the
//                store feeds 4 * kRowsHalf fused multiply-adds and the query
//                loads are warp-wide broadcasts. The staged rows use a
//                stride of kDStride floats, which keeps the 16-byte loads
//                of eight neighbouring threads on distinct banks.
// A tile whose base is +inf on every slot skips the dots: its scores are
// +inf whatever they are.
//
// Selection (scan_topk_dots): each row's k best (score, id) pairs so far live
// in the registers of the warp that owns the row, sorted, pair j in
// register j / 32 of lane j % 32 (WarpTopK). After each tile, warp w
// merges rows 2w and 2w+1: a ballot finds the tile's pairs below the
// row's current k-th pair (almost none once the list has filled) and each
// is inserted by a one-step shuffle of the list. Every comparison is on
// the lexicographic (score, id) order, so the result is the k
// lexicographically smallest pairs, ties to the smaller id, exactly what
// the TPU epilogue's k extraction passes (_extract_topk) and lax.top_k
// give; +inf pairs (masked slots) take the slots left over in id order,
// as they do there.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rtt {

constexpr int kThreads = 256;     // 8 warps
constexpr int kTileSlots = 128;   // store rows per staged tile
constexpr int kDStep = 32;        // depth per staged tile
constexpr int kDStride = 36;      // floats per staged row (kDStep + 4 pad)
constexpr int kRows = 16;         // query rows per block
constexpr int kRowsHalf = kRows / 2;
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kMaxK = 256;
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 2 * kTileSlots, "two thread halves per tile");
static_assert(kRowsPerWarp * (kThreads / 32) == kRows, "whole rows per warp");

__host__ __device__ constexpr int depth_padded(int d) {
  return (d + kDStep - 1) / kDStep * kDStep;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element, as bf16-exact float.
__device__ __forceinline__ float load1(const int8_t* p) {
  return static_cast<float>(*p);  // |v| <= 128: exact in bf16
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load1(const float* p) { return bf16_round(*p); }

// Four consecutive elements (4-element aligned), as floats.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// q_s[kRows][dpad] <- bf16-rounded rows [0, nvalid) of q (row stride d);
// zeros past the ragged edges.
__device__ __forceinline__ void stage_rows(float* q_s, const float* q, int nvalid, int d,
                                           int dpad) {
  for (int e = threadIdx.x; e < kRows * dpad; e += kThreads) {
    const int r = e / dpad, c = e - r * dpad;
    q_s[e] = (r < nvalid && c < d) ? bf16_round(q[(size_t)r * d + c]) : 0.f;
  }
}

// st[kTileSlots][kDStride] <- rows [t0, t0 + kTileSlots) x columns
// [d0, d0 + kDStep) of a (nrows, d) store; zeros past the edges. With
// d % 4 == 0 (and the store 16-byte aligned, as torch allocates it) every
// thread moves four elements per load.
template <typename T>
__device__ __forceinline__ void stage_tile(float* st, const T* rows, int nrows, int t0, int d,
                                           int d0) {
  if (d % 4 == 0) {
    for (int e = threadIdx.x; e < kTileSlots * kDStep / 4; e += kThreads) {
      const int s = e / (kDStep / 4), c = (e % (kDStep / 4)) * 4;
      const int slot = t0 + s, col = d0 + c;
      *reinterpret_cast<float4*>(st + s * kDStride + c) =
          (slot < nrows && col < d) ? load4(rows + (size_t)slot * d + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTileSlots * kDStep; e += kThreads) {
    const int s = e / kDStep, c = e % kDStep;
    const int slot = t0 + s, col = d0 + c;
    st[s * kDStride + c] = (slot < nrows && col < d) ? load1(rows + (size_t)slot * d + col) : 0.f;
  }
}

// acc[r] += <q_s[half*kRowsHalf + r][d0 : d0 + kDStep], st[s][0 : kDStep]>
__device__ __forceinline__ void accumulate(float (&acc)[kRowsHalf], const float* q_s,
                                           const float* st, int dpad, int d0) {
  const int s = threadIdx.x % kTileSlots, half = threadIdx.x / kTileSlots;
  const float4* srow = reinterpret_cast<const float4*>(st + s * kDStride);
#pragma unroll
  for (int c = 0; c < kDStep / 4; ++c) {
    const float4 sv = srow[c];
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r) {
      const float4 qv =
          reinterpret_cast<const float4*>(q_s + (half * kRowsHalf + r) * dpad + d0)[c];
      acc[r] = fmaf(qv.x, sv.x, acc[r]);
      acc[r] = fmaf(qv.y, sv.y, acc[r]);
      acc[r] = fmaf(qv.z, sv.z, acc[r]);
      acc[r] = fmaf(qv.w, sv.w, acc[r]);
    }
  }
}

// A scan that stops after its first `fill` slots of a list of L (every
// slot past them +inf) leaves positions [fill, k) of a row's list empty
// when fill < k; the full scan would have taken the next +inf slots there
// in slot order: position j holds slot j, or the sentinel past the list.
__device__ __forceinline__ int fill_id(int j, int L) { return j < L ? j : kSentinel; }

// A sorted list of up to 32 * KR (score, id) pairs held by one warp:
// pair j in register j / 32 of lane j % 32. Only the first k matter; the
// registers past k hold whatever shifts into them.
template <int KR>
struct WarpTopK {
  float v[KR];
  int id[KR];
  float kv;  // the k-th pair, on every lane
  int ki;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      v[u] = CUDART_INF_F;
      id[u] = kSentinel;
    }
    kv = CUDART_INF_F;
    ki = kSentinel;
  }

  // Insert (cv, ci), which the caller has checked is below the k-th pair.
  __device__ __forceinline__ void insert(float cv, int ci, int k, int lane) {
    int below = 0;
#pragma unroll
    for (int u = 0; u < KR; ++u)
      below += (32 * u + lane < k && lex_less(v[u], id[u], cv, ci)) ? 1 : 0;
    const int pos = __reduce_add_sync(kFull, below);
#pragma unroll
    for (int u = KR - 1; u >= 0; --u) {  // pair j takes pair j - 1 for j > pos
      float sv = __shfl_up_sync(kFull, v[u], 1);
      int si = __shfl_up_sync(kFull, id[u], 1);
      if (u > 0) {
        const float pv = __shfl_sync(kFull, v[u - 1], 31);
        const int pi = __shfl_sync(kFull, id[u - 1], 31);
        if (lane == 0) {
          sv = pv;
          si = pi;
        }
      }
      const int j = 32 * u + lane;
      if (j > pos) {
        v[u] = sv;
        id[u] = si;
      } else if (j == pos) {
        v[u] = cv;
        id[u] = ci;
      }
    }
    const int last = k - 1;
    float x = v[0];
    int y = id[0];
#pragma unroll
    for (int u = 1; u < KR; ++u) {
      if (u == last / 32) {
        x = v[u];
        y = id[u];
      }
    }
    kv = __shfl_sync(kFull, x, last % 32);
    ki = __shfl_sync(kFull, y, last % 32);
  }

  // Merge one tile's scores sc[0 : kTileSlots] for ids [t0, t0 + kTileSlots).
  __device__ __forceinline__ void merge(const float* sc, int t0, int n, int k, int lane) {
#pragma unroll
    for (int g = 0; g < kTileSlots; g += 32) {
      const int col = t0 + g + lane;
      const float s = sc[g + lane];
      unsigned mask = __ballot_sync(kFull, col < n && lex_less(s, col, kv, ki));
      while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        const float bv = __shfl_sync(kFull, s, b);
        if (lex_less(bv, t0 + g + b, kv, ki)) insert(bv, t0 + g + b, k, lane);
      }
    }
  }

  // Row out[0 : kbuf): the k pairs best-first, then (+inf, kSentinel);
  // positions [fill, k) take fill_id(j, L).
  __device__ __forceinline__ void write(float* ov, int* oi, int k, int kbuf, int lane,
                                        int fill = kMaxK, int L = 0) const {
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      const int j = 32 * u + lane;
      if (j < kbuf) {
        ov[j] = j < k ? v[u] : CUDART_INF_F;
        oi[j] = j < k ? (j < fill ? id[u] : fill_id(j, L)) : kSentinel;
      }
    }
    for (int j = 32 * KR + lane; j < kbuf; j += 32) {
      ov[j] = CUDART_INF_F;
      oi[j] = kSentinel;
    }
  }
};

// Writes (+inf, fill_id) over `nrows` output rows of `width`.
__device__ __forceinline__ void write_empty(float* vals, int* idx, int nrows, int width,
                                            int fill_id = kSentinel) {
  for (int e = threadIdx.x; e < nrows * width; e += kThreads) {
    vals[e] = CUDART_INF_F;
    idx[e] = fill_id;
  }
}

// A list kernel's block holds rows [row0, row0 + nrows) of chunk c, whose
// live rows are a prefix of live_rows[c] (all rows when live_rows is
// null). Writes (+inf, fill_id) over the block's rows past that prefix
// (output rows of `width` at vals/idx) and returns how many of its rows
// are live; <= 0 means none, and the block has no work.
__device__ __forceinline__ int live_prefix(const int* live_rows, int c, int row0, int nrows,
                                           float* vals, int* idx, int width, int fill_id) {
  const int live = live_rows == nullptr ? nrows : min(nrows, live_rows[c] - row0);
  const int from = max(live, 0);
  if (from < nrows)
    write_empty(vals + (size_t)from * width, idx + (size_t)from * width, nrows - from, width,
                fill_id);
  return live;
}

// ---------------------------------------------------------------------------
// scoring policies
// ---------------------------------------------------------------------------

// bf16-rounded operands, f32 dots; score = base - coef * dot (coef 2 for
// L2, 1 for inner product; the product is exact, so one rounding).
template <typename T>
struct Bf16Dots {
  using Query = float;
  using Store = T;
  using Acc = float;
  float* st;   // kTileSlots x kDStride
  float* q_s;  // kRows x dpad
  int d, dpad;
  float coef;

  __host__ __device__ static size_t smem_bytes(int d) {
    return sizeof(float) * ((size_t)kTileSlots * kDStride + (size_t)kRows * depth_padded(d));
  }
  // Stages rows [0, nrows) of q (row stride d); the first tile's barrier
  // publishes them. The row scale is not used.
  __device__ Bf16Dots(void* smem, const float* q, const float*, int nrows, int d_, bool ip)
      : st(static_cast<float*>(smem)),
        q_s(st + kTileSlots * kDStride),
        d(d_),
        dpad(depth_padded(d_)),
        coef(ip ? 1.f : 2.f) {
    stage_rows(q_s, q, nrows, d, dpad);
  }
  // acc[r] += the dots of this thread's rows with slot t0 + (t % kTileSlots)
  __device__ __forceinline__ void tile(float (&acc)[kRowsHalf], const T* y, int n, int t0) {
    for (int d0 = 0; d0 < dpad; d0 += kDStep) {
      __syncthreads();  // staged rows ready / last depth step's readers done
      stage_tile(st, y, n, t0, d, d0);
      __syncthreads();
      accumulate(acc, q_s, st, dpad, d0);
    }
  }
  __device__ __forceinline__ float score(float b, float acc, int) const { return b - coef * acc; }
};

// The int8 score, rounded as the reference kernels round it on the CPU
// (raft_tpu/ops/fused_scan.py:484-485, raft_tpu/ops/pq_list_scan.py:184-200):
// L2 twice (dots = f32(idot) * scale, then base - 2 * dots), inner product
// once (base - f32(idot) * scale as one fused multiply-add). The explicit
// intrinsics keep nvcc's own contraction out of both. Both int8 kernels
// score through this one function, so their scores are the same f32
// values by construction.
__device__ __forceinline__ float int8_score(int idot, float rs, float b, bool ip) {
  const float f = __int2float_rn(idot);  // |idot| < 2^24: exact
  return ip ? __fmaf_rn(-f, rs, b) : __fsub_rn(b, __fmul_rn(2.f, __fmul_rn(f, rs)));
}

// Dynamic shared memory of one scan_topk block: the tile's scores, then
// the scoring policy's staging.
template <class Dots>
__host__ __device__ inline size_t topk_smem_bytes(int d) {
  return sizeof(float) * kRows * kTileSlots + Dots::smem_bytes(d);
}

// Score the block's nrows query rows (staged by `dots`) against the n
// rows of y: score_j = dots.score(base[j], <q, y_j>). Writes each row's k
// lexicographically smallest (score, j) pairs best-first into vals/idx
// rows of width kbuf, slots past k as (+inf, kSentinel); k <= 32 * KR.
// `sc` holds kRows x kTileSlots floats. Every thread of the block must
// call it.
template <int KR, class Dots>
__device__ void scan_topk_dots(float* sc, Dots& dots, int nrows,
                          const typename Dots::Store* __restrict__ y,
                          const float* __restrict__ base, int n, int k, int kbuf,
                          float* __restrict__ vals, int* __restrict__ idx) {
  const int s = threadIdx.x % kTileSlots, half = threadIdx.x / kTileSlots;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  WarpTopK<KR> top[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) top[rr].init();

  for (int t0 = 0; t0 < n; t0 += kTileSlots) {
    const int col = t0 + s;
    const float b = col < n ? base[col] : CUDART_INF_F;
    typename Dots::Acc acc[kRowsHalf];
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r) acc[r] = 0;
    // block-uniform, and a barrier: the last tile's merges are done
    if (__syncthreads_or(b != CUDART_INF_F)) dots.tile(acc, y, n, t0);
#pragma unroll
    for (int r = 0; r < kRowsHalf; ++r)
      sc[(half * kRowsHalf + r) * kTileSlots + s] = dots.score(b, acc[r], half * kRowsHalf + r);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = w * kRowsPerWarp + rr;  // warp-uniform
      if (r < nrows) top[rr].merge(sc + r * kTileSlots, t0, n, k, lane);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = w * kRowsPerWarp + rr;
    if (r < nrows) top[rr].write(vals + (size_t)r * kbuf, idx + (size_t)r * kbuf, k, kbuf, lane);
  }
}

// Dynamic shared memory of a bf16 scan_topk block (fused_topk's
// CUDA-core variant).
__host__ __device__ inline size_t scan_smem_bytes(int d) {
  return topk_smem_bytes<Bf16Dots<float>>(d);
}

// scan_topk over bf16-rounded float rows [0, nrows) of q (row stride d),
// score = base - coef * dot; `smem` holds scan_smem_bytes(d).
template <typename T, int KR>
__device__ void scan_topk(float* smem, const float* __restrict__ q, int nrows,
                          const T* __restrict__ y, const float* __restrict__ base, int n, int d,
                          int k, int kbuf, float coef, float* __restrict__ vals,
                          int* __restrict__ idx) {
  Bf16Dots<T> dots(smem + kRows * kTileSlots, q, nullptr, nrows, d, coef == 1.f);
  scan_topk_dots<KR>(smem, dots, nrows, y, base, n, k, kbuf, vals, idx);
}

// Runs f(std::integral_constant<int, KR>) with the smallest list width
// KR in {1, 2, 4, 8} that holds k <= kMaxK pairs.
template <typename F>
__host__ inline int with_list_width(int k, F&& f) {
  if (k <= 32) return f(std::integral_constant<int, 1>{});
  if (k <= 64) return f(std::integral_constant<int, 2>{});
  if (k <= 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

}  // namespace rtt
