// select_counting: exact k smallest per row for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/select_counting.py:
// counting_select_min (_make_kernel :61, pallas_call at :140). For each
// row of a (B, L) f32 matrix: exactly the k smallest values in the total
// order of the f32 bits (the monotone uint32 image key_of: -0.0 before
// +0.0, -NaN below -inf, +NaN above +inf), ties to the smaller index,
// written unsorted as (B, k) f32 values and int32 row-local ids. A value
// is written as the TPU kernel extracts it, by a masked sum (v + 0.0): a
// selected -0.0 comes back as +0.0. The order is the TPU kernel's
// position order: with T the k-th smallest key, the elements below T in
// index order, then the first need = k - count(< T) elements equal to T
// in index order. The caller pads rows with +inf, so a real +inf precedes
// the pad columns and wins by index.
//
// What bounds it on the H100: the (B, L) input read once and the (B, k)
// output written once, at 3.35 TB/s: a few integer operations an element.
//
// Two variants; the launcher picks by k:
//  - k <= kSmallK (128), rows 16-byte aligned: small_k_kernel. One warp
//    a row, four rows a 128-thread block, so that 31 rows are in flight
//    on each SM and their loads hide each other. One pass over the row
//    straight from device memory, in 16-byte loads (the next four in
//    flight while the last four are selected). The warp keeps the
//    running k smallest (key, index) pairs, sorted, in registers
//    (KeyTopK: pair j in register j / 32 of lane j % 32; the layout and
//    ballot-filter-insert of fused_common.cuh's WarpTopK, on the uint32
//    keys). A key above the running k-th key is dropped with one compare;
//    the rest (almost none once the list has filled; about k (1 + ln(L /
//    k)) a row) take the exact (key, index) test and a one-step shuffle
//    of the list. Then the k pairs are written in the position order
//    above. No atomics and no shared copy of the row. One warp a row
//    takes k ln(L / k) insertions a row where several warps a row would
//    take that each, and no merge.
//    The switch at 128: an insertion shuffles k / 32 registers a lane and
//    a row takes about k (1 + ln(L / k)) of them, so the cost grows with
//    k while the radix select's four passes do not; chip_smoke.py phase 5
//    times both variants at k 128 (PERF.md). A row that descends makes
//    every element an insertion (its worst case, timed there too): still
//    one pass.
//  - k > 128, or a row not 16-byte aligned: radix_kernel, RAFT's radix
//    select (matrix/detail/select_radix.cuh). One block of 1024 threads
//    owns a row. Threshold: T, the k-th smallest key, in four passes of
//    a 256-bin shared-memory histogram, most significant byte first, each
//    pass counting only the keys whose higher bytes match the prefix
//    fixed so far; one warp scans the bins and fixes the next byte and
//    the number `need` of elements equal to T to take (k - count(key <
//    T)). Select: one pass in index order, blockDim elements at a time;
//    ballots and a per-warp count give each element its count of earlier
//    elements below T (lt) and equal to T (eq); an element below T goes
//    to position lt, one equal to T with eq < need to k - need + eq. The
//    row lives in shared memory when L * 4 bytes fit (up to 200 KB);
//    otherwise every pass re-reads it from device memory. Any L and any
//    0 < k <= L work.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace rsc {

constexpr int kThreads = 1024;   // radix_kernel
constexpr int kSmallK = 128;     // the largest k of small_k_kernel
constexpr int kSelThreads = 128; // small_k_kernel: four rows a block (a warp a row)
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kLoads = 4;        // 16-byte loads in flight a thread (v[0..3])
constexpr unsigned kNoKey = 0xffffffffu;
constexpr int kNoIdx = 0x7fffffff;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRowSmemLimit = 200 * 1024;  // bytes of a row kept in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned key_of(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? ~static_cast<unsigned>(i) : (static_cast<unsigned>(i) | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
    radix_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                    int* __restrict__ out_i, int L, int k, int row_in_smem) {
  extern __shared__ float row_s[];
  __shared__ unsigned hist[kBins];
  __shared__ unsigned s_prefix;
  __shared__ int s_need;
  __shared__ int w_lt[kWarps], w_eq[kWarps];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float* g = vals + (size_t)blockIdx.x * L;
  const float* row = g;
  if (row_in_smem) {
    for (int i = t; i < L; i += kThreads) row_s[i] = g[i];
    row = row_s;
  }
  if (t == 0) {
    s_prefix = 0u;
    s_need = k;
  }

  unsigned mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (t < kBins) hist[t] = 0u;
    __syncthreads();
    const unsigned prefix = s_prefix;
    for (int i = t; i < L; i += kThreads) {
      const unsigned key = key_of(row[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane owns bins [8 lane, 8 lane + 8); the bin holding the need-th
      // matching key fixes the next byte
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[8 * lane + q];
        sum += c[q];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned need = (unsigned)s_need;
      unsigned run = incl - sum;
      if (run < need && need <= incl) {
        int d = 8 * lane;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (run + c[q] >= need) {
            d = 8 * lane + q;
            break;
          }
          run += c[q];
        }
        s_prefix = prefix | ((unsigned)d << shift);
        s_need = (int)(need - run);
      }
    }
    mask |= 0xffu << shift;
    __syncthreads();
  }

  const unsigned T = s_prefix;
  const int need = s_need;
  float* ov = out_v + (size_t)blockIdx.x * k;
  int* oi = out_i + (size_t)blockIdx.x * k;
  const unsigned below = (1u << lane) - 1u;
  int base_lt = 0, base_eq = 0;
  for (int c0 = 0; c0 < L; c0 += kThreads) {
    const int i = c0 + t;
    float v = 0.f;
    bool lt = false, eq = false;
    if (i < L) {
      v = row[i];
      const unsigned key = key_of(v);
      lt = key < T;
      eq = key == T;
    }
    const unsigned blt = __ballot_sync(kFull, lt), beq = __ballot_sync(kFull, eq);
    if (lane == 0) {
      w_lt[warp] = __popc(blt);
      w_eq[warp] = __popc(beq);
    }
    __syncthreads();
    int plt = base_lt + __popc(blt & below), peq = base_eq + __popc(beq & below);
    int tot_lt = 0, tot_eq = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int a = w_lt[w], b = w_eq[w];
      if (w < warp) {
        plt += a;
        peq += b;
      }
      tot_lt += a;
      tot_eq += b;
    }
    if (lt || (eq && peq < need)) {
      const int pos = lt ? plt : k - need + peq;
      ov[pos] = v == 0.f ? 0.f : v;
      oi[pos] = i;
    }
    base_lt += tot_lt;
    base_eq += tot_eq;
    __syncthreads();  // w_lt / w_eq are rewritten next chunk
    if (base_lt + min(base_eq, need) >= k) break;
  }
}


// The f32 whose key_of is `key` (key_of is a bijection), extracted as
// the TPU kernel does: -0.0 comes back as +0.0.
__device__ __forceinline__ float value_of(unsigned key) {
  const int i = (key & 0x80000000u) ? (int)(key & 0x7fffffffu) : (int)~key;
  const float v = __int_as_float(i);
  return v == 0.f ? 0.f : v;
}

__device__ __forceinline__ bool pair_less(unsigned a, int ai, unsigned b, int bi) {
  return a < b || (a == b && ai < bi);
}

// A sorted list of up to 32 * KR (key, index) pairs held by one warp:
// pair j in register j / 32 of lane j % 32 (fused_common.cuh's WarpTopK,
// on uint32 keys). Only the first k matter.
template <int KR>
struct KeyTopK {
  unsigned key[KR];
  int id[KR];
  unsigned kk;  // the k-th pair, on every lane
  int ki;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int u = 0; u < KR; ++u) {
      key[u] = kNoKey;
      id[u] = kNoIdx;
    }
    kk = kNoKey;
    ki = kNoIdx;
  }

  // Insert (ck, ci), which the caller has checked is below the k-th pair.
  __device__ __forceinline__ void insert(unsigned ck, int ci, int k, int lane) {
    int below = 0;
#pragma unroll
    for (int u = 0; u < KR; ++u)
      below += (32 * u + lane < k && pair_less(key[u], id[u], ck, ci)) ? 1 : 0;
    const int pos = __reduce_add_sync(kFull, below);
#pragma unroll
    for (int u = KR - 1; u >= 0; --u) {  // pair j takes pair j - 1 for j > pos
      unsigned sk = __shfl_up_sync(kFull, key[u], 1);
      int si = __shfl_up_sync(kFull, id[u], 1);
      if (u > 0) {
        const unsigned pk = __shfl_sync(kFull, key[u - 1], 31);
        const int pi = __shfl_sync(kFull, id[u - 1], 31);
        if (lane == 0) {
          sk = pk;
          si = pi;
        }
      }
      const int j = 32 * u + lane;
      if (j > pos) {
        key[u] = sk;
        id[u] = si;
      } else if (j == pos) {
        key[u] = ck;
        id[u] = ci;
      }
    }
    const int last = k - 1;
    unsigned x = key[0];
    int y = id[0];
#pragma unroll
    for (int u = 1; u < KR; ++u) {
      if (u == last / 32) {
        x = key[u];
        y = id[u];
      }
    }
    kk = __shfl_sync(kFull, x, last % 32);
    ki = __shfl_sync(kFull, y, last % 32);
  }

  // Offer one pair a lane (`pass` already filtered against the k-th pair).
  __device__ __forceinline__ void offer(bool pass, unsigned ck, int ci, int k, int lane) {
    unsigned mask = __ballot_sync(kFull, pass);
    while (mask) {
      const int b = __ffs(mask) - 1;
      mask &= mask - 1;
      const unsigned bk = __shfl_sync(kFull, ck, b);
      const int bi = __shfl_sync(kFull, ci, b);
      if (pair_less(bk, bi, kk, ki)) insert(bk, bi, k, lane);
    }
  }
};

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int KR>
__global__ void __launch_bounds__(kSelThreads)
    small_k_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                   int* __restrict__ out_i, int B, int L, int k) {
  __shared__ unsigned s_key[kSelWarps][32 * KR];
  __shared__ int s_id[kSelWarps][32 * KR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rid = blockIdx.x * kSelWarps + warp;  // one warp a row
  if (rid >= B) return;
  const float4* row = reinterpret_cast<const float4*>(vals + (size_t)rid * L);
  const int n4 = L / 4;
  KeyTopK<KR> top;
  top.init();
  float4 nxt[kLoads];  // the next batch of loads, in flight while this one is selected
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    nxt[u] = 32 * u + lane < n4 ? __ldcs(row + 32 * u + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b4 = 0; b4 < n4; b4 += 32 * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      v[u] = nxt[u];
      const int i4 = b4 + 32 * (kLoads + u) + lane;
      nxt[u] = i4 < n4 ? __ldcs(row + i4) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // fast path: flag the loaded keys at or below the running k-th key
    // (the slow path makes the exact (key, index) test)
    unsigned flags = 0u;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool live = b4 + 32 * u + lane < n4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        flags |= (live && key_of(lane_of(v[u], c)) <= top.kk ? 1u : 0u) << (4 * u + c);
    }
    if (__any_sync(kFull, flags != 0u)) {  // rare once the list has filled
#pragma unroll 1
      for (int p = 0; p < 4 * kLoads; ++p) {  // one copy of the insert code
        const int u = p >> 2;
        const float4 w = u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
        const unsigned key = key_of(lane_of(w, p & 3));
        const int i = 4 * (b4 + 32 * u + lane) + (p & 3);
        top.offer(((flags >> p) & 1u) && pair_less(key, i, top.kk, top.ki), key, i, k, lane);
      }
    }
  }
  // position order: below T = top.kk by index, then the ties at T (the
  // list's tail, already in index order)
#pragma unroll
  for (int u = 0; u < KR; ++u) {
    s_key[warp][32 * u + lane] = top.key[u];
    s_id[warp][32 * u + lane] = top.id[u];
  }
  __syncwarp();
  const unsigned T = top.kk;
  float* ov = out_v + (size_t)rid * k;
  int* oi = out_i + (size_t)rid * k;
#pragma unroll
  for (int u = 0; u < KR; ++u) {
    const int j = 32 * u + lane;
    if (j >= k) continue;
    const unsigned key = top.key[u];
    const int i = top.id[u];
    int pos = j;
    if (key < T) {
      pos = 0;
      for (int f = 0; f < k; ++f) pos += (s_key[warp][f] < T && s_id[warp][f] < i) ? 1 : 0;
    }
    ov[pos] = value_of(key);
    oi[pos] = i;
  }
}

}  // namespace rsc

// Returns the launch's cudaError_t.
extern "C" int counting_select_min_launch(const void* vals, void* out_v, void* out_i, int B,
                                          int L, int k, void* stream) {
  using namespace rsc;
  if (B == 0) return 0;
  if (k < 1 || k > L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if (k <= kSmallK && L % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0) {
    const int grid = (B + kSelWarps - 1) / kSelWarps;
    if (k <= 32)
      small_k_kernel<1><<<grid, kSelThreads, 0, s>>>(v, ov, oi, B, L, k);
    else if (k <= 64)
      small_k_kernel<2><<<grid, kSelThreads, 0, s>>>(v, ov, oi, B, L, k);
    else
      small_k_kernel<4><<<grid, kSelThreads, 0, s>>>(v, ov, oi, B, L, k);
    return (int)cudaGetLastError();
  }
  const bool in_smem = (long long)L * 4 <= kRowSmemLimit;
  const int smem = in_smem ? L * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(radix_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  radix_kernel<<<B, kThreads, smem, s>>>(v, ov, oi, L, k, in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}
