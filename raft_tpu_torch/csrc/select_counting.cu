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
// Design: the TPU kernel fixes the threshold one bit at a time with 32
// full-row compares because a TPU has no scatter; Hopper has
// shared-memory atomics, so this is RAFT's radix select
// (matrix/detail/select_radix.cuh). One block of 1024 threads owns a row.
//  - Threshold: T, the k-th smallest key, in four passes of a 256-bin
//    shared-memory histogram, most significant byte first, each pass
//    counting only the keys whose higher bytes match the prefix fixed so
//    far; one warp scans the bins and fixes the next byte and the number
//    `need` of elements equal to T to take (k - count(key < T)).
//  - Select: one pass in index order, blockDim elements at a time; ballots
//    and a per-warp count give each element its count of earlier
//    elements below T (lt) and equal to T (eq); an element below T goes
//    to position lt, one equal to T with eq < need to k - need + eq. The
//    pass stops once k elements are placed.
//  - The row lives in shared memory when L * 4 bytes fit (up to 200 KB);
//    otherwise every pass re-reads it from device memory. Any L and any
//    0 < k <= L work.
#include <cstddef>
#include <cuda_runtime.h>

namespace rsc {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRowSmemLimit = 200 * 1024;  // bytes of a row kept in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned key_of(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? ~static_cast<unsigned>(i) : (static_cast<unsigned>(i) | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
    counting_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
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

}  // namespace rsc

// Returns the launch's cudaError_t.
extern "C" int counting_select_min_launch(const void* vals, void* out_v, void* out_i, int B,
                                          int L, int k, void* stream) {
  using namespace rsc;
  if (B == 0) return 0;
  if (k < 1 || k > L) return (int)cudaErrorInvalidValue;
  const bool in_smem = (long long)L * 4 <= kRowSmemLimit;
  const int smem = in_smem ? L * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(counting_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  counting_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(out_v), static_cast<int*>(out_i), L,
      k, in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}
