// Batched exact top-k selection with the lists in shared memory, for the
// list-scan kernels (fused_list_topk.cu, fused_list_topk_int8.cu and
// fused_bitplane_topk.cu, through list_scan_tc.cuh's TopKEpi).
//
// fused_common.cuh's WarpTopK keeps a row's sorted list in its warp's
// registers and inserts each pair that beats the row's k-th one by a
// one-step shuffle of the whole list: about 4 KR shuffles and a reduce an
// insertion, k ln(L / k) insertions a row. As k grows that is the
// kernel's whole cost, and past k = 128 (KR 8) the 2 rows x 8 x (value,
// id) registers a lane spill under three blocks an SM.
//
// Here each row's sorted list of up to CAP (score, id) pairs lives in
// shared memory, beside a buffer of kTileSlots pairs. CAP is the
// launch's list width (64, 128 or 256: the smallest that holds k, picked
// by with_selection), so a block charges its shared memory for the k it
// runs, not for kMaxK. After a tile of scores, the warp that owns the row
// ballots the tile against the row's k-th pair and compacts the pairs
// below it into the buffer. When the buffer would overflow, and after the
// last tile, the warp flushes it: a bitonic sort of the buffer (four
// pairs a lane, registers and shuffles), then a bitonic merge of the
// sorted list with the sorted buffer that keeps the CAP smallest pairs
// (CAP / 32 a lane), and a new k-th pair. A row then pays a few
// sort-and-merge rounds instead of one shuffle of the whole list an
// insertion, and no list lives in registers between them. Every comparison is on the lexicographic (score, id) order,
// so the result is exactly WarpTopK's: the k lexicographically smallest
// pairs, ties to the smaller id, +inf pairs taking the places left over
// in id order, then (+inf, kSentinel).
#pragma once

#include "fused_common.cuh"

namespace rtt {

constexpr int kBufCap = kTileSlots;  // pairs a row's buffer holds
// The selection variant for k: register lists (WarpTopK<1>, one register
// a lane) up to kMaxRegisterK, the shared-memory batch past it. On the H100
// the lists win at k <= 32 and the batch from k = 33 up (PERF.md).
constexpr int kMaxRegisterK = 32;

// Shared memory of the lists (cap pairs a row) and buffers of a block's
// kRows rows; cap 0 (register lists) needs none.
__host__ __device__ constexpr size_t block_lists_bytes(int cap) {
  return cap == 0 ? 0 : (sizeof(float) + sizeof(int)) * (size_t)kRows * (cap + kBufCap);
}
__host__ __device__ constexpr int list_cap(int k) {
  return k <= kMaxRegisterK ? 0 : k <= 64 ? 64 : k <= 128 ? 128 : kMaxK;
}

// Runs f(std::integral_constant<int, CAP>) with CAP = list_cap(k): 0
// selects with WarpTopK<1>, else SharedTopK<CAP>.
template <typename F>
__host__ inline int with_selection(int k, F&& f) {
  switch (list_cap(k)) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, kMaxK>{});
  }
}

// One row's list and buffer, owned by one warp (every lane calls each
// member with the same arguments); k <= CAP.
template <int CAP>
struct SharedTopK {
  static_assert(CAP % 32 == 0 && CAP <= kMaxK, "list width: whole registers a lane");
  float* lv;  // CAP: the list, sorted; its first k pairs count
  int* li;
  float* bv;  // kBufCap: the buffer, unsorted
  int* bi;
  float kv;  // the k-th pair, on every lane
  int ki;
  int bc;    // pairs in the buffer

  // `lists` holds block_lists_bytes(CAP); `row` is the row within the block
  __device__ __forceinline__ void init(void* lists, int row, int lane) {
    float* fv = static_cast<float*>(lists);
    int* iv = reinterpret_cast<int*>(fv + kRows * (CAP + kBufCap));
    lv = fv + row * CAP;
    li = iv + row * CAP;
    bv = fv + kRows * CAP + row * kBufCap;
    bi = iv + kRows * CAP + row * kBufCap;
    for (int j = lane; j < CAP; j += 32) {
      lv[j] = CUDART_INF_F;
      li[j] = kSentinel;
    }
    kv = CUDART_INF_F;
    ki = kSentinel;
    bc = 0;
    __syncwarp();
  }

  // Sort the buffer, merge it into the list, take the new k-th pair.
  __device__ __forceinline__ void flush(int k, int lane) {
    __syncwarp();
    float v[4];
    int id[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // pair e = 32 j + lane; the pads sort last
      const int e = 32 * j + lane;
      v[j] = e < bc ? bv[e] : CUDART_INF_F;
      id[j] = e < bc ? bi[e] : kSentinel;
    }
    // (loops over exponents: an affine count that the compiler unrolls in
    // full, so every register index is static)
    constexpr int kLogBuf = 7;
    static_assert(1 << kLogBuf == kBufCap, "buffer: 128 pairs, four a lane");
#pragma unroll
    for (int ls = 1; ls <= kLogBuf; ++ls) {
      const int size = 1 << ls;
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        const int stride = 1 << lt;
        if (stride >= 32) {  // partners in the same lane
          const int js = stride / 32;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j & js) continue;
            const int j2 = j + js;
            const bool up = ((32 * j + lane) & size) == 0;
            if (up ? lex_less(v[j2], id[j2], v[j], id[j]) : lex_less(v[j], id[j], v[j2], id[j2])) {
              const float tv = v[j];
              const int ti = id[j];
              v[j] = v[j2];
              id[j] = id[j2];
              v[j2] = tv;
              id[j2] = ti;
            }
          }
        } else {  // partners in lane ^ stride
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float ov = __shfl_xor_sync(kFull, v[j], stride);
            const int oi = __shfl_xor_sync(kFull, id[j], stride);
            const bool up = ((32 * j + lane) & size) == 0;
            const bool lower = (lane & stride) == 0;  // keeps the min when up
            if (lower == up ? lex_less(ov, oi, v[j], id[j]) : lex_less(v[j], id[j], ov, oi)) {
              v[j] = ov;
              id[j] = oi;
            }
          }
        }
      }
    }
    // the CAP smallest of the list and the buffer: c[i] = min(list[i],
    // buffer[CAP - 1 - i]) (the buffer padded with (+inf, kSentinel) to
    // CAP) rises, then falls; a bitonic merge sorts it. The list's places
    // past k hold its next pairs, real ones too: every pair of the k best
    // so far is among them, and ids are unique, so no pair comes twice.
    constexpr int U = CAP / 32;
    float cv[U];
    int ci[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      constexpr int kBufRegs = kBufCap / 32;
      const int jb = U - 1 - u;  // buffer[CAP - 1 - i]: element jb of lane 31 - lane
      float ov = CUDART_INF_F;
      int oi = kSentinel;
      if (jb < kBufRegs) {
        ov = __shfl_sync(kFull, v[jb < kBufRegs ? jb : 0], 31 - lane);
        oi = __shfl_sync(kFull, id[jb < kBufRegs ? jb : 0], 31 - lane);
      }
      const float av = lv[32 * u + lane];
      const int ai = li[32 * u + lane];
      const bool take = lex_less(ov, oi, av, ai);
      cv[u] = take ? ov : av;
      ci[u] = take ? oi : ai;
    }
    constexpr int kLogCap = CAP == 64 ? 6 : CAP == 128 ? 7 : 8;
    static_assert(1 << kLogCap == CAP, "list width: a power of two");
#pragma unroll
    for (int lt = kLogCap - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= 32) {  // partners in the same lane
        const int us = stride / 32;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u & us) continue;
          const int u2 = u + us;
          if (lex_less(cv[u2], ci[u2], cv[u], ci[u])) {
            const float tv = cv[u];
            const int ti = ci[u];
            cv[u] = cv[u2];
            ci[u] = ci[u2];
            cv[u2] = tv;
            ci[u2] = ti;
          }
        }
      } else {  // partners in lane ^ stride; the lower lane keeps the min
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float ov = __shfl_xor_sync(kFull, cv[u], stride);
          const int oi = __shfl_xor_sync(kFull, ci[u], stride);
          if ((lane & stride) == 0 ? lex_less(ov, oi, cv[u], ci[u])
                                   : lex_less(cv[u], ci[u], ov, oi)) {
            cv[u] = ov;
            ci[u] = oi;
          }
        }
      }
    }
    const int last = k - 1;
    float x = cv[0];
    int y = ci[0];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      lv[32 * u + lane] = cv[u];
      li[32 * u + lane] = ci[u];
      if (u == last / 32) {
        x = cv[u];
        y = ci[u];
      }
    }
    kv = __shfl_sync(kFull, x, last % 32);
    ki = __shfl_sync(kFull, y, last % 32);
    bc = 0;
    __syncwarp();
  }

  // Buffer one tile's pairs below the k-th pair: scores sc[0 : kTileSlots]
  // for ids [t0, t0 + kTileSlots), ids past n excluded.
  __device__ __forceinline__ void merge(const float* sc, int t0, int n, int k, int lane) {
    float s[4];
    unsigned m[4];
    int tot = 0;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      s[g] = sc[32 * g + lane];
      const int col = t0 + 32 * g + lane;
      m[g] = __ballot_sync(kFull, col < n && lex_less(s[g], col, kv, ki));
      tot += __popc(m[g]);
    }
    if (tot == 0) return;
    if (bc + tot > kBufCap) {
      flush(k, lane);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int col = t0 + 32 * g + lane;
        m[g] = __ballot_sync(kFull, col < n && lex_less(s[g], col, kv, ki));
      }
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if ((m[g] >> lane) & 1u) {
        const int pos = bc + __popc(m[g] & below);
        bv[pos] = s[g];
        bi[pos] = t0 + 32 * g + lane;
      }
      bc += __popc(m[g]);
    }
  }

  // Row out[0 : kbuf): the k pairs best-first, then (+inf, kSentinel);
  // positions [fill, k) take fill_id(j, fill, L) (fused_common.cuh).
  __device__ __forceinline__ void write(float* ov, int* oi, int k, int kbuf, int lane,
                                        int fill = kMaxK, int L = 0) {
    if (bc > 0) flush(k, lane);
    __syncwarp();
    for (int j = lane; j < kbuf; j += 32) {
      ov[j] = j < k ? lv[j] : CUDART_INF_F;
      oi[j] = j < k ? (j < fill ? li[j] : fill_id(j, L)) : kSentinel;
    }
  }
};

}  // namespace rtt
