// Batched exact top-k selection with the lists in shared memory, for the
// list-scan kernels of fused_common.cuh (used by fused_bitplane_topk.cu).
//
// fused_common.cuh's WarpTopK keeps a row's sorted list in its warp's
// registers and inserts each pair that beats the row's k-th one by a
// one-step shuffle of the whole list: about 4 KR shuffles and a reduce an
// insertion, k ln(L / k) insertions a row. As k grows that is the
// kernel's whole cost, and past k = 128 (KR 8) the 2 rows x 8 x (value,
// id) registers a lane spill under three blocks an SM.
//
// Here each row's sorted list of up to kMaxK (score, id) pairs lives in
// shared memory, beside a buffer of kTileSlots pairs. After a tile of
// scores, the warp that owns the row ballots the tile against the row's
// k-th pair and compacts the pairs below it into the buffer. When the
// buffer would overflow, and after the last tile, the warp flushes it:
// a bitonic sort of the buffer (four pairs a lane, registers and
// shuffles), a merge into the list by rank (each pair's new position is
// its own index plus its rank in the other sorted run, by binary search;
// pairs are unique, since ids are), and a new k-th pair. A row then pays
// a few sort-and-merge rounds instead of one shuffle of the whole list an
// insertion, and no list lives in registers. Every comparison is on the
// lexicographic (score, id) order, so the result is exactly WarpTopK's:
// the k lexicographically smallest pairs, ties to the smaller id, +inf
// pairs taking the places left over in id order, then (+inf, kSentinel).
#pragma once

#include "fused_common.cuh"

namespace rtt {

constexpr int kListCap = kMaxK;      // pairs a row's list holds
constexpr int kBufCap = kTileSlots;  // pairs a row's buffer holds

// Shared memory of the lists and buffers of a block's kRows rows.
__host__ __device__ constexpr size_t block_lists_bytes() {
  return (sizeof(float) + sizeof(int)) * (size_t)kRows * (kListCap + kBufCap);
}

// Pairs of av/ai[0 : len) (sorted) lexicographically below (x, xi).
__device__ __forceinline__ int rank_below(const float* av, const int* ai, int len, float x,
                                          int xi) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lex_less(av[mid], ai[mid], x, xi))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One row's list and buffer, owned by one warp (every lane calls each
// member with the same arguments).
struct SharedTopK {
  float* lv;  // kListCap: the list, sorted; its first k pairs count
  int* li;
  float* bv;  // kBufCap: the buffer, unsorted
  int* bi;
  float kv;  // the k-th pair, on every lane
  int ki;
  int bc;    // pairs in the buffer

  // `lists` holds block_lists_bytes(); `row` is the row within the block
  __device__ __forceinline__ void init(void* lists, int row, int lane) {
    float* fv = static_cast<float*>(lists);
    int* iv = reinterpret_cast<int*>(fv + kRows * (kListCap + kBufCap));
    lv = fv + row * kListCap;
    li = iv + row * kListCap;
    bv = fv + kRows * kListCap + row * kBufCap;
    bi = iv + kRows * kListCap + row * kBufCap;
    for (int j = lane; j < kListCap; j += 32) {
      lv[j] = CUDART_INF_F;
      li[j] = kSentinel;
    }
    kv = CUDART_INF_F;
    ki = kSentinel;
    bc = 0;
    __syncwarp();
  }

  // Sort the buffer, merge it into the list, take the new k-th pair.
  __device__ void flush(int k, int lane) {
    __syncwarp();
    float v[4];
    int id[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // pair e = 32 j + lane; the pads sort last
      const int e = 32 * j + lane;
      v[j] = e < bc ? bv[e] : CUDART_INF_F;
      id[j] = e < bc ? bi[e] : kSentinel;
    }
#pragma unroll
    for (int size = 2; size <= kBufCap; size <<= 1) {
#pragma unroll
      for (int stride = size / 2; stride > 0; stride >>= 1) {
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[32 * j + lane] = v[j];
      bi[32 * j + lane] = id[j];
    }
    __syncwarp();
    // new positions: own index plus the rank in the other run (all pairs
    // differ: ids are unique, and the list's fillers (+inf, kSentinel)
    // lie above every buffered pair)
    float lvr[kListCap / 32];
    int lir[kListCap / 32], lpos[kListCap / 32];
#pragma unroll
    for (int u = 0; u < kListCap / 32; ++u) {
      const int i = 32 * u + lane;
      lpos[u] = kListCap;
      if (i < k) {
        lvr[u] = lv[i];
        lir[u] = li[i];
        lpos[u] = i + rank_below(bv, bi, bc, lvr[u], lir[u]);
      }
    }
    int bpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 32 * j + lane;
      bpos[j] = e < bc ? e + rank_below(lv, li, k, v[j], id[j]) : kListCap;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kListCap / 32; ++u) {
      if (lpos[u] < k) {
        lv[lpos[u]] = lvr[u];
        li[lpos[u]] = lir[u];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bpos[j] < k) {
        lv[bpos[j]] = v[j];
        li[bpos[j]] = id[j];
      }
    }
    __syncwarp();
    kv = lv[k - 1];
    ki = li[k - 1];
    bc = 0;
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

  // Row out[0 : kbuf): the k pairs best-first, then (+inf, kSentinel).
  __device__ __forceinline__ void write(float* ov, int* oi, int k, int kbuf, int lane) {
    if (bc > 0) flush(k, lane);
    __syncwarp();
    for (int j = lane; j < kbuf; j += 32) {
      ov[j] = j < k ? lv[j] : CUDART_INF_F;
      oi[j] = j < k ? li[j] : kSentinel;
    }
  }
};

// scan_topk_dots (fused_common.cuh) with SharedTopK selection: the same
// scores, tiles and output contract, for any k <= kMaxK. `lists` holds
// block_lists_bytes(). Every thread of the block must call it.
template <class Dots>
__device__ void scan_topk_shared(float* sc, void* lists, Dots& dots, int nrows,
                                 const typename Dots::Store* __restrict__ y,
                                 const float* __restrict__ base, int n, int k, int kbuf,
                                 float* __restrict__ vals, int* __restrict__ idx) {
  const int s = threadIdx.x % kTileSlots, half = threadIdx.x / kTileSlots;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  SharedTopK top[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) top[rr].init(lists, w * kRowsPerWarp + rr, lane);

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

}  // namespace rtt
