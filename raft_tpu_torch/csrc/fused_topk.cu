// fused_topk: flat fused distance + exact top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_topk
// (_make_flat_kernel :170, pallas_call at :267, epilogue _extract_topk
// :136). Every query row x_i is scored against every dataset row y_j,
// score = base_j - c * <x_i, y_j> (c = 2 for L2 with base_j = |y_j|^2 of
// the bf16-rounded row, c = 1 and base 0 for inner product), and the k
// lexicographically smallest (score, j) pairs per query are written
// best-first into an (m, kbuf) buffer padded with (+inf, 2^31-1). The
// (m, n) score matrix never reaches device memory.
//
// What bounds it on the H100: m * n * d multiply-adds over operands read
// once. Both operands are bf16 (the query rows rounded to nearest even),
// so every product is exact in f32 and the tensor cores' bf16 rate is the
// bound (0.80 ms on the main path: m 4096, n 1M, d 96).
//
// Design (tc_range_kernel, then merge_ranges_kernel):
//  - Dots on the tensor cores: a block stages 64 x NWG query rows once,
//    as bf16, in shared memory; one producer thread streams the dataset
//    in tiles of kBN = 128 rows x the whole depth through a ring of
//    kStages shared-memory stages with TMA (one 2-D tensor copy per 64
//    columns, rows past n and columns past d zero-filled), each landing
//    on the stage's mbarrier. Both operands use the 128-byte swizzled
//    K-major layout (chunks of 64 columns), and each consumer warpgroup
//    multiplies its 64 rows by the tile with wgmma m64n128k16 (bf16 in,
//    f32 accumulate), ceil(d / 16) steps a tile, then releases the stage
//    on a second mbarrier. No block-wide barrier in the loop: one warpgroup selects
//    while the other multiplies.
//  - Selection by threshold, from registers: each row's k best pairs so
//    far are a max-heap (lexicographic (score, id)) in shared memory,
//    owned by the quad of lanes whose accumulator fragment holds the row.
//    A thread tests its 64 scores of a tile against its two rows'
//    thresholds (one compare each); the few flagged pairs go through a
//    per-warp queue in shared memory to one lane a row, which offers them
//    to the heap (replace the root, sift down). A row expects about
//    k (1 + ln(range / k)) insertions a range, so after the first tiles
//    selection is a small share of the time.
//  - The threshold is the heap's root or, where lower, the row's bound
//    over every range: each heap publishes its root score to a per-row
//    atomicMin (any range's k-th pair bounds the row's k best).
//  - Enough blocks for 132 SMs: the dataset is split into n_ranges
//    ranges of range_len rows (grid x: query blocks, fastest, so the
//    blocks that share a range run together and find it in L2; grid y:
//    ranges). Each (row, range) writes its k best, sorted, to a
//    workspace (m, n_ranges, k); merge_ranges_kernel merges a row's
//    n_ranges sorted lists lexicographically into the output. A range
//    with fewer than k rows keeps (+inf, sentinel) in its spare slots.
// The host plan (rows per block, ranges) is ops/fused_scan.py's
// flat_plan; query rows too wide, or k too deep, for the tensor-core
// variant's shared memory take the CUDA-core kernel below (flat_kernel,
// fused_common.cuh's scan_topk), which the wrapper launches through
// fused_topk_launch.
#include "fused_common.cuh"
#include "tc_common.cuh"

namespace rtt {

template <int KR>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ base, float* __restrict__ vals,
                int* __restrict__ idx, int m, int n, int d, int k, int kbuf, float coef) {
  extern __shared__ float4 smem4[];
  const int row0 = blockIdx.x * kRows;
  scan_topk<__nv_bfloat16, KR>(reinterpret_cast<float*>(smem4), x + (size_t)row0 * d,
                               min(kRows, m - row0), y, base, n, d, k, kbuf, coef,
                               vals + (size_t)row0 * kbuf, idx + (size_t)row0 * kbuf);
}

// ---------------------------------------------------------------------------
// tensor-core variant
// ---------------------------------------------------------------------------

constexpr int kBN = 128;          // dataset rows per staged tile (wgmma N)
constexpr int kMaxRanges = 128;   // merge_ranges_kernel: 4 lists a lane
constexpr int kStages = 3;        // dataset tiles in shared memory
constexpr int kQueue = 128;       // a warp's queue of flagged (score, id) pairs

// The order-preserving uint32 image of a score that is not NaN (-0.0 folded
// onto +0.0, as the two compare equal), and back.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// d (+)= A[64 x 16] * B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Offer (v, id) to a max-heap of k pairs (lexicographic order): it enters
// only below the root, which it replaces before sifting down.
__device__ __forceinline__ void heap_push(float* hv, int* hi, int k, float v, int id) {
  if (!lex_less(v, id, hv[0], hi[0])) return;
  int p = 0;
  for (;;) {
    int c = 2 * p + 1;
    if (c >= k) break;
    float cv = hv[c];
    int ci = hi[c];
    if (c + 1 < k) {
      const float dv = hv[c + 1];
      const int di = hi[c + 1];
      if (lex_less(cv, ci, dv, di)) {
        c = c + 1;
        cv = dv;
        ci = di;
      }
    }
    if (!lex_less(v, id, cv, ci)) break;
    hv[p] = cv;
    hi[p] = ci;
    p = c;
  }
  hv[p] = v;
  hi[p] = id;
}

// The slow path of one of a thread's two rows (H 0: acc rows lane / 4, H
// 1: 8 below). `flags` marks this lane's tile slots at or below the row's
// root. The warp queues its flagged (score, id) pairs in shared memory
// (kQueue at a time, lanes in order, so a quad's pairs are contiguous),
// then lane 4i offers quad i's pairs to the row's heap in one loop.
// Warp-uniform; acc is only read.
template <int H>
__device__ __forceinline__ void drain_row(const float (&acc)[64], const float* b_tile,
                                          float coef, unsigned flags, float* qv, int* qi,
                                          float* hv, int* hi, int k, int gbase, int lane) {
  const int q = lane & 3;
  while (__any_sync(kFull, flags != 0u)) {
    const int cnt = __popc(flags);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    int pos = incl - cnt;
    const int beg = pos;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // slots 8j + 2q and 8j + 2q + 1
      if ((flags >> (2 * j)) & 3u) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (((flags >> (2 * j + e)) & 1u) && pos < kQueue) {
            const int c = 8 * j + 2 * q + e;
            qv[pos] = b_tile[c] - coef * acc[4 * j + 2 * H + e];
            qi[pos] = gbase + c;
            flags &= ~(1u << (2 * j + e));
            ++pos;
          }
        }
      }
    }
    const int end = min(kQueue, __shfl_sync(kFull, incl, lane | 3));
    __syncwarp();
    if (q == 0)
      for (int e = beg; e < end; ++e) heap_push(hv, hi, k, qv[e], qi[e]);
    __syncwarp();
  }
}


// Dynamic shared memory of tc_range_kernel<NWG> (mirrored by
// ops/fused_scan.py:_tc_smem_bytes): alignment slack, the query rows, the
// dataset stages, the stages' base values, the stages' full and empty
// barriers, the rows' heaps, the consumer warps' queues.
__host__ __device__ inline size_t tc_smem_bytes(int dp, int k, int nwg) {
  const int nk16 = (dp + 15) / 16, nkc = (nk16 + 3) / 4, rows = 64 * nwg;
  return 1024 + (size_t)nkc * 128 * (rows + kStages * kBN) + (size_t)kStages * kBN * 4 +
         (size_t)kStages * 16 + (size_t)rows * k * 8 + (size_t)(rows / 16) * kQueue * 8;
}

// A row's threshold for the one-compare test s <= threshold, from its
// heap's root score `own` and the row's bound over every range `bnd`. A
// later column of this range that ties the root has a larger id, so it
// cannot enter: against the root the test is strict (the float below it).
// A tie with the bound (another range's root) may still win on its id.
__device__ __forceinline__ float row_threshold(float own, float bnd) {
  if (own > bnd) return bnd;
  return own == CUDART_INF_F ? own : nextafterf(own, -CUDART_INF_F);
}

// One tile's epilogue: each score against its row's threshold thA / thB
// (one compare; the heaps hold the exact lexicographic test), the flagged
// ones to the heaps; then the heaps' roots oA / oB are refreshed and
// published to the rows' bounds over every range (bA / bB, null for a row
// past m). acc[4j + 2h + e] is row rA + 8h, tile column
// 8j + 2q + e. Columns past n carry a NaN base, so they flag nothing. The
// accumulators are only read: an instruction other than wgmma that wrote
// them would serialize the next tile's wgmma with this epilogue.
__device__ __forceinline__ void tile_epilogue(const float (&acc)[64], const float* b_tile,
                                              int gbase, float coef, int k, int lane, float* hvA,
                                              int* hiA,
                                              float* hvB, int* hiB, float* qv, int* qi, float thA,
                                              float thB, float& oA, float& oB, unsigned* bA,
                                              unsigned* bB) {
  const int q = lane & 3;
  const float2* b2 = reinterpret_cast<const float2*>(b_tile);
  unsigned fA = 0u, fB = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bb = b2[4 * j + q];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = e ? bb.y : bb.x;
      const float sa = b - coef * acc[4 * j + e];
      const float sb = b - coef * acc[4 * j + 2 + e];
      fA |= (sa <= thA ? 1u : 0u) << (2 * j + e);
      fB |= (sb <= thB ? 1u : 0u) << (2 * j + e);
    }
  }
  if (__any_sync(kFull, (fA | fB) != 0u)) {  // warp-uniform
    drain_row<0>(acc, b_tile, coef, fA, qv, qi, hvA, hiA, k, gbase, lane);
    drain_row<1>(acc, b_tile, coef, fB, qv, qi, hvB, hiB, k, gbase, lane);
    oA = hvA[0];
    oB = hvB[0];
    // publish the new roots: a score above any range's root is not among
    // the row's k best
    if ((lane & 3) == 0) {
      if (bA != nullptr && oA != CUDART_INF_F) atomicMin(bA, score_key(oA));
      if (bB != nullptr && oB != CUDART_INF_F) atomicMin(bB, score_key(oB));
    }
  }
}

// Warp-specialized: warps 0 .. 4 NWG - 1 are NWG consumer warpgroups (64
// query rows each: wgmma, then selection), lane 0 of the last warp the
// producer (it fills the ring of kStages dataset tiles by TMA). Stage s
// has a `full` barrier (the producer's arrival with the tile's byte
// count, completed as the copies land) and an `empty` one (4 NWG consumer
// warps arrive once done with the tile), so the warpgroups run apart: one
// selects while the other multiplies, and a warp held up by insertions
// holds up only its own warpgroup.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    tc_range_kernel(const __grid_constant__ CUtensorMap ymap, const float* __restrict__ x,
                    const float* __restrict__ base, float* __restrict__ ws_v,
                    int* __restrict__ ws_i, unsigned* __restrict__ bound, int m, int n, int d,
                    int dp, int k, int range_len, int n_ranges, float coef) {
  constexpr int R = 64 * NWG, NC = 128 * NWG, NT = NC + 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int nk16 = (dp + 15) / 16, nkc = (nk16 + 3) / 4;
  const uint32_t stage_bytes = (uint32_t)nkc * kBN * 128;
  unsigned char* q_s = sm;                          // nkc x R x 128 bytes
  unsigned char* y_s = q_s + (size_t)nkc * R * 128;  // kStages x nkc x kBN x 128 bytes
  float* b_s = reinterpret_cast<float*>(y_s + (size_t)kStages * stage_bytes);  // kStages x kBN
  // full[kStages], then empty[kStages]
  uint64_t* bars = reinterpret_cast<uint64_t*>(b_s + kStages * kBN);
  float* hv = reinterpret_cast<float*>(bars + 2 * kStages);  // R x k heap values
  int* hi = reinterpret_cast<int*>(hv + R * k);     // R x k heap ids
  float* qv = reinterpret_cast<float*>(hi + R * k) + (threadIdx.x >> 5) * 2 * kQueue;
  int* qi = reinterpret_cast<int*>(qv + kQueue);    // this warp's queue (consumers)
  const uint32_t y_addr = smem_u32(y_s), full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  // range_len is a multiple of kBN, so only the dataset's end cuts a tile
  const int rbeg = blockIdx.y * range_len, rend = min(n, rbeg + range_len);
  const int ntiles = rend > rbeg ? (rend - rbeg + kBN - 1) / kBN : 0;

  // the query rows, rounded to bf16, zero past m and past d up to the
  // last 16-column step
  const int qunits = 2 * nk16;
  for (int e = tid; e < R * qunits; e += NT) {
    const int r = e / qunits, u = e - r * qunits, gr = row0 + r;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = 8 * u + 2 * h;
      const float a = (gr < m && c < d) ? x[(size_t)gr * d + c] : 0.f;
      const float b = (gr < m && c + 1 < d) ? x[(size_t)gr * d + c + 1] : 0.f;
      w[h] = pack_bf16(a, b);
    }
    *reinterpret_cast<uint4*>(q_s + swz(u, r, R)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // a consumer thread's accumulator rows: rA and rA + 8 of its
  // warpgroup's 64; the quad (lanes 4i .. 4i + 3) shares them and their heaps
  const int wg = warp >> 2, q = lane & 3;
  const int rA = 64 * wg + 16 * (warp & 3) + (lane >> 2), rB = rA + 8;
  float *hvA = hv + rA * k, *hvB = hv + rB * k;
  int *hiA = hi + rA * k, *hiB = hi + rB * k;
  if (tid < NC)
    for (int e = q; e < k; e += 4) {
      hvA[e] = hvB[e] = CUDART_INF_F;
      hiA[e] = hiB[e] = kSentinel;
    }
  fence_proxy_async();  // the query rows, for wgmma
  __syncthreads();      // the only block-wide barrier

  if (warp == NC / 32) {  // the producer: one thread issues every copy
    if (lane == 0)
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages, g0 = rbeg + t * kBN;
        if (t >= kStages) mbar_wait(empty0 + 8 * st, ((t / kStages) - 1) & 1);
        // base values: whole 16-byte units below n by bulk copy, the
        // rest stored here (NaN past n) before the barrier's arrival
        const int nb = min(kBN, n - g0), full_units = nb / 4;
        float* bt = b_s + st * kBN;
        const float nan = __int_as_float(0x7fc00000);
        for (int i = 4 * full_units; i < kBN; ++i) bt[i] = i < nb ? base[g0 + i] : nan;
        mbar_expect_tx(full0 + 8 * st, (unsigned)(nkc * kBN * 128 + 16 * full_units));
        for (int kc = 0; kc < nkc; ++kc)  // rows past n and columns past dp arrive as zeros
          tma_load_2d(y_addr + st * stage_bytes + kc * kBN * 128, &ymap, 64 * kc, g0,
                      full0 + 8 * st);
        if (full_units > 0) bulk_load(smem_u32(bt), base + g0, 16 * full_units, full0 + 8 * st);
      }
    return;
  }

  float oA = CUDART_INF_F, oB = CUDART_INF_F;  // the heaps' root scores
  unsigned* bA = row0 + rA < m ? bound + row0 + rA : nullptr;
  unsigned* bB = row0 + rB < m ? bound + row0 + rB : nullptr;
  const uint32_t a_addr = smem_u32(q_s) + wg * 64 * 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    // the other ranges' bounds, read now and used after the product
    const unsigned kA = bA != nullptr ? __ldcg(bA) : 0xffffffffu;
    const unsigned kB = bB != nullptr ? __ldcg(bB) : 0xffffffffu;
    mbar_wait(full0 + 8 * st, (t / kStages) & 1);
    const uint32_t b_tile = y_addr + st * stage_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < nk16; ++kk) {
      const uint32_t ka = (kk >> 2) * R * 128 + (kk & 3) * 32;
      const uint32_t kb = (kk >> 2) * kBN * 128 + (kk & 3) * 32;
      wgmma_m64n128k16(acc, sw128_desc(a_addr + ka), sw128_desc(b_tile + kb), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const float thA = row_threshold(oA, kA != 0xffffffffu ? key_score(kA) : CUDART_INF_F);
    const float thB = row_threshold(oB, kB != 0xffffffffu ? key_score(kB) : CUDART_INF_F);
    tile_epilogue(acc, b_s + st * kBN, rbeg + t * kBN, coef, k, lane, hvA, hiA, hvB, hiB, qv,
                  qi, thA, thB, oA, oB, bA, bB);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the tile
  }

  // each row's heap, sorted by rank, to its range's workspace slot
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rB : rA, gr = row0 + r;
    if (gr >= m) continue;
    const float* v = h ? hvB : hvA;
    const int* ids = h ? hiB : hiA;
    float* ov = ws_v + ((size_t)gr * n_ranges + blockIdx.y) * k;
    int* oi = ws_i + ((size_t)gr * n_ranges + blockIdx.y) * k;
    for (int e = q; e < k; e += 4) {
      const float ev = v[e];
      const int ei = ids[e];
      int rank = 0;
      for (int f = 0; f < k; ++f) {
        const float fv = v[f];
        const int fi = ids[f];
        rank += (lex_less(fv, fi, ev, ei) || (fv == ev && fi == ei && f < e)) ? 1 : 0;
      }
      ov[rank] = ev;
      oi[rank] = ei;
    }
  }
}

__device__ __forceinline__ bool lex3_less(float av, int ai, int al, float bv, int bi, int bl) {
  return av < bv || (av == bv && (ai < bi || (ai == bi && al < bl)));
}

// Row r of the output: the k lexicographically smallest pairs of its
// n_ranges sorted workspace lists, best-first, then (+inf, kSentinel) up
// to kbuf. One warp a row; lane l holds the heads of lists l, l + 32, ...
__global__ void __launch_bounds__(256)
    merge_ranges_kernel(const float* __restrict__ ws_v, const int* __restrict__ ws_i, int m,
                        int n_ranges, int k, int kbuf, float* __restrict__ vals,
                        int* __restrict__ idx) {
  constexpr int U = kMaxRanges / 32;
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= m) return;
  const float* rv = ws_v + (size_t)row * n_ranges * k;
  const int* ri = ws_i + (size_t)row * n_ranges * k;
  float hv[U];
  int hid[U], pos[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int l = lane + 32 * u;
    pos[u] = l < n_ranges ? 0 : k;
    hv[u] = l < n_ranges ? rv[(size_t)l * k] : CUDART_INF_F;
    hid[u] = l < n_ranges ? ri[(size_t)l * k] : kSentinel;
  }
  float* ov = vals + (size_t)row * kbuf;
  int* oi = idx + (size_t)row * kbuf;
  for (int j = 0; j < k; ++j) {
    float bv = CUDART_INF_F;
    int bi = kSentinel, bl = 0x7fffffff;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = lane + 32 * u;
      if (pos[u] < k && lex3_less(hv[u], hid[u], l, bv, bi, bl)) {
        bv = hv[u];
        bi = hid[u];
        bl = l;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov2 = __shfl_xor_sync(kFull, bv, off);
      const int oi2 = __shfl_xor_sync(kFull, bi, off), ol2 = __shfl_xor_sync(kFull, bl, off);
      if (lex3_less(ov2, oi2, ol2, bv, bi, bl)) {
        bv = ov2;
        bi = oi2;
        bl = ol2;
      }
    }
    if (lane == 0) {
      ov[j] = bv;
      oi[j] = bi;
    }
    if (bl != 0x7fffffff && (bl & 31) == lane) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u == (bl >> 5)) {
          ++pos[u];
          if (pos[u] < k) {
            hv[u] = rv[(size_t)bl * k + pos[u]];
            hid[u] = ri[(size_t)bl * k + pos[u]];
          }
        }
      }
    }
  }
  for (int j = k + lane; j < kbuf; j += 32) {
    ov[j] = CUDART_INF_F;
    oi[j] = kSentinel;
  }
}

}  // namespace rtt

// The CUDA-core variant (query rows too wide for the tensor-core
// variant's shared memory). Returns the launch's cudaError_t.
extern "C" int fused_topk_launch(const void* x, const void* y, const void* base, void* vals,
                                 void* idx, int m, int n, int d, int k, int kbuf,
                                 int inner_product, void* stream) {
  using namespace rtt;
  if (m == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem_bytes(d);
  const dim3 grid((m + kRows - 1) / kRows);
  return with_list_width(k, [&](auto kr) {
    constexpr int KR = decltype(kr)::value;
    cudaError_t err = cudaFuncSetAttribute(flat_kernel<KR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flat_kernel<KR><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(y),
        static_cast<const float*>(base), static_cast<float*>(vals), static_cast<int*>(idx), m,
        n, d, k, kbuf, inner_product ? 1.f : 2.f);
    return (int)cudaGetLastError();
  });
}

// The tensor map of the (n, dp) bf16 dataset: boxes of 64 columns (128
// bytes, the swizzle's span) x kBN rows, 128-byte swizzled, zero-filled
// out of range (tc_common.cuh: encode_tensor_map_2d).
static int make_dataset_map(CUtensorMap* map, const void* y, int n, int dp) {
  return rtt::encode_tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, dp, n, dp * 2ull, 64,
                                   rtt::kBN);
}

// The tensor-core variant: `rows` (64 or 128) query rows a block, the
// dataset (n, dp) bf16 (dp a multiple of 8, columns past d zero) in
// n_ranges ranges of range_len rows (a multiple of 128), the (m,
// n_ranges, k) workspace ws_v / ws_i and the (m,) row bounds `bound`
// (uint32, every bit set on entry), then the merge into (m, kbuf).
// Returns the first failing launch's cudaError_t.
extern "C" int fused_topk_tc_launch(const void* x, const void* y, const void* base, void* ws_v,
                                    void* ws_i, void* bound, void* vals, void* idx, int m, int n,
                                    int d, int dp, int k, int kbuf, int inner_product, int rows,
                                    int n_ranges, int range_len, void* stream) {
  using namespace rtt;
  if (m == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k || n < 1 || d < 1 || dp < d || dp % 8 != 0 ||
      (rows != 64 && rows != 128) || n_ranges < 1 || n_ranges > kMaxRanges ||
      range_len < 1 || range_len % kBN != 0 || (long long)n_ranges * range_len < n)
    return (int)cudaErrorInvalidValue;
  const int nwg = rows / 64;
  const size_t smem = tc_smem_bytes(dp, k, nwg);
  CUtensorMap ymap;
  if (int err = make_dataset_map(&ymap, y, n, dp)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + rows - 1) / rows, n_ranges);
  const float coef = inner_product ? 1.f : 2.f;
  auto run = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, nwg * 128 + 32, smem, s>>>(
        ymap, static_cast<const float*>(x), static_cast<const float*>(base),
        static_cast<float*>(ws_v), static_cast<int*>(ws_i), static_cast<unsigned*>(bound), m,
        n, d, dp, k, range_len, n_ranges, coef);
    return cudaGetLastError();
  };
  cudaError_t err = nwg == 2 ? run(tc_range_kernel<2>) : run(tc_range_kernel<1>);
  if (err != cudaSuccess) return (int)err;
  merge_ranges_kernel<<<(m + 7) / 8, 256, 0, s>>>(
      static_cast<const float*>(ws_v), static_cast<const int*>(ws_i), m, n_ranges, k, kbuf,
      static_cast<float*>(vals), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}
