// fused_bitplane_topk: list-major RaBitQ bit-plane scan + exact top-k for
// Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_scan.py:fused_bitplane_topk
// (_make_bitplane_kernel :600, pallas_call at :781). For each chunk i of
// query rows, each live row c of it and each slot s of the one list
// lof[i] it computes
//   S_u   = sum_j 2^j * sum_w popc(planes[c, j*W + w] & codes_t[w, s])  (int32, exact)
//   s     = fma(lo, pop, delta * S_u)
//   est   = ((2 s - qsum) * rsq) / max(o_dot, 1e-12)       rsq = f32(1 / f32(sqrt(D)))
//   score = fma(-(2 rn), est, fma(rn, rn, qconst))          L2
//         = -fma(rn, est, qconst)                           inner product (negated)
// plus the slot's base (0, or +inf on a pad or masked slot), and writes
// the k lexicographically smallest (score, slot) pairs per row,
// best-first, into a (chunk, kbuf) buffer padded with (+inf, 2^31-1).
// The rounding is the JAX kernel's on the CPU (XLA contracts its
// mul+add pairs into these fused multiply-adds and its division by the
// constant sqrt(D) into a multiply by the reciprocal); every step is an
// explicit intrinsic, so nvcc's own contraction stays out and the kernel
// agrees bit for bit with its plain version (ops/fused_scan.py:
// bitplane_scores). Per-slot meta rows are [popcount(code), |r|, <o, x_bar>];
// per-row qmeta rows are [lo, delta, qsum, qconst].
//
// S_u is an unsigned 8-bit dot product of depth 32 W: bit j of the
// query's level u[d] in [0, 2^bits) is bit d of plane j, and the slot's
// code bit b[d] is 0 or 1, so S_u = sum_d u[d] b[d]. The kernel computes
// it so, on the tensor cores.
//
// What bounds it on the H100: 2 x 32 W multiply-adds a (live row, real
// slot) pair at the int8 rate sit below the bytes of the live rows, the
// real slots' codes and meta and the outputs, so bytes bound it. The
// kernel runs far above that bound: past k 32 each row's selection
// (block_topk.cuh's sort-and-merge rounds, latency-bound shuffles and
// shared-memory traffic) takes most of its time, as on kernels 1 and 3,
// and below it the per-tile round of barriers, products, estimator (a
// correctly rounded division a score) and merge. The CUDA-core scan this
// design replaced did bits x W AND + popcount pairs a (row, slot) pair
// at the popcount rate (16 a clock an SM), about 4x the int8 bound by
// themselves at rot_dim 96 and 8 query bits, over every tile of the
// padded list; that ALU work overlapped the other blocks' selection, so
// removing it shortens the kernel at k <= 64 and not past it.
//
// Design: a fourth client of list_scan_tc.cuh, as kernels 1, 3 and 4. A
// block scores kRows = 16 query rows of its chunk against its list, 128
// slots a tile, up to the list's last real slot (scan_extent; rows with
// fewer than k scanned slots take fill_id); warpgroup g multiplies slots
// [64 g, 64 g + 64) of the tile by the 16 rows with wgmma m64n16k32
// u8 x u8 -> s32 (exact in any order), both operands K-major and
// swizzled, one word of depth (32 bytes) a k-step:
//  - The codes stay 4 W bytes a slot in device memory and are expanded
//    only in shared memory, in K-blocks of KBW words (KBlock): a tile's
//    K-blocks pass through one stage and accumulate in the wgmma
//    registers, so any width fits. KBW is 4 (128-byte rows, the whole
//    depth of rot_dim 96 in one K-block), or 2 (64-byte rows, 64-byte
//    swizzle) with the 256-pair lists, whose block then fits three to an
//    SM (two with 4 words, which measured slower). Each thread
//    holds its code words of the next K-block in registers (coalesced
//    loads from the word-major codes_t) while the current one is
//    multiplied, then writes each word as 32 bytes of 0 / 1: byte 4 m + i
//    of word w is bit 8 i + m (m < 8, i < 4), a 2-instruction mask a
//    4-byte group ((c >> m) & 0x01010101). A warpgroup stages only its
//    own 64 slots, so between the K-blocks of a tile it waits on its own
//    named barrier, not the block's.
//  - The query operand holds the levels u8 in the same byte order,
//    rebuilt from the planes (((plane_j >> m) & 0x01010101) << j, OR-ed
//    over j). Where all K-blocks fit the block's shared memory
//    (RESIDENT: about 350 words) they are built once a block; past that
//    each warpgroup rebuilds its copy of a K-block's slice next to its
//    codes, so no shape that the CUDA-core scan admitted is refused. The
//    launcher picks by shape alone. Both sides count all 32 W bit
//    positions, pad bits past rot_dim too, as bitplane_su does.
//  - The epilogue (BitplaneScore) takes the s32 sums from the wgmma
//    fragment and applies the exact intrinsic sequence above; a +inf base
//    scores +inf without its estimate. S_u < 255 x 32 W < 2^24 under the
//    wrapper's envelope, so its float is exact. The rows' qmeta live in
//    the score tile's pad columns.
//  - The rest is TopKEpi's (list_scan_tc.cuh): tiles whose slots are all
//    +inf skip their products, each row keeps a running exact top k
//    (register lists to k 32, shared-memory lists merged in batches past
//    it: block_topk.cuh), blocks past a chunk's live rows exit. The
//    selection is latency-bound, so the kernel is built for four blocks
//    an SM up to 64-pair lists and three past them (bp_min_blocks).
//    Issuing the next tile's products before the merge, to overlap them,
//    bought nothing: the registers they hold cost the merge as much.
#include "list_scan_tc.cuh"

namespace rtt {

constexpr int kMaxBits = 8;                 // ops/fused_scan.BITPLANE_MAX_BITS
constexpr size_t kSmemBlockLimit = 232448;  // ops/fused_scan.SMEM_LIMIT

// Code words a K-block at selection CAP: 4 (128-byte swizzled rows), or 2
// (64-byte rows) where the 256-pair lists would leave room for only two
// blocks an SM with 4.
__host__ __device__ constexpr int bp_kb_words(int cap) { return cap == kMaxK ? 2 : 4; }
// Blocks an SM a bit-plane kernel is built for: four (64 registers a
// thread) with register lists and 64-pair lists, three (80) past them.
__host__ __device__ constexpr int bp_min_blocks(int cap) { return cap <= 64 ? 4 : 3; }

// The geometry of KBW-word K-blocks: a K-major operand of rows of
// 32 KBW bytes, swizzled over 32 KBW bytes (tc_common.cuh's swz for 128;
// for 64, unit u of row r at u ^ ((r / 2) % 4), repeating every 512 bytes).
template <int KBW>
struct KBlock {
  static_assert(KBW == 2 || KBW == 4, "64- or 128-byte swizzled K-blocks");
  static constexpr int kBytes = 32 * KBW;

  __host__ __device__ static constexpr int count(int words) { return (words + KBW - 1) / KBW; }
  // the query operand: every K-block (resident), or one slice a warpgroup
  __host__ __device__ static constexpr size_t query_bytes(int words, bool resident) {
    return (size_t)kRows * kBytes * (resident ? count(words) : 2);
  }
  // Dynamic shared memory of a bit-plane block (mirrored by
  // ops/fused_scan.py:_bitplane_smem_bytes): 1024 bytes of alignment
  // slack, one K-block of the tile's codes (kTileSlots x kBytes), the
  // query operand, the score tile (kRows x kScStride floats, whose 4 pad
  // floats a row hold the row's qmeta), then, 16-byte aligned, the rows'
  // shared lists (list width `cap`).
  __host__ __device__ static constexpr size_t smem_bytes(int words, bool resident, int cap) {
    return 1024 +
           ((size_t)kTileSlots * kBytes + query_bytes(words, resident) +
            sizeof(float) * kRows * kScStride + 15) /
               16 * 16 +
           block_lists_bytes(cap);
  }
  // byte offset of 16-byte unit u of row r
  __device__ static uint32_t swz(int u, int r) {
    if constexpr (KBW == 4)
      return (uint32_t)(r * 128 + ((u ^ (r & 7)) << 4));
    else
      return (uint32_t)(r * 64 + ((u ^ ((r >> 1) & 3)) << 4));
  }
  // wgmma descriptor of an operand at `addr`: 8-row groups 8 kBytes apart,
  // layout 1 (128-byte swizzle) or 2 (64-byte)
  __device__ static uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(8 * kBytes >> 4) << 32) | ((uint64_t)(KBW == 4 ? 1 : 2) << 62);
  }
  // lay.rs: the qmeta, field f of row r at rs[r * kScStride + f] (the
  // score tile's pads, which TopKEpi neither writes nor reads)
  __device__ static TcLayout layout(unsigned char* raw, int words, bool resident) {
    unsigned char* st = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
    unsigned char* q = st + kTileSlots * kBytes;
    float* sc = reinterpret_cast<float*>(q + query_bytes(words, resident));
    const size_t off =
        (reinterpret_cast<unsigned char*>(sc + kRows * kScStride) - st + 15) / 16 * 16;
    return TcLayout(st, q, sc, sc + kTileSlots, st + off);
  }
};

// Named barrier of this thread's warpgroup (1 or 2; 0 is the block's).
__device__ __forceinline__ void warpgroup_sync() {
  if (threadIdx.x < 128)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Half h of word w of a query row's levels as one 16-byte unit: u32 m
// holds the levels of dims 32 w + 8 i + 4 h + m in byte i.
__device__ __forceinline__ uint4 level_unit(const uint32_t* __restrict__ prow, int words,
                                            int bits, int w, int h) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < bits; ++j) {
    const uint32_t p = __ldg(prow + j * words + w) >> (4 * h);
#pragma unroll
    for (int m = 0; m < 4; ++m) o[m] |= ((p >> m) & 0x01010101u) << j;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Half h of code word c as 16 bytes of 0 / 1, in level_unit's order.
__device__ __forceinline__ uint4 bit_unit(uint32_t c, int h) {
  c >>= 4 * h;
  return make_uint4(c & 0x01010101u, (c >> 1) & 0x01010101u, (c >> 2) & 0x01010101u,
                    (c >> 3) & 0x01010101u);
}

// Every K-block of rows [0, live) of the block's levels into q (kRows x
// kBytes a K-block); zeros past live.
template <int KBW>
__device__ __forceinline__ void stage_levels(unsigned char* q, const uint32_t* __restrict__ pl,
                                             int live, int words, int bits) {
  using KB = KBlock<KBW>;
  for (int e = threadIdx.x; e < kRows * 2 * words; e += kThreads) {
    const int r = e / (2 * words), v = e - r * 2 * words, w = v >> 1, h = v & 1;
    *reinterpret_cast<uint4*>(q + (w / KBW) * kRows * KB::kBytes + KB::swz(2 * (w % KBW) + h, r)) =
        r < live ? level_unit(pl + (size_t)r * bits * words, words, bits, w, h)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The codes' staging, step by step: step s is K-block s % nkb of tile s /
// nkb, in slot order. Thread x of warpgroup g holds words 2 j + (x / 64) %
// 2 (j < KBW / 2) of the K-block for slot 64 g + x % 64 of the tile, from
// `fetch` until `put` expands them into the one stage; streamed, `put`
// also rebuilds the warpgroup's copy of the K-block's query slice.
template <bool RESIDENT, int KBW>
struct BitStage {
  using KB = KBlock<KBW>;
  unsigned char* st;
  unsigned char* qs;                   // streamed: this warpgroup's slice
  const uint32_t* __restrict__ codes;  // the list's (words, L) code words
  const uint32_t* __restrict__ pl;     // the block's planes, row stride bits * words
  int words, bits, L, nkb, live, bound;
  uint32_t held[KBW / 2];

  __device__ BitStage(const TcLayout& lay, const uint32_t* codes_, const uint32_t* pl_,
                      int words_, int bits_, int L_, int live_)
      : st(lay.st),
        qs(lay.q + (threadIdx.x >> 7) * kRows * KB::kBytes),
        codes(codes_),
        pl(pl_),
        words(words_),
        bits(bits_),
        L(L_),
        nkb(KB::count(words_)),
        live(live_),
        bound(L_),
        held{} {}

  // step s's K-block and this thread's slot; false where its warpgroup's
  // half of the tile lies past `bound` (no work)
  __device__ __forceinline__ bool mine(int s, int& slot, int& kb) const {
    const int t = s / nkb;
    kb = s - t * nkb;
    const int half = t * kTileSlots + kHalfSlots * (threadIdx.x >> 7);
    slot = half + (threadIdx.x & (kHalfSlots - 1));
    return half < bound;
  }
  __device__ __forceinline__ void fetch(int s) {
    int slot, kb;
    if (!mine(s, slot, kb)) return;
    const int w0 = KBW * kb + ((threadIdx.x >> 6) & 1);
#pragma unroll
    for (int j = 0; j < KBW / 2; ++j)
      if (w0 + 2 * j < words) held[j] = __ldg(codes + (size_t)(w0 + 2 * j) * L + slot);
  }
  __device__ __forceinline__ void put(int s) {
    int slot, kb;
    if (!mine(s, slot, kb)) return;
    const int r = slot % kTileSlots, wi0 = (threadIdx.x >> 6) & 1;
#pragma unroll
    for (int j = 0; j < KBW / 2; ++j) {
      const int wi = wi0 + 2 * j;
      if (KBW * kb + wi < words) {
        *reinterpret_cast<uint4*>(st + KB::swz(2 * wi, r)) = bit_unit(held[j], 0);
        *reinterpret_cast<uint4*>(st + KB::swz(2 * wi + 1, r)) = bit_unit(held[j], 1);
      }
    }
    if constexpr (!RESIDENT) {
      const int x = threadIdx.x & 127, rr = x / (2 * KBW), u = x % (2 * KBW);
      const int w = KBW * kb + (u >> 1);
      if (rr < kRows && w < words)
        *reinterpret_cast<uint4*>(qs + KB::swz(u, rr)) =
            rr < live ? level_unit(pl + (size_t)rr * bits * words, words, bits, w, u & 1)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the block scans nscan slots (T tiles): step 0 into the stage, step 1
  // in flight (step 0's words were fetched before the extent was known)
  __device__ __forceinline__ void start(int nscan, int T) {
    bound = nscan;
    if (T > 0) {
      put(0);
      if (T * nkb > 1) fetch(1);
    }
  }
  // step s's products are done: step s + 1 into the stage, s + 2 in flight
  __device__ __forceinline__ void next(int s, int nsteps) {
    put(s + 1);
    if (s + 2 < nsteps) fetch(s + 2);
  }
  // the query operand of K-block kb
  __device__ __forceinline__ uint32_t q_addr(const TcLayout& lay, int kb) const {
    return RESIDENT ? smem_u32(lay.q) + kb * kRows * KB::kBytes : smem_u32(qs);
  }
};

// The estimator of a slot's S_u for query row `row`, + base, in the
// intrinsic sequence above. A slot whose base is +inf scores +inf
// whatever its estimate (the reference's `score + inf`).
struct BitplaneScore {
  const float* qm;  // lo, delta, qsum, qconst of row r at qm[r * kScStride + 0..3]
  float rsq;
  bool ip;

  __device__ __forceinline__ float operator()(float b, int acc, int row, float pop, float rn,
                                              float od) const {
    if (b == CUDART_INF_F) return CUDART_INF_F;
    const float* m = qm + row * kScStride;
    const float lo = m[0], delta = m[1], qsum = m[2], qc = m[3];
    const float su = __int2float_rn(acc);  // < 255 * 32 W < 2^24: exact
    const float s = __fmaf_rn(lo, pop, __fmul_rn(delta, su));
    const float est =
        __fdiv_rn(__fmul_rn(__fsub_rn(__fmul_rn(2.f, s), qsum), rsq), fmaxf(od, 1e-12f));
    const float sc = ip ? -__fmaf_rn(rn, est, qc)
                        : __fmaf_rn(-__fmul_rn(2.f, rn), est, __fmaf_rn(rn, rn, qc));
    return __fadd_rn(sc, b);
  }
};

// This thread's two slots of a tile (acc_slot(0) and acc_slot(0) + 8):
// base and meta, loaded a tile ahead; +inf bases past nscan.
struct SlotMeta {
  float b[2], pop[2], rn[2], od[2];

  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       const float* __restrict__ meta, int L, int t0, int nscan) {
    const int s0 = acc_slot(0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b[h] = CUDART_INF_F;
      pop[h] = rn[h] = od[h] = 0.f;
    }
    if (t0 + kHalfSlots * (threadIdx.x >> 7) >= nscan) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t0 + s0 + 8 * h;
      b[h] = base[col];
      pop[h] = meta[col];
      rn[h] = meta[L + col];
      od[h] = meta[2 * L + col];
    }
  }
};

// list_scan_tc's loop for kernel 7: the tiles in slot order, each in nkb
// K-blocks through `stage`, the scores to `epi` (TopKEpi). Every thread
// of the block must call it, after a barrier that publishes step 0's
// stage, the query operand and the qmeta.
template <bool RESIDENT, int KBW, class Epi>
__device__ __forceinline__ void bitplane_scan(const TcLayout& lay, BitStage<RESIDENT, KBW>& stage,
                                              const float* __restrict__ base,
                                              const float* __restrict__ meta, int L, int nscan,
                                              const BitplaneScore& score, Epi& epi) {
  using KB = KBlock<KBW>;
  const int wg = threadIdx.x >> 7, words = stage.words, nkb = stage.nkb;
  const int T = (nscan + kTileSlots - 1) / kTileSlots, nsteps = T * nkb;
  const uint32_t a = smem_u32(lay.st) + wg * kHalfSlots * KB::kBytes;
  int acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0;
  SlotMeta m;
  m.load(base, meta, L, 0, nscan);

  for (int t = 0; t < T; ++t) {
    const int t0 = t * kTileSlots;
    const bool active = t0 + kHalfSlots * wg < nscan;  // warpgroup-uniform
    // block-uniform, and a barrier: the last tile's merges are done and
    // this tile's first K-block is staged
    const bool any = __syncthreads_or(m.b[0] != CUDART_INF_F || m.b[1] != CUDART_INF_F);
    for (int kb = 0; kb < nkb; ++kb) {
      if (active && any) {
        const uint32_t qa = stage.q_addr(lay, kb);
        const int nw = min(KBW, words - KBW * kb);
        wgmma_fence();
        for (int kk = 0; kk < nw; ++kk)
          wgmma_step_u8(acc, KB::desc(a + 32 * kk), KB::desc(qa + 32 * kk), kb + kk > 0);
        wgmma_commit_wait();
      }
      if (kb + 1 < nkb) {  // the tile's next K-block: this warpgroup's rows only
        warpgroup_sync();  // its products of this K-block are done
        stage.next(t * nkb + kb, nsteps);
        fence_proxy_async();
        warpgroup_sync();
      }
    }
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = (j >> 1) & 1;
      s[j] = active && any ? score(m.b[h], acc[j], acc_row(j), m.pop[h], m.rn[h], m.od[h])
                           : CUDART_INF_F;
    }
    epi.scores(t, s, active);
    __syncthreads();  // the scores are in; every product of the tile is done
    if (t + 1 < T) {
      stage.next(t * nkb + nkb - 1, nsteps);
      fence_proxy_async();
    }
    m.load(base, meta, L, t0 + kTileSlots, nscan);
    epi.merge(t);
  }
  epi.finish();
}

// CAP: the selection (block_topk.cuh: with_selection), 0 for WarpTopK<1>
// (k <= 32), else SharedTopK<CAP>; its K-blocks bp_kb_words(CAP) words,
// bp_min_blocks(CAP) blocks an SM. RESIDENT: the query operand holds
// every K-block (its shared memory fits), else a slice a warpgroup.
template <int CAP, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, bp_min_blocks(CAP))
    bitplane_kernel(const int* __restrict__ lof, const uint32_t* __restrict__ planes,
                    const uint32_t* __restrict__ codes_t, const float* __restrict__ meta,
                    const float* __restrict__ base, const float* __restrict__ qmeta,
                    const int* __restrict__ live_rows, float* __restrict__ vals,
                    int* __restrict__ idx, int chunk, int words, int bits, int L, int k, int kbuf,
                    float rsq, bool ip) {
  constexpr int KBW = bp_kb_words(CAP);
  extern __shared__ unsigned char smem_raw[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kbuf;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kbuf, kSentinel);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const TcLayout lay = KBlock<KBW>::layout(smem_raw, words, RESIDENT);
  const uint32_t* pl = planes + ((size_t)c * chunk + row0) * bits * words;
  const float* lbase = base + (size_t)list * L;
  BitStage<RESIDENT, KBW> stage(lay, codes_t + (size_t)list * words * L, pl, words, bits, L,
                                live);
  // the loads that need nothing first: step 0's code words, the levels, the qmeta
  stage.fetch(0);
  if constexpr (RESIDENT) stage_levels<KBW>(lay.q, pl, live, words, bits);
  const float* qm = qmeta + (size_t)c * 4 * chunk + row0;
  for (int e = threadIdx.x; e < 4 * kRows; e += kThreads) {
    const int f = e / kRows, r = e - f * kRows;
    lay.rs[r * kScStride + f] = r < live ? qm[(size_t)f * chunk + r] : 0.f;
  }
  const int nscan = scan_extent(lbase, L, reinterpret_cast<int*>(lay.sc));
  stage.start(nscan, (nscan + kTileSlots - 1) / kTileSlots);
  fence_proxy_async();  // the stage and the levels, for wgmma
  __syncthreads();
  TopKEpi<CAP> epi(lay, live, k, kbuf, L, nscan, vals + out0, idx + out0);
  bitplane_scan(lay, stage, lbase, meta + (size_t)list * 3 * L, L, nscan,
                BitplaneScore{lay.rs, rsq, ip}, epi);
}

}  // namespace rtt

// planes (ncb, chunk, bits*words) and codes_t (n_lists, words, L) hold
// uint32 words; meta (n_lists, 3, L), base (n_lists, 1, L) and qmeta
// (ncb, 4, chunk) f32. live_rows (ncb,) or null: rows at or past
// live_rows[i] of chunk i hold (+inf, 2^31-1) and cost no work. Returns
// the launch's cudaError_t.
extern "C" int fused_bitplane_topk_launch(const void* lof, const void* planes, const void* codes_t,
                                          const void* meta, const void* base, const void* qmeta,
                                          const void* live_rows, void* vals, void* idx, int ncb,
                                          int chunk, int words, int bits, int L, int k, int kbuf,
                                          float rsq, int inner_product, void* stream) {
  using namespace rtt;
  if (ncb == 0 || chunk == 0) return 0;
  if (k < 1 || k > kMaxK || kbuf < k || bits < 1 || bits > kMaxBits || words < 1 ||
      L % kTileSlots != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ncb, (chunk + kRows - 1) / kRows);
  return with_selection(k, [&](auto cap) {
    constexpr int CAP = decltype(cap)::value;
    using KB = KBlock<bp_kb_words(CAP)>;
    // by shape alone: every K-block of the levels resident where they fit
    const bool resident = KB::smem_bytes(words, true, CAP) <= kSmemBlockLimit;
    const size_t smem = KB::smem_bytes(words, resident, CAP);
    const auto kernel = resident ? bitplane_kernel<CAP, true> : bitplane_kernel<CAP, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lof), static_cast<const uint32_t*>(planes),
        static_cast<const uint32_t*>(codes_t), static_cast<const float*>(meta),
        static_cast<const float*>(base), static_cast<const float*>(qmeta),
        static_cast<const int*>(live_rows), static_cast<float*>(vals), static_cast<int*>(idx),
        chunk, words, bits, L, k, kbuf, rsq, inner_product != 0);
    return (int)cudaGetLastError();
  });
}
