// The tensor-core list scan shared by fused_list_topk.cu (bf16 operands),
// fused_list_topk_int8.cu (int8 operands) and pq_list_scan.cu (either): a
// block scores kRows = 16 query rows of one chunk against the slots of its
// chunk's list, 128 slots (one tile) at a time, and hands each tile's
// scores to an epilogue policy: TopKEpi keeps each row's exact top k
// (kernels 1 and 3), pq_list_scan.cu's FoldEpi folds them into bins
// (kernel 4). No score reaches device memory.
//
//  - Only a list's real tiles. The store is padded to its largest list,
//    so most tiles of a typical list are +inf pad. The block first reduces
//    its list's base row to the end of its last slot whose base is not
//    +inf, rounded up to a warpgroup's 64 slots (`nscan`), and scans only
//    up to it; +inf runs before it (tombstones) are scanned. Where a row
//    has fewer than k scanned slots, the full scan would have filled its
//    list with the unscanned +inf slots in slot order: the write-out puts
//    slot j (or the sentinel past L) at position j >= nscan (fill_id).
//  - Tiles in the epilogue's order (TileOrder): in slot order for the
//    top k, the even tiles and then the odd ones for the bin fold (one
//    bank at a time). The staging follows that order.
//  - Dots on the tensor cores. Warpgroup g of the block's two multiplies
//    the tile's slots [64 g, 64 g + 64) (wgmma M) by the 16 query rows
//    (N), both operands K-major in 128-byte swizzled shared memory
//    (tc_common.cuh: swz, sw128_desc): m64n16k16 bf16 -> f32, or
//    m64n16k32 s8 -> s32 (exact in any order), the whole depth in
//    ceil(rot / 16) or ceil(rot / 32) steps. A warpgroup whose 64 slots lie
//    past nscan skips its products.
//  - Staging ahead of the products. The next tile is in flight while the
//    current one is scored and merged: by TMA into a ring of two stages
//    (TmaStage: int8 rows that need no conversion), or held in registers
//    by 8- or 16-byte loads and converted to bf16 into the one stage once
//    its products are done (RegStage: kernel 1's int8 and bf16 rows).
//    f32 rows (RegStage, which would need 48 registers a thread to hold a
//    tile) and widths that do not split into whole 8-byte or 16-byte
//    loads (RegStage, RegStageI8: element by element) are loaded when the
//    stage frees up.
//  - TopKEpi's selection by k (block_topk.cuh: with_selection): up to k =
//    32 each row keeps its list in its warp's registers (WarpTopK<1>), past
//    it in shared memory, merged in batches (SharedTopK<CAP>). Both select
//    the k lexicographically smallest (score, slot) pairs, ties to the
//    smaller slot, as the TPU epilogue (_extract_topk) does.
#pragma once

#include <cstring>
#include <type_traits>

#include "block_topk.cuh"
#include "tc_common.cuh"

namespace rtt {

constexpr int kHalfSlots = 64;               // slots a warpgroup scores: wgmma M
constexpr int kScStride = kTileSlots + 4;    // floats a row of the score tile
constexpr int kHoldUnits = 6;                // store units a thread holds in flight
constexpr int kI8Stages = 2;                 // TmaStage's ring

// Operand geometry in 16-byte units: a bf16 unit is 8 columns, an int8
// unit 16; a wgmma k-step is 32 bytes (2 units), a swizzle chunk 128
// bytes (8 units) a row.
__host__ __device__ constexpr int tc_units(int rot, bool i8) {
  return i8 ? (rot + 15) / 16 : (rot + 7) / 8;
}
__host__ __device__ constexpr int tc_ksteps(int rot, bool i8) { return (tc_units(rot, i8) + 1) / 2; }
__host__ __device__ constexpr int tc_chunks(int rot, bool i8) { return (tc_units(rot, i8) + 7) / 8; }

// Dynamic shared memory of a list_scan_tc block (mirrored by
// ops/fused_scan.py:_list_tc_smem_bytes): 1024 bytes of alignment slack,
// `stages` store tiles (kTileSlots rows x chunks x 128 bytes), the query
// rows (kRows x chunks x 128 bytes), the score tile (kRows x kScStride
// floats), the rows' scales (kRows floats), the stages' mbarriers, then,
// 16-byte aligned, the rows' shared lists (list width `cap`, 0 for
// register lists).
__host__ __device__ constexpr size_t list_tc_smem_bytes(int rot, bool i8, int stages, int cap) {
  return 1024 +
         ((size_t)(stages * kTileSlots + kRows) * tc_chunks(rot, i8) * 128 +
          sizeof(float) * kRows * (kScStride + 1) + 8 * (size_t)stages + 15) /
             16 * 16 +
         block_lists_bytes(cap);
}

// Pointers into a block's dynamic shared memory (list_tc_smem_bytes).
struct TcLayout {
  unsigned char* st;  // stages x kTileSlots x chunks x 128 bytes
  unsigned char* q;   // kRows x chunks x 128 bytes
  float* sc;          // kRows x kScStride
  float* rs;          // kRows
  uint64_t* bars;     // stages
  void* lists;

  __device__ TcLayout(unsigned char* raw, int nkc, int stages) {
    st = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
    q = st + (size_t)stages * kTileSlots * nkc * 128;
    sc = reinterpret_cast<float*>(q + kRows * nkc * 128);
    rs = sc + kRows * kScStride;
    bars = reinterpret_cast<uint64_t*>(rs + kRows);
    const size_t off = (reinterpret_cast<unsigned char*>(bars + stages) - st + 15) / 16 * 16;
    lists = st + off;
  }
};

// The end of the list's last slot whose base is not +inf, rounded up to
// kHalfSlots (at most L): the slots the block scans. `red` holds one int
// a warp. Every thread of the block must call it.
__device__ __forceinline__ int scan_extent(const float* __restrict__ base, int L, int* red) {
  int last = 0;
  for (int i = threadIdx.x; i < L; i += kThreads)
    if (base[i] != CUDART_INF_F) last = i + 1;
  last = __reduce_max_sync(kFull, last);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = last;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = max(m, red[w]);
  return min(L, (m + kHalfSlots - 1) / kHalfSlots * kHalfSlots);
}

// The order in which a block scans its T = ceil(nscan / kTileSlots)
// tiles: step i scans tile (*this)(i). In slot order, or (EvensFirst) the
// even tiles in slot order and then the odd ones.
template <bool EvensFirst>
struct TileOrder {
  int T, evens;

  __device__ explicit TileOrder(int nscan)
      : T((nscan + kTileSlots - 1) / kTileSlots), evens((T + 1) / 2) {}
  __device__ __forceinline__ int operator()(int i) const {
    if constexpr (EvensFirst)
      return i < evens ? 2 * i : 2 * (i - evens) + 1;
    else
      return i;
  }
};

// ---------------------------------------------------------------------------
// wgmma: d (+)= A[64 x K-step] * B[16 x K-step]^T, both K-major, swizzled
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_step(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_step(int (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// q_s <- rows [0, nrows) of q (row stride rot), rounded to bf16; zeros
// past nrows and rot.
__device__ __forceinline__ void stage_query_bf16(unsigned char* q_s, const float* __restrict__ q,
                                                 int nrows, int rot, int nkc) {
  const int nu = nkc * 8;
  for (int e = threadIdx.x; e < kRows * nu; e += kThreads) {
    const int r = e / nu, u = e - r * nu;
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = 8 * u + 2 * h;
      const float a = (r < nrows && c < rot) ? q[(size_t)r * rot + c] : 0.f;
      const float b = (r < nrows && c + 1 < rot) ? q[(size_t)r * rot + c + 1] : 0.f;
      w[h] = pack_bf16(a, b);
    }
    *reinterpret_cast<uint4*>(q_s + swz(u, r, kRows)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 16 bytes of an int8 row from p, of which the first `rem` are the row's
// (zeros after them).
__device__ __forceinline__ uint4 unit16_i8(const int8_t* __restrict__ p, int rem) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < rem) w[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// q_s <- rows [0, nrows) of the int8 rows q (row stride rot); zeros past
// nrows and rot.
__device__ __forceinline__ void stage_query_i8(unsigned char* q_s, const int8_t* __restrict__ q,
                                               int nrows, int rot, int nkc) {
  const int nu = nkc * 8;
  for (int e = threadIdx.x; e < kRows * nu; e += kThreads) {
    const int r = e / nu, u = e - r * nu;
    *reinterpret_cast<uint4*>(q_s + swz(u, r, kRows)) =
        r < nrows ? unit16_i8(q + (size_t)r * rot + 16 * u, rot - 16 * u)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Zeros over the stage's units [nu, 2 * ksteps) of every row: the last
// k-step's columns past the row's last unit.
__device__ __forceinline__ void zero_pad_units(unsigned char* st, int nu, int ksteps) {
  const int npad = 2 * ksteps - nu;
  for (int e = threadIdx.x; e < kTileSlots * npad; e += kThreads) {
    const int r = e / npad, u = nu + (e - r * npad);
    *reinterpret_cast<uint4*>(st + swz(u, r, kTileSlots)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Byte i of w ^ 0x80808080 (an int8 value x, biased to x + 128) as the f32
// bits of x, exactly: the float 2^23 + (x + 128) less 2^23 + 128. |x| <=
// 128 leaves the low 16 bits zero, so the high half is x in bf16.
__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t biased, unsigned i) {
  return __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | i)), 8388736.f));
}
// Bytes 2j, 2j + 1 of w ^ 0x80808080 as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t biased, unsigned j) {
  return __byte_perm(i8_f32_bits(biased, 2 * j), i8_f32_bits(biased, 2 * j + 1), 0x7632u);
}

// Eight consecutive elements of a store row (8-element aligned) as one
// 16-byte unit of bf16 values: int8 and bf16 exactly, f32 rounded to
// nearest even. kHold: a thread can hold its share of a tile (rot <= 96)
// in registers while the tile before it is scored.
template <typename T>
struct Unit8;
template <>
struct Unit8<int8_t> {
  using Raw = uint2;
  static constexpr bool kHold = true;
  __device__ static Raw load(const int8_t* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static uint4 bf16(Raw r) {
    const uint32_t x = r.x ^ 0x80808080u, y = r.y ^ 0x80808080u;
    return make_uint4(i8x2_bf16(x, 0), i8x2_bf16(x, 1), i8x2_bf16(y, 0), i8x2_bf16(y, 1));
  }
};
template <>
struct Unit8<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr bool kHold = true;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static uint4 bf16(Raw r) { return r; }
};
template <>
struct Unit8<float> {
  struct Raw {
    float4 a, b;
  };
  static constexpr bool kHold = false;
  __device__ static Raw load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
  }
  __device__ static uint4 bf16(Raw r) {
    return make_uint4(pack_bf16(r.a.x, r.a.y), pack_bf16(r.a.z, r.a.w), pack_bf16(r.b.x, r.b.y),
                      pack_bf16(r.b.z, r.b.w));
  }
};

// The first min(rem, 8) of eight elements at p, as bf16 (zeros after).
template <typename T>
__device__ __forceinline__ uint4 unit8_scalar(const T* __restrict__ p, int rem) {
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = j < rem ? load1(p + j) : 0.f;
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Kernel 1's staging: a list's rows of T, converted to bf16 as they are
// stored into the one stage. With rot % 8 == 0 every unit is one 8- or
// 16-byte load (one 32-byte pair for f32) and, for int8 and bf16 rows up
// to rot 96, each thread holds its units of the next tile in registers
// from the moment the stage has been stored until it frees up again; the
// rows of tile 0 (up to L) are fetched before the block knows its extent.
template <typename T>
struct RegStage {
  using U = Unit8<T>;
  unsigned char* st;
  const T* __restrict__ rows;  // the list's L rows
  int rot, nu, ksteps, L, nscan;
  bool vec, hold;
  typename U::Raw held[kHoldUnits];

  __device__ RegStage(unsigned char* st_, const T* rows_, int rot_, int L_)
      : st(st_),
        rows(rows_),
        rot(rot_),
        nu(tc_units(rot_, false)),
        ksteps(tc_ksteps(rot_, false)),
        L(L_),
        nscan(0),
        vec(rot_ % 8 == 0),
        hold(U::kHold && rot_ % 8 == 0 && tc_units(rot_, false) <= 2 * kHoldUnits) {}

  static_assert(kThreads == 2 * kTileSlots, "hold mode: two threads a tile row");

  __device__ __forceinline__ const T* unit_ptr(int t, int e, int& r, int& u) const {
    r = e / nu;
    u = e - r * nu;
    return rows + (size_t)(t * kTileSlots + r) * rot + 8 * u;
  }
  // hold mode: thread x holds units (x % 2) * kHoldUnits + i (i < kHoldUnits,
  // below nu) of tile row x / 2
  __device__ __forceinline__ void fetch(int t, int bound) {
    if constexpr (U::kHold) {
      const int r = threadIdx.x >> 1, u0 = (threadIdx.x & 1) * kHoldUnits;
      if (r < bound - t * kTileSlots) {
        const T* p = rows + (size_t)(t * kTileSlots + r) * rot + 8 * u0;
#pragma unroll
        for (int i = 0; i < kHoldUnits; ++i)
          if (u0 + i < nu) held[i] = U::load(p + 8 * i);
      }
    }
  }
  __device__ __forceinline__ void put_held(int t, int bound) {
    if constexpr (U::kHold) {
      const int r = threadIdx.x >> 1, u0 = (threadIdx.x & 1) * kHoldUnits;
      if (r < bound - t * kTileSlots) {
#pragma unroll
        for (int i = 0; i < kHoldUnits; ++i)
          if (u0 + i < nu)
            *reinterpret_cast<uint4*>(st + swz(u0 + i, r, kTileSlots)) = U::bf16(held[i]);
      }
    }
  }
  __device__ __forceinline__ void put_now(int t) {
    const int n = min(kTileSlots, nscan - t * kTileSlots) * nu;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      int r, u;
      const T* p = unit_ptr(t, e, r, u);
      *reinterpret_cast<uint4*>(st + swz(u, r, kTileSlots)) =
          vec ? U::bf16(U::load(p)) : unit8_scalar(p, rot - 8 * u);
    }
  }
  // before the extent is known: tile 0's rows in flight
  __device__ __forceinline__ void first() {
    if (hold) fetch(0, L);
  }
  // the block scans nscan slots in the order `ord` (whose first tile is
  // tile 0): tile 0 into the stage, ord(1) in flight
  template <class Ord>
  __device__ __forceinline__ void start(int nscan_, const Ord& ord) {
    nscan = nscan_;
    zero_pad_units(st, nu, ksteps);
    if (nscan > 0) {
      if (hold) {
        put_held(0, L);
        if (ord.T > 1) fetch(ord(1), nscan);
      } else {
        put_now(0);
      }
    }
    fence_proxy_async();
  }
  // step i's products are done: tile ord(i + 1) into the stage, ord(i + 2)
  // in flight
  template <class Ord>
  __device__ __forceinline__ void next(int i, const Ord& ord) {
    if (hold) {
      put_held(ord(i + 1), nscan);
      if (i + 2 < ord.T) fetch(ord(i + 2), nscan);
    } else {
      put_now(ord(i + 1));
    }
    fence_proxy_async();
  }
  __device__ __forceinline__ void wait(int) const {}
  __device__ __forceinline__ uint32_t addr(int) const { return smem_u32(st); }
};

// Kernel 3's staging where rot % 16 != 0 (no whole 16-byte rows for
// TMA): int8 rows element by element into the one stage, once it frees up.
struct RegStageI8 {
  unsigned char* st;
  const int8_t* __restrict__ rows;
  int rot, nu, ksteps, nscan;

  __device__ RegStageI8(unsigned char* st_, const int8_t* rows_, int rot_)
      : st(st_),
        rows(rows_),
        rot(rot_),
        nu(tc_units(rot_, true)),
        ksteps(tc_ksteps(rot_, true)),
        nscan(0) {}

  __device__ __forceinline__ void put_now(int t) {
    const int n = min(kTileSlots, nscan - t * kTileSlots) * nu;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / nu, u = e - r * nu;
      *reinterpret_cast<uint4*>(st + swz(u, r, kTileSlots)) =
          unit16_i8(rows + (size_t)(t * kTileSlots + r) * rot + 16 * u, rot - 16 * u);
    }
  }
  __device__ __forceinline__ void first() const {}
  template <class Ord>
  __device__ __forceinline__ void start(int nscan_, const Ord&) {
    nscan = nscan_;
    zero_pad_units(st, nu, ksteps);
    if (nscan > 0) put_now(0);
    fence_proxy_async();
  }
  template <class Ord>
  __device__ __forceinline__ void next(int i, const Ord& ord) {
    put_now(ord(i + 1));
    fence_proxy_async();
  }
  __device__ __forceinline__ void wait(int) const {}
  __device__ __forceinline__ uint32_t addr(int) const { return smem_u32(st); }
};

// Kernel 3's staging where rot % 16 == 0: a ring of kI8Stages stages,
// each filled by TMA (boxes of 128 columns x kHalfSlots rows, 128-byte
// swizzled, zeros past rot) and completed on its mbarrier. One thread
// initializes the barriers and issues every copy: tile 0 (both halves)
// before the block knows its extent, then the scanned halves only; step
// i's tile goes into stage i % kI8Stages, step i + 2's into the same stage
// once step i's products are done, so two tiles are in flight.
struct TmaStage {
  const CUtensorMap* map;  // the store as (n_lists * L, rot) bytes
  uint32_t st0, bar0, stage_bytes;
  int nkc, row0, L, nscan;

  __device__ TmaStage(const CUtensorMap* map_, const TcLayout& lay, int nkc_, int row0_, int L_)
      : map(map_),
        st0(smem_u32(lay.st)),
        bar0(smem_u32(lay.bars)),
        stage_bytes((uint32_t)kTileSlots * nkc_ * 128),
        nkc(nkc_),
        row0(row0_),
        L(L_),
        nscan(0) {}

  // step i's tile t, its halves among the first `bound` slots
  __device__ __forceinline__ void issue(int i, int t, int bound) const {
    const int s = i % kI8Stages, t0 = t * kTileSlots;
    const int halves = min(kTileSlots, bound - t0) / kHalfSlots;
    const uint32_t bar = bar0 + 8 * s, dst = st0 + s * stage_bytes;
    mbar_expect_tx(bar, (unsigned)(halves * nkc * kHalfSlots * 128));
    for (int c = 0; c < nkc; ++c)
      for (int h = 0; h < halves; ++h)
        tma_load_2d(dst + c * kTileSlots * 128 + h * kHalfSlots * 128, map, 128 * c,
                    row0 + t0 + h * kHalfSlots, bar);
  }
  // the barriers, and tile 0 in flight; a barrier publishes them
  __device__ __forceinline__ void first() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kI8Stages; ++s) mbar_init(bar0 + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      issue(0, 0, L);
    }
  }
  // the block scans nscan slots in the order `ord` (whose first tile is
  // tile 0, in flight already)
  template <class Ord>
  __device__ __forceinline__ void start(int nscan_, const Ord& ord) {
    nscan = nscan_;
    if (threadIdx.x == 0)
      for (int i = 1; i < kI8Stages && i < ord.T; ++i) issue(i, ord(i), nscan);
  }
  template <class Ord>
  __device__ __forceinline__ void next(int i, const Ord& ord) const {
    if (threadIdx.x == 0 && i + kI8Stages < ord.T) issue(i + kI8Stages, ord(i + kI8Stages), nscan);
  }
  // step i's tile
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(bar0 + 8 * (i % kI8Stages), (i / kI8Stages) & 1);
  }
  __device__ __forceinline__ uint32_t addr(int i) const {
    return st0 + (i % kI8Stages) * stage_bytes;
  }
};

// Kernel 3's staging: TmaStage, or RegStageI8 where rot % 16 != 0.
template <bool TMA>
__device__ __forceinline__ std::conditional_t<TMA, TmaStage, RegStageI8> make_i8_stage(
    const CUtensorMap* map, const TcLayout& lay, const int8_t* rows, int nkc, int row0, int rot,
    int L) {
  if constexpr (TMA)
    return TmaStage(map, lay, nkc, row0, L);
  else
    return RegStageI8(lay.st, rows, rot);
}

// ---------------------------------------------------------------------------
// the scan
// ---------------------------------------------------------------------------

// This thread's accumulator i of a tile (wgmma m64n16's layout): tile slot
// acc_slot(i), query row acc_row(i).
__device__ __forceinline__ int acc_slot(int i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return kHalfSlots * (warp >> 2) + 16 * (warp & 3) + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_row(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Scores the block's query rows (staged in lay.q; for int8 operands their
// scales in lay.rs) against the list's slots [0, nscan), tile by tile in
// the order `ord` (the tiles staged by `stage`, started on nscan and ord),
// and hands each tile to the epilogue `epi`:
//   epi.scores(t, s, active)  every thread, its 8 scores of tile t (s[i]
//                             for acc_slot(i), acc_row(i); +inf where the
//                             tile was not scored); `active`: its
//                             warpgroup's 64 slots lie before nscan;
//   epi.merge(t)              after the barrier that follows scores;
//   epi.finish()              after the last tile;
// the order is the epilogue's (Epi::kEvensFirst, TileOrder).
// L2 scores base - coef * dot (coef 2) or inner product base - dot (coef
// 1); int8 operands score through int8_score. Every thread of the block
// must call it, after a barrier that publishes lay.q and lay.rs.
template <bool I8, class Stage, class Ord, class Epi>
__device__ __forceinline__ void list_scan_tc(const TcLayout& lay, Stage& stage, const Ord& ord,
                                             const float* __restrict__ base, int nscan,
                                             int ksteps, float coef, Epi& epi) {
  using Acc = std::conditional_t<I8, int, float>;
  const int wg = threadIdx.x >> 7, s0 = acc_slot(0);
  const bool ip = coef == 1.f;
  float rs[4] = {0.f, 0.f, 0.f, 0.f};  // the scales of rows acc_row(i), at 2 (i >> 2) + (i & 1)
  if constexpr (I8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rs[i] = lay.rs[acc_row(4 * (i >> 1) + (i & 1))];
  }
  const uint32_t qa = smem_u32(lay.q);
  Acc acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0;
  if (ord.T == 0) stage.wait(0);  // nothing to scan: copies issued before the extent land first
  // this thread's two base values of the step's tile (tile 0), loaded a step ahead
  float b0 = CUDART_INF_F, b1 = CUDART_INF_F;
  if (kHalfSlots * wg < nscan) {
    b0 = base[s0];
    b1 = base[s0 + 8];
  }

  for (int i = 0; i < ord.T; ++i) {
    const int t = ord(i), t0 = t * kTileSlots;
    const bool active = t0 + kHalfSlots * wg < nscan;  // warpgroup-uniform
    stage.wait(i);
    // block-uniform, and a barrier: the last step's merges are done and
    // this step's stage is written
    const bool any = __syncthreads_or(b0 != CUDART_INF_F || b1 != CUDART_INF_F);
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = CUDART_INF_F;
    if (active && any) {
      const uint32_t a = stage.addr(i) + wg * kHalfSlots * 128;
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint32_t ka = (kk >> 2) * kTileSlots * 128 + (kk & 3) * 32;
        const uint32_t kq = (kk >> 2) * kRows * 128 + (kk & 3) * 32;
        wgmma_step(acc, sw128_desc(a + ka), sw128_desc(qa + kq), kk > 0);
      }
      wgmma_commit_wait();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = (j >> 1) & 1 ? b1 : b0;
        if constexpr (I8)
          s[j] = int8_score(acc[j], rs[(j >> 2) * 2 + (j & 1)], b, ip);
        else
          s[j] = b - coef * acc[j];
      }
    }
    epi.scores(t, s, active);
    __syncthreads();  // the scores are in; every product of step i is done
    b0 = b1 = CUDART_INF_F;
    if (i + 1 < ord.T) {
      stage.next(i, ord);
      const int n0 = ord(i + 1) * kTileSlots;
      if (n0 + kHalfSlots * wg < nscan) {
        b0 = base[n0 + s0];
        b1 = base[n0 + s0 + 8];
      }
    }
    epi.merge(t);
  }
  epi.finish();
}

// A row's running top k: WarpTopK<1> (CAP 0, k <= 32) or SharedTopK<CAP>.
template <int CAP>
struct RowTopK : SharedTopK<CAP> {};
template <>
struct RowTopK<0> : WarpTopK<1> {
  __device__ __forceinline__ void init(void*, int, int) { WarpTopK<1>::init(); }
};

// Kernels 1 and 3's epilogue: each tile's scores into the score tile
// lay.sc, then warp w merges rows kRowsPerWarp w + rr (< live) into their
// running top k; at the end each row's k lexicographically smallest
// (score, slot) pairs go best-first into its vals/idx row of width kbuf,
// positions [nscan, k) as (+inf, fill_id), past k (+inf, kSentinel).
template <int CAP>
struct TopKEpi {
  static constexpr bool kEvensFirst = false;
  const TcLayout& lay;
  RowTopK<CAP> top[kRowsPerWarp];
  int live, k, kbuf, L, nscan;
  float* vals;
  int* idx;

  __device__ TopKEpi(const TcLayout& lay_, int live_, int k_, int kbuf_, int L_, int nscan_,
                     float* vals_, int* idx_)
      : lay(lay_), live(live_), k(k_), kbuf(kbuf_), L(L_), nscan(nscan_), vals(vals_), idx(idx_) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) top[rr].init(lay.lists, warp * kRowsPerWarp + rr, lane);
  }
  __device__ __forceinline__ void scores(int, const float (&s)[8], bool active) {
    if (!active) return;  // slots past nscan: merge never reads them
#pragma unroll
    for (int i = 0; i < 8; ++i) lay.sc[acc_row(i) * kScStride + acc_slot(i)] = s[i];
  }
  __device__ __forceinline__ void merge(int t) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;  // warp-uniform
      if (r < live) top[rr].merge(lay.sc + r * kScStride, t * kTileSlots, nscan, k, lane);
    }
  }
  __device__ __forceinline__ void finish() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r < live)
        top[rr].write(vals + (size_t)r * kbuf, idx + (size_t)r * kbuf, k, kbuf, lane, nscan, L);
    }
  }
};

// Blocks an SM a list_scan_tc kernel is built for: three (at most 80
// registers a thread) where its shared memory allows (register lists, and
// shared lists of 64 pairs), else two.
__host__ __device__ constexpr int list_tc_min_blocks(int cap) { return cap <= 64 ? 3 : 2; }

}  // namespace rtt
