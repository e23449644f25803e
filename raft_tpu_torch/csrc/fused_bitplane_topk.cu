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
// What bounds it on the H100: per (live row, real slot) it does bits * W
// AND + popcount pairs (24 at rot_dim 96 and 8 query bits) on operands
// read once: the popcount rate (16 a clock an SM) bounds it, far above
// the bytes. The selection of each row's top k is the larger cost in
// practice, and grows with k.
//
// Design: fused_common.cuh's scan_topk_dots with the BitplaneDots policy.
// A block stages its rows' bit planes (bits * W words each) and qmeta in
// shared memory once. Thread t owns slot t % 128 of each 128-slot tile:
// it reads its slot's W code words straight from the word-transposed
// codes_t (neighbouring threads on neighbouring slots, so every load
// coalesces; nothing of the store is staged), and its slot's meta, and
// ANDs each code word against the planes of its eight rows (warp-wide
// shared-memory broadcasts). Blocks past a chunk's live rows exit, and
// tiles whose slots are all +inf skip their popcounts. Selection, by k
// alone (never by the data): up to k = 32 each row keeps a running exact
// top-k in its warp's registers (fused_common.cuh's WarpTopK, one
// register a lane, one shuffle an insertion); past it each row's list and a
// buffer of candidates live in shared memory and the warp sorts and
// merges the buffer in batches (block_topk.cuh's SharedTopK), which frees
// the registers the KR = 8 lists spilled and replaces ~k ln(L / k)
// one-at-a-time insertions by a few sort-and-merge rounds. Both select
// exactly, so both give the same bits.
#include "block_topk.cuh"

namespace rtt {

constexpr int kMaxBits = 8;  // ops/fused_scan.BITPLANE_MAX_BITS

struct BitplaneDots {
  using Store = uint32_t;
  using Acc = int;
  const uint32_t* pl_s;          // kRows x pw plane words
  const float* qm_s;             // 4 x kRows: lo, delta, qsum, qconst
  const float* __restrict__ meta;  // the list's (3, L) meta rows
  int words, bits, pw, L;
  float rsq;
  bool ip;
  float pop_, rn_, od_;  // this thread's slot of the current tile

  // pw = bits * words plane words a row
  __host__ __device__ static size_t smem_bytes(int pw) {
    return sizeof(uint32_t) * kRows * (size_t)pw + sizeof(float) * 4 * kRows;
  }
  // Stages rows [0, nrows) of planes (row stride pw) and of qmeta (four
  // rows of stride `chunk`); the first tile's barrier publishes them.
  __device__ BitplaneDots(void* smem, const uint32_t* planes, const float* qmeta, int chunk,
                          int nrows, const float* meta_, int words_, int bits_, int L_,
                          float rsq_, bool ip_)
      : pl_s(static_cast<uint32_t*>(smem)),
        qm_s(reinterpret_cast<float*>(static_cast<uint32_t*>(smem) + kRows * words_ * bits_)),
        meta(meta_),
        words(words_),
        bits(bits_),
        pw(words_ * bits_),
        L(L_),
        rsq(rsq_),
        ip(ip_),
        pop_(0.f),
        rn_(0.f),
        od_(1.f) {
    uint32_t* ps = static_cast<uint32_t*>(smem);
    float* qs = reinterpret_cast<float*>(ps + kRows * pw);
    for (int e = threadIdx.x; e < kRows * pw; e += kThreads) {
      const int r = e / pw;
      ps[e] = r < nrows ? planes[(size_t)r * pw + (e - r * pw)] : 0u;
    }
    for (int e = threadIdx.x; e < 4 * kRows; e += kThreads) {
      const int f = e / kRows, r = e - f * kRows;
      qs[e] = r < nrows ? qmeta[(size_t)f * chunk + r] : 0.f;
    }
  }
  // acc[r] += S_u of this thread's rows against slot t0 + (t % kTileSlots)
  __device__ __forceinline__ void tile(int (&acc)[kRowsHalf], const uint32_t* __restrict__ codes,
                                       int n, int t0) {
    const int s = threadIdx.x % kTileSlots, half = threadIdx.x / kTileSlots;
    const int col = t0 + s;
    if (col >= n) return;
    pop_ = meta[col];
    rn_ = meta[L + col];
    od_ = meta[2 * L + col];
    const uint32_t* rows = pl_s + half * kRowsHalf * pw;
    for (int w = 0; w < words; ++w) {
      const uint32_t c = codes[(size_t)w * L + col];
      for (int j = 0; j < bits; ++j) {
#pragma unroll
        for (int r = 0; r < kRowsHalf; ++r) acc[r] += __popc(rows[r * pw + j * words + w] & c) << j;
      }
    }
  }
  // `row`: the query row within the block. A slot whose base is +inf
  // scores +inf whatever its estimate (the reference's `score + inf`);
  // its tile may have been skipped, so its meta is not read.
  __device__ __forceinline__ float score(float b, int acc, int row) const {
    if (b == CUDART_INF_F) return CUDART_INF_F;
    const float lo = qm_s[row], delta = qm_s[kRows + row];
    const float qsum = qm_s[2 * kRows + row], qc = qm_s[3 * kRows + row];
    const float su = __int2float_rn(acc);  // < 255 * rot_dim < 2^24: exact
    const float s = __fmaf_rn(lo, pop_, __fmul_rn(delta, su));
    const float est =
        __fdiv_rn(__fmul_rn(__fsub_rn(__fmul_rn(2.f, s), qsum), rsq), fmaxf(od_, 1e-12f));
    const float sc = ip ? -__fmaf_rn(rn_, est, qc)
                        : __fmaf_rn(-__fmul_rn(2.f, rn_), est, __fmaf_rn(rn_, rn_, qc));
    return __fadd_rn(sc, b);
  }
};

// Three blocks per SM (at most 80 registers a thread), as the other list
// kernels. CAP: the selection (block_topk.cuh: with_selection), 0 for
// WarpTopK<1> (k <= 32), else SharedTopK<CAP> with its lists after the
// scores and the staged planes in shared memory.
template <int CAP>
__global__ void __launch_bounds__(kThreads, 3)
    bitplane_kernel(const int* __restrict__ lof, const uint32_t* __restrict__ planes,
                    const uint32_t* __restrict__ codes_t, const float* __restrict__ meta,
                    const float* __restrict__ base, const float* __restrict__ qmeta,
                    const int* __restrict__ live_rows, float* __restrict__ vals,
                    int* __restrict__ idx, int chunk, int words, int bits, int L, int k, int kbuf,
                    float rsq, bool ip) {
  extern __shared__ float4 smem4[];
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, chunk - row0);
  const size_t out0 = ((size_t)c * chunk + row0) * kbuf;
  const int live = live_prefix(live_rows, c, row0, nrows, vals + out0, idx + out0, kbuf, kSentinel);
  if (live <= 0) return;  // an empty chunk, or past its live rows: no work
  const int list = lof[c];
  const int pw = bits * words;
  float* sc = reinterpret_cast<float*>(smem4);
  BitplaneDots dots(sc + kRows * kTileSlots, planes + ((size_t)c * chunk + row0) * pw,
                    qmeta + (size_t)c * 4 * chunk + row0, chunk, live, meta + (size_t)list * 3 * L,
                    words, bits, L, rsq, ip);
  const uint32_t* codes = codes_t + (size_t)list * words * L;
  if constexpr (CAP > 0) {
    // 16-byte aligned: the scores and staging are whole float4s before it
    void* lists = smem4 + (topk_smem_bytes<BitplaneDots>(pw) + 15) / 16;
    scan_topk_shared<CAP>(sc, lists, dots, live, codes, base + (size_t)list * L, L, k, kbuf,
                          vals + out0, idx + out0);
  } else {
    scan_topk_dots<1>(sc, dots, live, codes, base + (size_t)list * L, L, k, kbuf, vals + out0,
                      idx + out0);
  }
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
    size_t smem = topk_smem_bytes<BitplaneDots>(bits * words);
    if (CAP > 0) smem = (smem + 15) / 16 * 16 + block_lists_bytes(CAP);
    cudaError_t err = cudaFuncSetAttribute(bitplane_kernel<CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    bitplane_kernel<CAP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lof), static_cast<const uint32_t*>(planes),
        static_cast<const uint32_t*>(codes_t), static_cast<const float*>(meta),
        static_cast<const float*>(base), static_cast<const float*>(qmeta),
        static_cast<const int*>(live_rows), static_cast<float*>(vals), static_cast<int*>(idx),
        chunk, words, bits, L, k, kbuf, rsq, inner_product != 0);
    return (int)cudaGetLastError();
  });
}
