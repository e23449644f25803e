// fused_l2_argmin: fused L2 distance + argmin (1-NN) for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_tpu/ops/fused_l2_argmin.py:
// fused_l2_argmin_pallas (_make_kernel :40, pallas_call at :114, lane
// reduction :132-141). For each row i of an f32 (m, k) x, the row j of an
// f32 (n, k) y minimizing d_ij = max(xn_i + (yn_j + <x_i, y2_j>), 0) with
// y2 = -2y (exact) and xn, yn the squared row norms (the augmented
// product [x, 1] . [-2y, yn]): the (m,) minimum, its sqrt if asked, and
// the (m,) int32 index. The clamp comes before the comparison, so every
// candidate that rounds below zero ties at 0.0 and the lowest index wins;
// the lowest index wins every exact tie. The (m, n) distances never reach
// device memory.
//
// What bounds it on the H100: 2 m n (k + 1) f32 operations against
// (m + n) k 4 input bytes; at the k-means labelling shape (1M x 1024 x 96)
// the operations. On the CUDA cores that is 66.9 TFLOP/s; this kernel
// runs the dots on the tensor cores instead, as f32-accurate split TF32
// (three TF32 products a multiply-add, 495 TFLOP/s dense), which bounds
// the same work at 3 x 2 m n k / 495e12.
//
// Design (split TF32, "3xTF32"): every operand a splits into
// hi = tf32(a) and lo = tf32(a - hi), tf32() rounding to 10 mantissa bits
// to nearest, ties away from zero (cvt.rna.tf32.f32's rounding, written as
// integer operations so that the low 13 bits are zero); a.b is then
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, the dropped lo.lo term about 2^-22
// of |a||b|. y2 is split once per call by the wrapper and packed in the
// order the kernel loads it (ops/fused_l2_argmin.py). Per depth step of 8
// the three products (lo.hi and hi.lo first, then hi.hi) go into a fresh
// accumulator, which is then added (IEEE f32) into the pair's running
// sum, started at yn_j: the short chains keep the tensor cores' own
// rounding of each accumulation relative to one step's dots, not to the
// whole sum. One wgmma kernel serves every depth: a block owns 128 rows of
// x, two warpgroups of 64 rows each against column tiles of 128,
// m64n128k8 tf32 on K-major 128-byte-swizzled operands; y streams through
// a 3-stage cp.async ring in chunks of 32 columns of depth, and two
// accumulators alternate so one step's products overlap the previous
// step's additions. Up to a padded depth of 128 (the main path's 96) the
// block's x tile stays resident in shared memory for its whole walk over
// y, split once per block from the raw tile; past it the split tile does
// not fit, and x comes pre-split by the wrapper in the same chunk layout
// as y and streams through the ring beside it.
// xn_i comes from the x values the block loads (one fused multiply-add a
// column, in column order), so no pass over x precedes the kernel.
// Epilogue per column tile: each thread folds its columns, ascending,
// strict <, after the clamp, into one running (best, index) per row; a row
// lies in one quad of one warp, so at the end the quad reduces on
// (distance, index) in lexicographic order. No atomics: the result is
// deterministic. The first candidate a thread sees always enters (so a row
// whose distances are all +inf reports index 0, as the reference's argmin
// does); columns past n never enter, rows past m are not stored. Depth
// past k is zero in both operands: zeros add exact zeros. On integer grids
// hi is exact and lo zero, so every sum is exact and the kernel equals its
// plain version bit for bit.
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rfl {

constexpr int kThreads = 256;           // two warpgroups
constexpr int kBM = 128;                // x rows per block
constexpr int kBN = 128;                // y rows (product columns) per tile: wgmma N
constexpr int kKC = 32;                 // depth per staged chunk: 4 steps of 8
constexpr int kStages = 3;              // chunks in flight
constexpr int kSteps = kKC / 8;         // wgmma depth steps per chunk
constexpr int kHalf = kBN * 128;        // hi or lo of a 32-deep chunk of 128 rows (16 KB)
constexpr int kChunk = 2 * kHalf;       // a split chunk: hi, then lo
constexpr int kResidentDepth = 128;     // padded depth up to which the x tile stays resident
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int depth_padded(int k) { return (k + kKC - 1) / kKC * kKC; }
// a ring stage: the y chunk, and the x chunk beside it when x streams
__host__ __device__ constexpr size_t stage_bytes(bool resident) {
  return resident ? kChunk : 2 * kChunk;
}
// Dynamic shared memory: 1024 bytes of alignment slack, the resident x
// tile split (hi chunks, then lo chunks), the ring, |x|^2 of the tile's
// rows. The prologue stages raw x slabs of up to kResidentDepth columns
// through the ring, which holds one (128 x 132 floats) at any depth.
__host__ __device__ constexpr size_t smem_bytes(int kpad) {
  return 1024 + (kpad <= kResidentDepth ? (size_t)kpad / kKC * kChunk : 0) +
         (size_t)kStages * stage_bytes(kpad <= kResidentDepth) + sizeof(float) * kBM;
}

// the bits of a rounded to tf32: to nearest, ties away from zero, low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));  // a - hi is exact
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * stride + c] <- x[row0 + r][k0 + c] for r < kBM, c < width; zeros
// past m and k. `vec`: k % 4 == 0 and x 16-byte aligned (4 floats a copy).
__device__ __forceinline__ void stage_x(float* dst, int stride, const float* __restrict__ x,
                                        int row0, int m, int k, int k0, int width, bool vec) {
  if (vec) {
    const int w4 = width / 4;
    for (int e = threadIdx.x; e < kBM * w4; e += kThreads) {
      const int r = e / w4, c = (e - r * w4) * 4;
      const bool ok = row0 + r < m && k0 + c < k;
      cp_async16(dst + r * stride + c, ok ? x + (size_t)(row0 + r) * k + k0 + c : x, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < kBM * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    const bool ok = row0 + r < m && k0 + c < k;
    cp_async4(dst + r * stride + c, ok ? x + (size_t)(row0 + r) * k + k0 + c : x, ok);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// wgmma shared-memory descriptor of a K-major, 128-byte swizzled operand
// at `addr`: stride between 8-row groups 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A[64 x 8] * B[128 x 8]^T, tf32, both K-major in shared memory;
// `accumulate` 0 ignores d's old values.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
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

// The prologue stages the raw x tile through the ring in slabs of up to
// kResidentDepth columns, sums each row's |x|^2 (one thread a row, in
// column order) and, when the tile stays resident, writes it split, hi
// and lo, K-major and 128-byte swizzled in chunks of 32 columns. y (and x
// past kResidentDepth) come pre-split and pre-swizzled (pack_split), one
// chunk a unit, by cp.async. Per depth step of 8: three wgmma m64n128k8
// (lo.hi, hi.lo, hi.hi) into a fresh accumulator, then its 64 values
// added into the running sums (started at yn_j); two accumulators
// alternate, so the next step's products overlap these additions.
// RESIDENT: the padded depth is at most kResidentDepth (a compile-time
// choice, so the resident loop carries no test of the streamed one).
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    l2_argmin_kernel(const float* __restrict__ x, const float4* __restrict__ xp,
                     const float4* __restrict__ yp, const float* __restrict__ yn,
                     float* __restrict__ dist, int* __restrict__ idx, int m, int n, int k,
                     int take_sqrt) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int kpad = depth_padded(k);
  const int nkc = kpad / kKC;
  constexpr size_t stage = stage_bytes(RESIDENT);
  unsigned char* xh = sm;                                                  // resident hi chunks
  unsigned char* xl = sm + (size_t)nkc * kHalf;                            // resident lo chunks
  unsigned char* ring = sm + (RESIDENT ? (size_t)nkc * kChunk : 0);        // kStages stages
  float* xn_s = reinterpret_cast<float*>(ring + (size_t)kStages * stage);
  const int row0 = blockIdx.x * kBM;
  const int nct = (n + kBN - 1) / kBN;
  const int units = nct * nkc;  // (column tile, depth chunk), in that order
  const bool vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, wg = w / 4;
  const int g = lane / 4, t = lane % 4;

  // prologue: the raw tile through the ring (all of it when resident,
  // kResidentDepth columns at a time past that; zeros past k), |x|^2,
  // then the resident split tile
  float* raw = reinterpret_cast<float*>(ring);
  float xsum = 0.f;
  auto sum_slab = [&](int k0, int width) {  // stage columns k0 .. k0 + width, add their squares
    stage_x(raw, width + 4, x, row0, m, k, k0, width, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < kBM) {
      const float* r = raw + threadIdx.x * (width + 4);
      for (int c = 0; c < width; ++c) xsum = fmaf(r[c], r[c], xsum);
    }
  };
  if constexpr (RESIDENT) {
    sum_slab(0, kpad);
  } else {
    for (int k0 = 0; k0 < kpad; k0 += kResidentDepth) {
      if (k0 > 0) __syncthreads();  // the previous slab is summed
      sum_slab(k0, kResidentDepth);
    }
  }
  if (threadIdx.x < kBM) xn_s[threadIdx.x] = xsum;
  if constexpr (RESIDENT) {
    for (int e = threadIdx.x; e < kBM * (kpad / 4); e += kThreads) {
      const int r = e / (kpad / 4), u = e - r * (kpad / 4);  // row, 16-byte unit
      const float4 v = *reinterpret_cast<const float4*>(raw + r * (kpad + 4) + 4 * u);
      uint32_t h[4], l[4];
      split(v.x, h[0], l[0]);
      split(v.y, h[1], l[1]);
      split(v.z, h[2], l[2]);
      split(v.w, h[3], l[3]);
      const size_t off = (size_t)(u / 8) * kHalf + r * 128 + (((u % 8) ^ (r % 8)) << 4);
      *reinterpret_cast<uint4*>(xh + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(xl + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
  fence_proxy_async();  // the split tile, for wgmma
  __syncthreads();      // and the ring is free for the chunks

  auto prefetch = [&](int u) {
    unsigned char* dst = ring + (size_t)(u % kStages) * stage;
    const float4* src = yp + (size_t)u * (kChunk / 16);  // units are stored in order
    for (int e = threadIdx.x; e < kChunk / 16; e += kThreads)
      cp_async16(reinterpret_cast<float4*>(dst) + e, src + e, true);
    if constexpr (!RESIDENT) {  // the block's x chunk kc: tile blockIdx.x of the same layout
      const float4* xs = xp + ((size_t)blockIdx.x * nkc + u % nkc) * (kChunk / 16);
      for (int e = threadIdx.x; e < kChunk / 16; e += kThreads)
        cp_async16(reinterpret_cast<float4*>(dst + kChunk) + e, xs + e, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) prefetch(s);
    cp_async_commit();
  }

  const int r0 = wg * 64 + (w % 4) * 16 + g;  // this thread's rows: r0, r0 + 8
  const float xr0 = xn_s[r0], xr1 = xn_s[r0 + 8];
  float best[2] = {CUDART_INF_F, CUDART_INF_F};
  int bidx[2] = {-1, -1};  // no candidate yet
  float sum[64], acc[2][64];

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // this thread's copies of unit u, for wgmma
    __syncthreads();      // everyone's; stage (u - 1) % kStages is free
    if (u + kStages - 1 < units) prefetch(u + kStages - 1);
    cp_async_commit();

    const int ct = u / nkc, kc = u - ct * nkc;
    const uint32_t b_hi = smem_u32(ring + (size_t)(u % kStages) * stage), b_lo = b_hi + kHalf;
    const uint32_t a_hi = (RESIDENT ? smem_u32(xh) + kc * kHalf : b_hi + kChunk) + wg * 64 * 128;
    const uint32_t a_lo = (RESIDENT ? smem_u32(xl) + kc * kHalf : b_lo + kChunk) + wg * 64 * 128;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = ct * kBN + 8 * j + 2 * t;
        const float y0 = c < n ? yn[c] : 0.f, y1 = c + 1 < n ? yn[c + 1] : 0.f;
        sum[4 * j] = y0;
        sum[4 * j + 1] = y1;
        sum[4 * j + 2] = y0;
        sum[4 * j + 3] = y1;
      }
    }
    // step ks's three products go to acc[ks % 2]: step ks + 1's run on
    // the tensor cores while step ks's are added into the sums
    auto products = [&](float (&a)[64], int ks) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_m64n128k8(a, sw128_desc(a_lo + 32 * ks), sw128_desc(b_hi + 32 * ks), 0);
      wgmma_m64n128k8(a, sw128_desc(a_hi + 32 * ks), sw128_desc(b_lo + 32 * ks), 1);
      wgmma_m64n128k8(a, sw128_desc(a_hi + 32 * ks), sw128_desc(b_hi + 32 * ks), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    products(acc[0], 0);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks + 1 < kSteps) {
        products(acc[(ks + 1) % 2], ks + 1);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[ks % 2][i]);
    }
    if (kc == nkc - 1) {
      // fold this tile's columns, ascending, strict <, after the clamp
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ct * kBN + 8 * j + 2 * t + e;
          if (c < n) {
            const float d0 = fmaxf(__fadd_rn(xr0, sum[4 * j + e]), 0.f);
            const float d1 = fmaxf(__fadd_rn(xr1, sum[4 * j + 2 + e]), 0.f);
            if (bidx[0] < 0 || d0 < best[0]) {
              best[0] = d0;
              bidx[0] = c;
            }
            if (bidx[1] < 0 || d1 < best[1]) {
              best[1] = d1;
              bidx[1] = c;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = bidx[h] < 0 ? CUDART_INF_F : best[h];
    int id = bidx[h] < 0 ? INT_MAX : bidx[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the quad holding the row
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oid = __shfl_xor_sync(kFull, id, off);
      if (ov < v || (ov == v && oid < id)) {
        v = ov;
        id = oid;
      }
    }
    const int r = row0 + r0 + 8 * h;
    if (t == 0 && r < m) {
      dist[r] = take_sqrt ? sqrtf(v) : v;
      idx[r] = id;
    }
  }
  cp_async_wait<0>();
}

}  // namespace rfl

// yp: -2y split into tf32 (hi, lo) and packed by ops/fused_l2_argmin.py
// (pack_split); xp: x packed the same way when k rounded up to 32 is past
// kResidentDepth (else unused, may be null). Returns the launch's
// cudaError_t.
extern "C" int fused_l2_argmin_launch(const void* x, const void* xp, const void* yp,
                                      const void* yn, void* dist, void* idx, int m, int n, int k,
                                      int take_sqrt, void* stream) {
  using namespace rfl;
  if (m == 0) return 0;
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int kpad = depth_padded(k);
  const bool resident = kpad <= kResidentDepth;
  if (!resident && xp == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kpad);
  const auto kernel = resident ? l2_argmin_kernel<true> : l2_argmin_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((long long)m + kBM - 1) / kBM);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float4*>(xp),
      static_cast<const float4*>(yp), static_cast<const float*>(yn), static_cast<float*>(dist),
      static_cast<int*>(idx), m, n, k, take_sqrt);
  return (int)cudaGetLastError();
}
