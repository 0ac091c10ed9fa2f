// warp_tiles.cuh: warp-level tile products on shared memory for the backward
// kernels (flash_attention_bwd.cu, ssd_scan_bwd.cu), one code path for both
// element types. A warp owns a 16-row tile of an fp32 sum laid out as
// mma.sync's m16n8 C fragments: lane (grp = lane / 4, tig = lane % 4) holds,
// for n8 tile t, element e at row grp + 8 (e / 2) and column 8 t + 2 tig +
// e % 2 (frag_row, frag_col). bf16 operands go through ldmatrix and
// mma.sync.m16n8k16 (exact products, fp32 sum); fp32 operands through FMAs
// in fp32 on the same fragment layout (no TF32: fp32 stays fp32). Shared
// tiles are row-major with rows padded by 16 bytes (PAD<T>), so the eight
// rows an ldmatrix reads fall in distinct banks. Also: block-wide scans and
// sums in a fixed order (deterministic), and strided tile loads from device
// memory with the edges zero-filled.
#pragma once

#include "hopper.cuh"

namespace tiles {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
constexpr int PAD = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ int frag_row(int e) { return (threadIdx.x & 31) / 4 + 8 * (e >> 1); }
__device__ __forceinline__ int frag_col(int t, int e) {
  return 8 * t + 2 * (threadIdx.x & 3) + (e & 1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// acc (16 x 8 NT) += A (16 x K) B (K x 8 NT), all operands in shared memory.
// A's element (m, k) lies at a[m * lda + k], or at a[k * lda + m] with A_KM;
// B's element (k, n) at b[n * ldb + k], or at b[k * ldb + n] with B_KN. K is
// a multiple of 16 and NT even (bf16 takes two n8 tiles an ldmatrix); both
// are compile-time, so the K steps unroll and their fragment loads overlap.
template <typename T, int NT, int K, bool A_KM, bool B_KN>
__device__ __forceinline__ void mma(float (&acc)[NT][4], const T* a, int lda, const T* b,
                                    int ldb) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    static_assert(NT % 2 == 0 && K % 16 == 0, "bf16 tiles come in pairs of n8, K in 16s");
    const int i = lane >> 3;
    const int r = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4];
      if constexpr (A_KM)
        ldsm_x4_t(af, a + (k0 + r + 8 * (i >> 1)) * lda + 8 * (i & 1));
      else
        ldsm_x4(af, a + (r + 8 * (i & 1)) * lda + k0 + 8 * (i >> 1));
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t bf[4];
        if constexpr (B_KN)
          ldsm_x4_t(bf, b + (k0 + r + 8 * (i & 1)) * ldb + 8 * t + 8 * (i >> 1));
        else
          ldsm_x4(bf, b + (8 * t + r + 8 * (i >> 1)) * ldb + k0 + 8 * (i & 1));
        const uint32_t b0[2] = {bf[0], bf[1]};
        const uint32_t b1[2] = {bf[2], bf[3]};
        mma_bf16(acc[t], af, b0);
        mma_bf16(acc[t + 1], af, b1);
      }
    }
  } else {
    const int grp = lane >> 2;
    const int tig = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A_KM ? a[k * lda + grp] : a[grp * lda + k];
      const float a1 = A_KM ? a[k * lda + grp + 8] : a[(grp + 8) * lda + k];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = 8 * t + 2 * tig;
        const float b0 = B_KN ? b[k * ldb + n] : b[n * ldb + k];
        const float b1 = B_KN ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
        acc[t][0] = fmaf(a0, b0, acc[t][0]);
        acc[t][1] = fmaf(a0, b1, acc[t][1]);
        acc[t][2] = fmaf(a1, b0, acc[t][2]);
        acc[t][3] = fmaf(a1, b1, acc[t][3]);
      }
    }
  }
}

// a row's sum over the four lanes of its quad
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// a ROWS x COLS tile of a strided tensor (element (r, c) at src[r * rs + c *
// cs]) into shared memory (row stride ld) as T, by a block of THREADS
// threads; rows past `rows_in` and columns past `cols_in` are zeros. With
// `lo`, each value v is stored as its T rounding hi in dst and v - hi,
// rounded, at the same place in lo (fp32 into bf16 hi and lo parts: about 16
// bits of v). Where the tile's rows are contiguous and 16-byte aligned each
// thread moves 16 bytes at a time; either way a thread issues up to 8 loads
// before it stores, so the loads are in flight together.
template <int ROWS, int COLS, int THREADS, typename T, typename S>
__device__ __forceinline__ void load_tile(T* dst, int ld, const S* src, long long rs,
                                          long long cs, int rows_in, int cols_in,
                                          T* lo = nullptr) {
  auto put = [&](int at, float v) {
    const T hi = from_f32<T>(v);
    dst[at] = hi;
    if (lo != nullptr) lo[at] = from_f32<T>(v - to_f32(hi));
  };
  constexpr int VEC = 16 / static_cast<int>(sizeof(S));
  constexpr int BATCH = 8;
  if (COLS % VEC == 0 && cs == 1 && rs % VEC == 0 && cols_in % VEC == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    constexpr int CPR = COLS / VEC;  // 16-byte chunks a row
    constexpr int CHUNKS = ROWS * CPR;
    for (int base = 0; base < CHUNKS; base += BATCH * THREADS) {
      uint4 buf[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int ch = base + u * THREADS + threadIdx.x;
        const int r = ch / CPR;
        const int c = ch % CPR * VEC;
        buf[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ch < CHUNKS && r < rows_in && c < cols_in)
          buf[u] = *reinterpret_cast<const uint4*>(src + r * rs + c);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int ch = base + u * THREADS + threadIdx.x;
        if (ch >= CHUNKS) continue;
        const int at = (ch / CPR) * ld + ch % CPR * VEC;
        if constexpr (sizeof(S) == sizeof(T)) {
          *reinterpret_cast<uint4*>(dst + at) = buf[u];
        } else {
          const S* v = reinterpret_cast<const S*>(&buf[u]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) put(at + j, to_f32(v[j]));
        }
      }
    }
  } else {
    constexpr int N = ROWS * COLS;
    for (int base = 0; base < N; base += BATCH * THREADS) {
      float buf[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = base + u * THREADS + threadIdx.x;
        const int r = idx / COLS;
        const int c = idx % COLS;
        buf[u] = idx < N && r < rows_in && c < cols_in ? to_f32(src[r * rs + c * cs]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = base + u * THREADS + threadIdx.x;
        if (idx < N) put((idx / COLS) * ld + idx % COLS, buf[u]);
      }
    }
  }
}

// v[0 .. n) replaced by its inclusive prefix sums (from the end with
// `reverse`), by the whole block, in a fixed order: a serial run per thread
// over a contiguous stretch, then thread 0's serial scan of the runs.
// `tmp` holds blockDim.x floats. Ends with the block synchronised.
__device__ __forceinline__ void block_scan(float* v, int n, bool reverse, float* tmp) {
  __syncthreads();
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(n, lo + per);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    float& x = v[reverse ? n - 1 - i : i];
    run += x;
    x = run;
  }
  tmp[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) {
      const float r = tmp[t];
      tmp[t] = acc;
      acc += r;
    }
  }
  __syncthreads();
  const float off = tmp[threadIdx.x];
  for (int i = lo; i < hi; ++i) v[reverse ? n - 1 - i : i] += off;
  __syncthreads();
}

// the block's sum of each thread's `v`, in a fixed order (thread 0 adds the
// threads' values in turn); every thread gets it. `tmp` holds blockDim.x
// floats.
__device__ __forceinline__ float block_sum(float v, float* tmp) {
  __syncthreads();
  tmp[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int t = 0; t < static_cast<int>(blockDim.x); ++t) acc += tmp[t];
    tmp[0] = acc;
  }
  __syncthreads();
  const float out = tmp[0];
  __syncthreads();
  return out;
}

}  // namespace tiles
