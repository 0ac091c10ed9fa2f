// gmm: the grouped (per-expert) matmul y[e] = x[e] @ w[e] for Hopper
// (sm_90a). x (E, C, D), w (E, D, F), fp32 or bf16 in, fp32 accumulation,
// y (E, C, F) in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:44 (gmm,
// _gmm_kernel), which the MoE layer's expert products compute
// (repro/models/moe.py::expert_ffn, the three "ecd,edf->ecf" einsums over the
// dispatch buffers). The TPU version walks an (E, C/bc, F/bf, D/bd) grid with
// the contraction axis sequential and an fp32 accumulator in VMEM scratch;
// here one launch covers every expert: the grid is (C tiles, F tiles, E), and
// each block runs its whole D loop with the accumulator in registers, so
// nothing is carried between blocks.
//
// Two bodies, chosen by the launcher from the type:
//   bf16: 128 x 128 output tiles, 8 warps of 64 x 32, the products on the
//         tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate), K
//         steps of 32 copied with cp.async in 16-byte chunks through a ring
//         of three shared buffers, so two steps' copies are in flight while
//         one step's products run. It takes x with unit stride along D and w
//         along F, D and F multiples of 8, the other strides multiples of 8
//         and both starts 16-byte aligned (what the MoE layer passes); ragged
//         C is masked, and a 16-byte chunk past the D or F edge reads zeros.
//         The wrapper (gmm.py) copies other bf16 operands into zero-padded
//         contiguous ones first;
//   fp32: ibn_pointwise's 64 x 64 tile of fp32 FMAs (4 x 4 outputs per
//         thread, K steps of 16), with the expert as the grid's z index.
//         Operands are read through their (expert, row, column) strides, so
//         strided views need no copy; ragged C, D and F are masked in the
//         loaders (zeros past the edge) and the store. No TF32: fp32 stays
//         fp32.
// Why cp.async: on an H100 at the gate/up product below, the same tiles with
// each load stored to shared memory before the next took 11.8 ms, and with a
// step's loads staged in registers 5.1 ms; the ring takes 1.1 ms
// (chip_smoke.py's gmm phase).
//
// What bounds it on an H100: qwen2-moe-a2.7b's prefill of 8 x 1024 tokens
// gives (60, 688, 2048) @ (60, 2048, 1408) in bf16, 238 GFLOP against 0.63 GB:
// bound by operations, 0.24 ms at the bf16 tensor-core peak. Decode at batch
// 8 gives C = 32: 11 GFLOP against 0.35 GB of weights, bound by bytes,
// 0.10 ms. This first version has no wgmma, no TMA and no warp
// specialisation, and the decode shape wastes 3/4 of each 128-row tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- bf16 on the tensor cores, for contiguous, 16-byte-aligned operands:
// tiles copied with cp.async through a ring of STAGES shared buffers; w stays
// [k][n] in shared memory and its fragments are gathered with two 16-bit
// reads each (conflict-free at LDB = NB + 8).
constexpr int MB = 128;
constexpr int NB = 128;
constexpr int KB = 32;
constexpr int LDS = KB + 8;  // padded row of the [m][k] x tile, in bf16
constexpr int MMA_THREADS = 256;
constexpr int STAGES = 3;
constexpr int LDB = NB + 8;  // padded row of the [k][n] w tile, in bf16
constexpr int STAGE_ELEMS = MB * LDS + KB * LDB;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(MMA_THREADS)
gmm_bf16_async(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, int C, int D, int F, long long sxe,
               long long sxc, long long swe, long long swd) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];  // STAGES x (x tile, w tile)
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * MB;
  const int n0 = blockIdx.y * NB;
  const __nv_bfloat16* xe = x + e * sxe;
  const __nv_bfloat16* we = w + e * swe;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int nk = (D + KB - 1) / KB;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

  // 16-byte chunks: x tile MB rows x KB/8, w tile KB rows x NB/8; a chunk
  // past an edge copies 0 bytes and reads as zeros
  auto load = [&](int stage, int k0) {
    __nv_bfloat16* As = ring + stage * STAGE_ELEMS;
    __nv_bfloat16* Bs = As + MB * LDS;
#pragma unroll
    for (int l = 0; l < MB * KB / 8 / MMA_THREADS; ++l) {
      const int c = tid + l * MMA_THREADS;
      const int r = c / (KB / 8);
      const int gm = m0 + r;
      const int gk = k0 + 8 * (c % (KB / 8));
      const bool in = gm < C && gk < D;
      cp_async16(&As[r * LDS + 8 * (c % (KB / 8))], in ? xe + gm * sxc + gk : xe, in ? 16 : 0);
    }
#pragma unroll
    for (int l = 0; l < KB * NB / 8 / MMA_THREADS; ++l) {
      const int c = tid + l * MMA_THREADS;
      const int r = c / (NB / 8);
      const int gk = k0 + r;
      const int gn = n0 + 8 * (c % (NB / 8));
      const bool in = gk < D && gn < F;
      cp_async16(&Bs[r * LDB + 8 * (c % (NB / 8))], in ? we + gk * swd + gn : we, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * KB);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * KB);
    cp_async_commit();
    const __nv_bfloat16* As = ring + (kt % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + MB * LDS;
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* p = &As[(wm + mt * 16 + grp) * LDS + kk + 2 * tig];
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * LDS);
        af[mt][2] = ld32(p + 8);
        af[mt][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = &Bs[(kk + 2 * tig) * LDB + wn + nt * 8 + grp];
        __nv_bfloat162 lo(p[0], p[LDB]);
        __nv_bfloat162 hi(p[8 * LDB], p[9 * LDB]);
        bf[nt][0] = *reinterpret_cast<uint32_t*>(&lo);
        bf[nt][1] = *reinterpret_cast<uint32_t*>(&hi);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* ye = y + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + mt * 16 + grp + 8 * half;
      if (gm >= C) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn + nt * 8 + 2 * tig;
        if (gn + 1 < F) {
          *reinterpret_cast<__nv_bfloat162*>(&ye[static_cast<long long>(gm) * F + gn]) =
              __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        } else if (gn < F) {
          ye[static_cast<long long>(gm) * F + gn] = __float2bfloat16(acc[mt][nt][2 * half]);
        }
      }
    }
  }
}

// ---- fp32 FMA (ibn_pointwise's tile loop with an expert index)
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int FMA_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(FMA_THREADS)
gmm_f32_fma(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
            int C, int D, int F, long long sxe, long long sxc, long long sxd, long long swe,
            long long swd, long long swf) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int e = blockIdx.z;
  const float* xe = x + e * sxe;
  const float* we = w + e * swe;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool a_k_fast = (sxd == 1);
  const bool b_n_fast = (swf == 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // one K step's loads go into registers (all in flight at once) and are
  // stored to shared memory; the next step's loads are issued before this
  // step's products, so their latency overlaps the math
  constexpr int LA = BM * BK / FMA_THREADS;
  constexpr int LB = BK * BN / FMA_THREADS;
  float ra[LA];
  float rb[LB];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * FMA_THREADS;
      const int gm = m0 + (a_k_fast ? idx / BK : idx % BM);
      const int gk = k0 + (a_k_fast ? idx % BK : idx / BM);
      ra[l] = (gm < C && gk < D) ? xe[gm * sxc + gk * sxd] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * FMA_THREADS;
      const int gk = k0 + (b_n_fast ? idx / BN : idx % BK);
      const int gn = n0 + (b_n_fast ? idx % BN : idx / BK);
      rb[l] = (gk < D && gn < F) ? we[gk * swd + gn * swf] : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * FMA_THREADS;
      As[a_k_fast ? idx % BK : idx / BM][a_k_fast ? idx / BK : idx % BM] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * FMA_THREADS;
      Bs[b_n_fast ? idx / BN : idx % BK][b_n_fast ? idx % BN : idx / BK] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4];
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ye = y + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < F) ye[static_cast<long long>(gm) * F + gn] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16. strides: 6 element strides, (expert, row, column)
// of x then of w; y is a contiguous (E, C, F) tensor. Returns a CUDA error
// code (0 when the launch was accepted); bf16 operands that the bf16 body
// does not take return cudaErrorInvalidValue.
extern "C" int gmm_launch(int dtype, const void* x, const void* w, void* y, int E, int C,
                          int D, int F, const long long* strides, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((C + MB - 1) / MB, (F + NB - 1) / NB, E);
    const bool aligned16 = s[2] == 1 && s[5] == 1 && D % 8 == 0 && F % 8 == 0 &&
                           s[0] % 8 == 0 && s[1] % 8 == 0 && s[3] % 8 == 0 && s[4] % 8 == 0 &&
                           reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (!aligned16) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(sizeof(__nv_bfloat16)) * STAGES * STAGE_ELEMS;
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_bf16_async, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_bf16_async<<<grid, MMA_THREADS, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), C, D, F, s[0], s[1], s[3], s[4]);
  } else if (dtype == 0) {
    const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
    gmm_f32_fma<<<grid, FMA_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        C, D, F, s[0], s[1], s[2], s[3], s[4], s[5]);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
