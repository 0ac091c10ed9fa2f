// ibn_pointwise: y = act(x @ w + b) for Hopper (sm_90a), fp32 or bf16 in,
// fp32 accumulation, bias and activation fused into the epilogue.
//
// Replaces the Pallas TPU kernel repro/kernels/ibn_conv.py::ibn_pointwise
// (_pw_kernel). The TPU version walks an (nn, nf, nk) grid in order and
// carries the fp32 sum over Cin tiles in VMEM scratch; here each block owns
// one BM x BN output tile and runs the whole Cin loop itself, so nothing is
// carried between blocks. Ragged edges are masked inside the kernel (loads
// read zero past the edge, stores are skipped), never padded in memory.
//
// What bounds it on an H100: the convnets' 1x1 products are thin (Cin and
// Cout from 8 to 1280) with many rows (batch * H * W pixels), so most of them
// are bound by bytes: MobileNetV2's first expand at 224 px, batch 8, reads
// x (100352, 16) and writes y (100352, 96) fp32, about 45 MB or 13 us at
// 3.35 TB/s, against about 5 us of fp32 FMA at 67 TFLOP/s. The head conv at
// 7x7, (392, 320) @ (320, 1280), leans toward operations. This first version
// is a plain shared-memory-tiled fp32 FMA GEMM: every input element is read
// once per output tile that needs it, the epilogue writes y once, and fp32
// stays fp32 (no TF32) because the model is fp32 and parity is the point.
// wgmma, TMA and tuning are later work.
//
// Strided operands: x is read through (stride_m, stride_k) and w through
// (stride_k, stride_n), so the backward pass passes transposed views
// (dx = dz @ w^T, dw = x^T @ dz) without copying them. The loaders walk
// whichever axis has unit stride with consecutive threads.
//
// Split-K: a product with few output tiles and a long K (dw at full width
// has M = Cin, N = Cout and K = all pixels) would leave most SMs idle. Then
// the grid's z axis cuts K into `splits` chunks; each writes its fp32
// partial tile to a workspace, and a second pass sums the partials in a
// fixed order (deterministic) and applies the epilogue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int LOADS_A = BM * BK / THREADS;
constexpr int LOADS_B = BK * BN / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act: 0 none, 1 relu, 2 silu
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v / (1.0f + expf(-v));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pw_gemm(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
        T* __restrict__ y, float* __restrict__ ws, int M, int K, int N,
        long long sxm, long long sxk, long long swk, long long swn, int act,
        int k_chunk) {
  __shared__ float As[BK][BM + 1];  // +1: the k-fast loader's stores spread over banks
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const bool a_k_fast = (sxk == 1);
  const bool b_n_fast = (swn == 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LOADS_A; ++l) {
      const int idx = tid + l * THREADS;
      const int r = a_k_fast ? idx / BK : idx % BM;  // row in the tile (m)
      const int c = a_k_fast ? idx % BK : idx / BM;  // column in the tile (k)
      const int gm = m0 + r;
      const int gk = k0 + c;
      float v = 0.0f;
      if (gm < M && gk < k_end) v = to_f32(x[gm * sxm + gk * sxk]);
      As[c][r] = v;
    }
#pragma unroll
    for (int l = 0; l < LOADS_B; ++l) {
      const int idx = tid + l * THREADS;
      const int r = b_n_fast ? idx / BN : idx % BK;  // row in the tile (k)
      const int c = b_n_fast ? idx % BN : idx / BK;  // column in the tile (n)
      const int gk = k0 + r;
      const int gn = n0 + c;
      float v = 0.0f;
      if (gk < k_end && gn < N) v = to_f32(w[gk * swk + gn * swn]);
      Bs[r][c] = v;
    }
    __syncthreads();
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

  const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = static_cast<size_t>(gm) * N + gn;
      if (ws != nullptr) {
        ws[blockIdx.z * plane + o] = acc[i][j];
      } else {
        float v = acc[i][j];
        if (b != nullptr) v += to_f32(b[gn]);
        y[o] = from_f32<T>(apply_act(v, act));
      }
    }
  }
}

template <typename T>
__global__ void splitk_epilogue(const float* __restrict__ ws, const T* __restrict__ b,
                                T* __restrict__ y, int M, int N, int splits, int act) {
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= plane) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += ws[z * plane + o];
  if (b != nullptr) v += to_f32(b[o % N]);
  y[o] = from_f32<T>(apply_act(v, act));
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y, float* ws, int M,
            int K, int N, long long sxm, long long sxk, long long swk, long long swn,
            int act, int k_chunk, int splits, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  pw_gemm<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), splits > 1 ? ws : nullptr, M, K, N, sxm, sxk, swk, swn,
      act, k_chunk);
  if (splits > 1) {
    const size_t plane = static_cast<size_t>(M) * N;
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((plane + threads - 1) / threads);
    splitk_epilogue<T><<<blocks, threads, 0, stream>>>(
        ws, static_cast<const T*>(b), static_cast<T*>(y), M, N, splits, act);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16. b may be null (no bias). ws: fp32 (splits, M, N),
// used only when splits > 1. Returns cudaGetLastError() after the launches.
extern "C" int ibn_pointwise_launch(int dtype, const void* x, const void* w,
                                    const void* b, void* y, void* ws, int M, int K,
                                    int N, long long sxm, long long sxk,
                                    long long swk, long long swn, int act,
                                    int k_chunk, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0) {
    launch<float>(x, w, b, y, wsf, M, K, N, sxm, sxk, swk, swn, act, k_chunk, splits, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, b, y, wsf, M, K, N, sxm, sxk, swk, swn, act, k_chunk,
                          splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
