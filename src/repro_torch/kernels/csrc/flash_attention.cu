// flash_attention: o = softmax(q k^T / sqrt(hd) + mask) v for Hopper (sm_90a),
// fp32 or bf16 in, online softmax with fp32 m, l and accumulator, output in
// q's type. GQA: query head h reads kv head h / G (H = KV * G).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:88
// (flash_attention, _attn_kernel). It computes what that kernel computes:
//   s = (q . k) * scale in fp32, scale = 1/sqrt(hd);
//   mask: k_pos < skv always, and k_pos <= q_pos when causal, with q_pos and
//         k_pos counted from 0 in their own sequences (aligned top-left, as
//         the model's attention is) and masked scores set to -1e30;
//   m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m');
//   l' = l * corr + rowsum p (p in fp32);
//   acc' = acc * corr + round_to_v_type(p) . v;
//   o = acc / max(l, 1e-30), rounded to q's type.
//
// Layout: q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o like q, each read
// through its own (batch, head, row) element strides with unit stride along
// hd, so the model's (B, S, H, hd) tensors are passed as transposed views
// and nothing is copied. hd is one of 16, 32, 64, 128 (a template argument).
//
// What differs from the TPU kernel: that one walks a sequential grid and
// keeps (m, l, acc) in VMEM scratch across the kv axis. Here one block of
// 256 threads owns one (batch, head, 64-row q tile) and loops over kv tiles
// of 32 rows itself; q, the kv tile (k transposed) and p sit in shared
// memory as fp32, m and l and the accumulator in registers (each thread
// holds 4 rows by hd/16 columns of acc, and 4 by 2 of the score tile). Under
// the causal mask the loop stops at the block's last q row, so kv tiles wholly
// above the diagonal are never read, and the blocks with the most work are
// scheduled first.
//
// What bounds it on an H100: at the served model's prefill (B 8, H 16, KV 8,
// S 1024, hd 128, bf16, causal) the work is 4 * hd operations per unmasked
// (q, k) pair, about 34 GFLOP, against about 0.1 GB of q, k, v and o: bound by
// operations, 35 us at the bf16 tensor-core peak. This first version does its
// products as fp32 FMAs from shared memory, off the tensor cores, so it is
// bound by shared-memory loads and FMA issue, far above that bound. wgmma,
// TMA and packing a kv head's G query heads into one block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int RI = BQ / 16;   // rows per thread
constexpr int CJ = BK / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;

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

template <int HD>
constexpr size_t smem_bytes() {
  // Qs: BQ x (HD + 1), Kt: HD x (BK + 1), Vs: BK x HD, Ps: BQ x (BK + 1);
  // the +1 columns keep the transposing stores and the row reads off one bank
  return sizeof(float) *
         (BQ * (HD + 1) + HD * (BK + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ o, int G, int Sq, int Skv, long long qsb, long long qsh,
         long long qss, long long ksb, long long ksh, long long kss, long long vsb,
         long long vsh, long long vss, long long osb, long long osh, long long oss,
         int causal, float scale) {
  constexpr int CD = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * (HD + 1);
  float* Vs = Kt + HD * (BK + 1);
  float* Ps = Vs + BK * HD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last q tiles carry the most work
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + (h / G) * ksh;
  const T* vp = v + b * vsb + (h / G) * vsh;
  T* op = o + b * osb + h * osh;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int gq = q0 + r;
    Qs[r * (HD + 1) + d] = gq < Sq ? to_f32(qp[gq * qss + d]) : 0.0f;
  }

  float m[RI];
  float l[RI];
  float acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.0f;
  }

  // causal: no row of this block sees a key past its last row
  const int kv_end = causal ? min(Skv, min(q0 + BQ, Sq)) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Qs is loaded; the last tile's Kt, Vs and Ps are read
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int gk = k0 + r;
      const bool in = gk < Skv;
      Kt[d * (BK + 1) + r] = in ? to_f32(kp[gk * kss + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vp[gk * vss + d]) : 0.0f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RI];
      float kk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kk[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool keep = k_pos < Skv && (!causal || k_pos <= q_pos);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: reduce across tx
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[CD];
#pragma unroll
      for (int jj = 0; jj < CD; ++jj) vv[jj] = Vs[c * HD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
        for (int jj = 0; jj < CD; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < CD; ++jj)
      op[gq * oss + tx + 16 * jj] = from_f32<T>(acc[i][jj] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           int Sq, int Skv, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attn_fwd<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), G, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
              int H, int G, int Sq, int Skv, const long long* st, int causal,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, G, Sq, Skv, st, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, G, Sq, Skv, st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, Sq, Skv, st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, Sq, Skv, st, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16. strides: 12 element strides, (batch, head, row) of
// q, k, v and o in that order. Returns a CUDA error code (0 when the launch
// was accepted).
extern "C" int flash_attention_launch(int dtype, int hd, const void* q, const void* k,
                                      const void* v, void* o, int B, int H, int KV,
                                      int Sq, int Skv, const long long* strides,
                                      int causal, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, H, G, Sq, Skv, strides, causal, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, G, Sq, Skv, strides, causal,
                                    scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
