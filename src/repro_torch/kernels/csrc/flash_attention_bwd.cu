// flash_attention_bwd: the gradient of flash_attention.cu's attention for
// Hopper (sm_90a): dq, dk and dv from q, k, v, the forward's output o, its
// row log-sum-exp lse (fp32, natural units of the scaled scores; the
// forward writes it when a gradient will be taken) and the output's
// cotangent do. fp32 or bf16 in and out, fp32 sums. GQA: query head h reads
// kv head h / G, and a kv head's gradient sums its G query heads.
//
// The TPU kernel (src/repro/kernels/flash_attention.py:88) has no VJP: the
// reference differentiates the plain attention, which ref.py's
// flash_attention_bwd writes out and these kernels compute, FlashAttention-2's
// backward:
//   s = q k^T * scale, masked as the forward masks it; P = exp(s - lse);
//   D = rowsum(do o);  dv = P^T do;  dP = do v^T;  dS = P (dP - D);
//   dq = dS k * scale;  dk = dS^T q * scale.
// In bf16, P is rounded to bf16 for dv and dS for dq and dk (the products'
// operands), as the forward rounds P for P v.
//
// Two launches, no atomics, so a gradient is bitwise the same from call to
// call:
//   attn_bwd_dq: a block per (64 q rows, head, batch) computes D for its rows
//     (into a workspace the next launch reads) and walks the kv tiles that
//     the causal mask leaves it: S, P, dP, dS per warp of 16 rows, dS through
//     shared memory into dq += dS k.
//   attn_bwd_dkdv: a block per (64 kv rows, kv head, batch) walks the q tiles
//     of its G query heads that see its keys: S^T = k q^T, P^T, dP^T = v do^T
//     and dS^T per warp of 16 kv rows, P^T and dS^T through shared memory
//     into dv += P^T do and dk += dS^T q.
// At hd 256 the accumulators of a warp's 16 rows would not fit its
// registers: the block doubles its warps, each pair of warps sharing 16 rows
// (both compute S and dP, each owns half of hd's columns). The looped tile
// holds 64 rows, or 32 or 16 where fp32 at wide heads would not fit 227 KB of
// shared memory. Products: warp_tiles.cuh (mma.sync m16n8k16 on bf16, FMAs
// on fp32). Operands are read through their (batch, head, row) strides, unit
// stride along hd, and loaded with plain loads (no TMA, no wgmma: a first
// version that is right).
//
// What bounds it on an H100: at qwen3-1.7B's training shape (B 8, H 16, KV 8,
// S 1024, hd 128, bf16, causal) the work is five products of 2 hd
// operations per unmasked (q, k) pair, 86 GFLOP under the causal mask (the
// kernels take seven: S and dP are computed in both launches), against
// about 0.06 GB moved: bound by operations, 0.087 ms at 989 TFLOP/s. This
// first version takes about 1 ms there (chip_smoke.py's train phase,
// PERF.md): the two launches run 4 warps a block on mma.sync, with their
// loads not overlapped with the products.
#include <cstdint>

#include "warp_tiles.cuh"

namespace {

using namespace tiles;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // bytes a block may take on an H100

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int BR = 64;  // rows a block owns: 4 warps of 16 (times SPLIT)

template <typename T, int HD>
struct Cfg {
  static constexpr int SPLIT = HD > 128 ? 2 : 1;  // warps sharing 16 rows
  static constexpr int THREADS = 128 * SPLIT;
  static constexpr int LD = HD + PAD<T>;          // row stride of a (rows, hd) tile
  static constexpr int COLS = HD / SPLIT;         // hd columns a warp accumulates
};

template <typename T, int HD>
__host__ __device__ constexpr size_t tile_bytes(int rows) {
  return sizeof(T) * rows * Cfg<T, HD>::LD;
}
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes(int bi) {
  return sizeof(T) * BR * (bi + PAD<T>);
}
// dq: q and do (BR rows), k and v (bi rows), a dS tile per split; lse and D
template <typename T, int HD>
__host__ __device__ constexpr size_t dq_smem(int bi) {
  return 2 * tile_bytes<T, HD>(BR) + 2 * tile_bytes<T, HD>(bi) +
         Cfg<T, HD>::SPLIT * scratch_bytes<T>(bi) + 2 * BR * sizeof(float);
}
// dkdv: k and v (BR rows), q and do (bi rows), P^T and dS^T tiles per split;
// lse and D of the q tile
template <typename T, int HD>
__host__ __device__ constexpr size_t dkdv_smem(int bi) {
  return 2 * tile_bytes<T, HD>(BR) + 2 * tile_bytes<T, HD>(bi) +
         2 * Cfg<T, HD>::SPLIT * scratch_bytes<T>(bi) + 2 * bi * sizeof(float);
}
// rows of the looped tile: 64, or 32 or 16 where 64 would not fit
template <typename T, int HD>
__host__ __device__ constexpr int bi_dq() {
  return dq_smem<T, HD>(64) <= MAX_SMEM ? 64 : dq_smem<T, HD>(32) <= MAX_SMEM ? 32 : 16;
}
template <typename T, int HD>
__host__ __device__ constexpr int bi_dkdv() {
  return dkdv_smem<T, HD>(64) <= MAX_SMEM ? 64 : dkdv_smem<T, HD>(32) <= MAX_SMEM ? 32 : 16;
}

struct Strides {  // element strides (batch, head, row) of each tensor
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::THREADS)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ o, const T* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ dsum, T* __restrict__ dq,
            int G, int H, int Sq, int Skv, Strides st, int causal, float scale) {
  using C = Cfg<T, HD>;
  constexpr int BI = bi_dq<T, HD>();
  constexpr int LD = C::LD;
  constexpr int LDS = BI + PAD<T>;
  constexpr int NT = C::THREADS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Os = Qs + BR * LD;  // do
  T* Ks = Os + BR * LD;
  T* Vs = Ks + BI * LD;
  T* Ss = Vs + BI * LD;  // dS, one BR x BI tile per split
  float* lse_s = reinterpret_cast<float*>(Ss + C::SPLIT * BR * LDS);
  float* d_s = lse_s + BR;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // the last q tiles carry the most work
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp & 3;   // the warp's 16 rows
  const int sp = warp >> 2;  // its half of hd's columns (hd 256)
  const long long row_lse = (static_cast<long long>(b) * H + h) * Sq;

  const int rows_in = min(BR, Sq - q0);
  load_tile<BR, HD, NT>(Qs, LD, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2], 1,
                        rows_in, HD);
  load_tile<BR, HD, NT>(Os, LD, dout + b * st.dout[0] + h * st.dout[1] + q0 * st.dout[2],
                        st.dout[2], 1, rows_in, HD);
  // D = rowsum(do o) for the block's rows: o's rows pass through the K and V
  // buffers, 2 BI rows at a time (the kv loop has not started)
  for (int r0 = 0; r0 < BR; r0 += 2 * BI) {
    __syncthreads();
    load_tile<2 * BI, HD, NT>(Ks, LD, o + b * st.o[0] + h * st.o[1] + (q0 + r0) * st.o[2],
                              st.o[2], 1, rows_in - r0, HD);
    __syncthreads();
    for (int r = warp; r < 2 * BI && r0 + r < BR; r += NT / 32) {
      float acc = 0.0f;
      for (int c = lane; c < HD; c += 32)
        acc += to_f32(Ks[r * LD + c]) * to_f32(Os[(r0 + r) * LD + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int row = r0 + r;
        d_s[row] = acc;
        lse_s[row] = row < rows_in ? lse[row_lse + q0 + row] * LOG2E : 0.0f;
        if (row < rows_in) dsum[row_lse + q0 + row] = acc;
      }
    }
  }

  float acc[C::COLS / 8][4];
  zero(acc);
  const float scale_log2 = scale * LOG2E;
  const int kv_end = causal ? min(Skv, min(q0 + BR, Sq)) : Skv;
  T* Sw = Ss + sp * BR * LDS + 16 * wr * LDS;  // this warp's rows of its dS tile
  for (int k0 = 0; k0 < kv_end; k0 += BI) {
    __syncthreads();  // the last tile's K, V and dS (or D's o rows) are read
    const int krows = min(BI, Skv - k0);
    load_tile<BI, HD, NT>(Ks, LD, k + b * st.k[0] + kh * st.k[1] + k0 * st.k[2], st.k[2], 1,
                          krows, HD);
    load_tile<BI, HD, NT>(Vs, LD, v + b * st.v[0] + kh * st.v[1] + k0 * st.v[2], st.v[2], 1,
                          krows, HD);
    __syncthreads();
    float s[BI / 8][4];
    float dp[BI / 8][4];
    zero(s);
    zero(dp);
    mma<T, BI / 8, HD, false, false>(s, Qs + 16 * wr * LD, LD, Ks, LD);
    mma<T, BI / 8, HD, false, false>(dp, Os + 16 * wr * LD, LD, Vs, LD);
#pragma unroll
    for (int t = 0; t < BI / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wr + frag_row(e);
        const int q_pos = q0 + r;
        const int k_pos = k0 + frag_col(t, e);
        const bool keep = q_pos < Sq && k_pos < Skv && !(causal && k_pos > q_pos);
        const float p = keep ? ex2(fmaf(s[t][e], scale_log2, -lse_s[r])) : 0.0f;
        Sw[frag_row(e) * LDS + frag_col(t, e)] = from_f32<T>(p * (dp[t][e] - d_s[r]));
      }
    __syncwarp();
    mma<T, C::COLS / 8, BI, false, true>(acc, Sw, LDS, Ks + sp * C::COLS, LD);
  }
#pragma unroll
  for (int t = 0; t < C::COLS / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + 16 * wr + frag_row(e);
      if (r < Sq)
        dq[b * st.dq[0] + h * st.dq[1] + r * st.dq[2] + sp * C::COLS + frag_col(t, e)] =
            from_f32<T>(acc[t][e] * scale);
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::THREADS)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int G,
              int H, int Sq, int Skv, Strides st, int causal, float scale) {
  using C = Cfg<T, HD>;
  constexpr int BI = bi_dkdv<T, HD>();
  constexpr int LD = C::LD;
  constexpr int LDS = BI + PAD<T>;
  constexpr int NT = C::THREADS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BR * LD;
  T* Qs = Vs + BR * LD;
  T* Os = Qs + BI * LD;  // do
  T* Ps = Os + BI * LD;  // P^T, then dS^T: two BR x BI tiles per split
  float* lse_s = reinterpret_cast<float*>(Ps + 2 * C::SPLIT * BR * LDS);
  float* d_s = lse_s + BI;

  const int k0 = blockIdx.x * BR;  // the first kv tiles carry the most work
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3;
  const int sp = warp >> 2;
  const int krows = min(BR, Skv - k0);
  load_tile<BR, HD, NT>(Ks, LD, k + b * st.k[0] + kh * st.k[1] + k0 * st.k[2], st.k[2], 1, krows,
                        HD);
  load_tile<BR, HD, NT>(Vs, LD, v + b * st.v[0] + kh * st.v[1] + k0 * st.v[2], st.v[2], 1, krows,
                        HD);

  float acc_k[C::COLS / 8][4];
  float acc_v[C::COLS / 8][4];
  zero(acc_k);
  zero(acc_v);
  const float scale_log2 = scale * LOG2E;
  T* Pw = Ps + sp * 2 * BR * LDS + 16 * wr * LDS;  // this warp's rows of P^T
  T* Dw = Pw + BR * LDS;                           // and of dS^T
  // a query row q sees key k0 only if k0 <= q (causal)
  const int q_start = causal ? (k0 / BI) * BI : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long row_lse = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = q_start; qt < Sq; qt += BI) {
      __syncthreads();  // the last tile's Q, dO, P^T and dS^T are read
      const int qrows = min(BI, Sq - qt);
      load_tile<BI, HD, NT>(Qs, LD, q + b * st.q[0] + h * st.q[1] + qt * st.q[2], st.q[2], 1,
                            qrows, HD);
      load_tile<BI, HD, NT>(Os, LD, dout + b * st.dout[0] + h * st.dout[1] + qt * st.dout[2],
                            st.dout[2], 1, qrows, HD);
      for (int r = threadIdx.x; r < BI; r += NT) {
        lse_s[r] = r < qrows ? lse[row_lse + qt + r] * LOG2E : 0.0f;
        d_s[r] = r < qrows ? dsum[row_lse + qt + r] : 0.0f;
      }
      __syncthreads();
      float s[BI / 8][4];
      zero(s);
      mma<T, BI / 8, HD, false, false>(s, Ks + 16 * wr * LD, LD, Qs, LD);
#pragma unroll
      for (int t = 0; t < BI / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + 16 * wr + frag_row(e);
          const int c = frag_col(t, e);
          const int q_pos = qt + c;
          const bool keep = q_pos < Sq && k_pos < Skv && !(causal && k_pos > q_pos);
          s[t][e] = keep ? ex2(fmaf(s[t][e], scale_log2, -lse_s[c])) : 0.0f;
          Pw[frag_row(e) * LDS + c] = from_f32<T>(s[t][e]);
        }
      float dp[BI / 8][4];
      zero(dp);
      mma<T, BI / 8, HD, false, false>(dp, Vs + 16 * wr * LD, LD, Os, LD);
#pragma unroll
      for (int t = 0; t < BI / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = frag_col(t, e);
          Dw[frag_row(e) * LDS + c] = from_f32<T>(s[t][e] * (dp[t][e] - d_s[c]));
        }
      __syncwarp();
      mma<T, C::COLS / 8, BI, false, true>(acc_v, Pw, LDS, Os + sp * C::COLS, LD);
      mma<T, C::COLS / 8, BI, false, true>(acc_k, Dw, LDS, Qs + sp * C::COLS, LD);
    }
  }
#pragma unroll
  for (int t = 0; t < C::COLS / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = k0 + 16 * wr + frag_row(e);
      const int c = sp * C::COLS + frag_col(t, e);
      if (r < Skv) {
        dk[b * st.dk[0] + kh * st.dk[1] + r * st.dk[2] + c] = from_f32<T>(acc_k[t][e] * scale);
        dv[b * st.dv[0] + kh * st.dv[1] + r * st.dv[2] + c] = from_f32<T>(acc_v[t][e]);
      }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv, int B, int H, int KV,
           int Sq, int Skv, const Strides& st, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  const int G = H / KV;
  constexpr size_t dq_bytes = dq_smem<T, HD>(bi_dq<T, HD>());
  constexpr size_t kv_bytes = dkdv_smem<T, HD>(bi_dkdv<T, HD>());
  static_assert(dq_bytes <= MAX_SMEM && kv_bytes <= MAX_SMEM, "tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq<T, HD><<<dim3((Sq + BR - 1) / BR, H, B), C::THREADS, dq_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dq), G,
      H, Sq, Skv, st, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv<T, HD><<<dim3((Skv + BR - 1) / BR, KV, B), C::THREADS, kv_bytes,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), G, H,
      Sq, Skv, st, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dsum, void* dq, void* dk, void* dv,
              int B, int H, int KV, int Sq, int Skv, const Strides& st, int causal, float scale,
              cudaStream_t s) {
#define CASE(HD)                                                                              \
  case HD:                                                                                    \
    return launch<T, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, st,     \
                         causal, scale, s);
  switch (hd) {
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(80)
    CASE(112)
    CASE(128)
    CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CASE
}

}  // namespace

// dtype: 0 fp32, 1 bf16. strides: 24 element strides, (batch, head, row) of
// q, k, v, o, do, dq, dk and dv in that order; lse and dsum (D, a workspace
// this call fills) are contiguous (B, H, Sq) fp32. Two launches on `stream`.
// Returns a CUDA error code (0 when both launches were accepted).
extern "C" int flash_attention_bwd_launch(int dtype, int hd, const void* q, const void* k,
                                          const void* v, const void* o, const void* dout,
                                          const float* lse, float* dsum, void* dq, void* dk,
                                          void* dv, int B, int H, int KV, int Sq, int Skv,
                                          const long long* strides, int causal, float scale,
                                          void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, st,
                            causal, scale, s);
  if (dtype == 1)
    return launch_hd<bf16>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, st,
                           causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
