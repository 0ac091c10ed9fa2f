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
// call: dq first (it also writes D = rowsum(do o), which the second reads),
// then dk with dv. S and dP are computed in both, seven products where
// FlashAttention-2 with atomics takes five: the price of determinism.
//
// Two bodies, chosen by the type:
//   bf16: FlashAttention-3's layout on wgmma, the forward's (flash_attention.cu)
//     in both launches. Persistent blocks of 384 threads, one per SM:
//     warpgroup 0 loads (setmaxnreg gives its registers to the others), one
//     thread of it issuing TMA copies; warpgroups 1 and 2 compute 64 rows
//     each. A tile is 64 rows of hd in 64-column panels in the 128-byte
//     swizzle (64- and 32-byte at hd 32 and 16), which TMA zero-fills past
//     Sq, Skv and hd. An item's own rows sit in shared memory for the item
//     (a full/empty mbarrier pair), the tiles it walks come through a ring of
//     up to 4 stages (a full/empty pair each), so the next item's loads run
//     under this one's last products and its epilogue.
//     attn_bwd_dq_wgmma: an item is 128 q rows of one (head, batch), the last
//       q tiles (the most work) first. Each warp first sums D for its 16 rows
//       from o and do in device memory and writes them with the rows' lse
//       (times log2 e) to the workspace, then walks the kv tiles the causal
//       mask leaves it: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both
//       operands K-major in shared memory, as the forward's S), P = exp2(S
//       scale log2 e - lse) and dS = P (dP - D) in registers, rounded to bf16
//       and packed straight into A fragments, dq += dS K with A from
//       registers and K as B, MN-major (the forward's P V form, one wgmma per
//       64-column panel, n16 or n48 for the last at hd 80 and 112).
//     attn_bwd_dkdv_wgmma: an item is 128 kv rows of one (kv head, batch), the
//       first kv tiles first; its K and V stay, and the ring brings, head by
//       head of its G query heads, the q tiles at or below the diagonal, each
//       with its rows' lse and D from the workspace (TMA boxes of 64 fp32,
//       which is why the workspace is padded to 128 rows). S^T = K Q^T and
//       dP^T = V dO^T as above; P^T and dS^T = P^T (dP^T - D) stay in
//       registers; dv += P^T dO and dk += dS^T Q take them as A fragments and
//       dO and Q as B, MN-major. A warpgroup whose rows start past a q
//       tile's last row hands it back unread.
//     hd 256: a warpgroup's dk and dv (2 x 64 x 256 fp32) would not fit its
//     registers, nor would dq beside S and dP comfortably, so both consumer
//     warpgroups take the same 64 rows (an item is 64 rows there), each
//     accumulating half of hd's columns and each computing the whole S and
//     dP: twice the S and dP work at hd 256 (ptxas: 168 registers at launch,
//     240 per consumer thread after setmaxnreg; only the hd-128 dk/dv launch
//     spills, 4 bytes).
//     Every mbarrier wait traps after about 2 s (mbar_wait), which ends the
//     process's CUDA context instead of hanging the card. The products are
//     issued and waited for in turn within a warpgroup (no software pipeline:
//     the two warpgroups' products interleave on the tensor cores);
//   fp32: FMAs on warp_tiles.cuh's fragments, plain loads, 4 warps a block of
//     64 rows (8 at hd 256, each pair sharing 16 rows: the register split of
//     the bf16 body), S, P, dP, dS per warp of 16 rows through shared memory,
//     the looped tile 64 rows, or 32 or 16 where fp32 at wide heads would not
//     fit 227 KB of shared memory. No TF32: fp32 stays fp32. The parallel
//     phase's fp32 backward runs on it.
// Operands are read through their (batch, head, row) strides, unit stride
// along hd; bf16 takes 16-byte-aligned starts and strides that are
// multiples of 8 elements (TMA's rule; the wrapper copies anything else).
//
// What bounds it on an H100: at qwen3-1.7B's training shape (B 8, H 16, KV 8,
// S 1024, hd 128, bf16, causal) the work is five products of 2 hd
// operations per unmasked (q, k) pair, 86 GFLOP under the causal mask (the
// kernels take seven: S and dP are computed in both launches), against
// about 0.06 GB moved: bound by operations, 0.087 ms at 989 TFLOP/s. The
// first version (mma.sync, plain loads, dS through shared memory) took
// 1.02 ms there; this one about 0.37 ms (scripts/backward_kernels.py,
// PERF.md), 120 GFLOP of products at about 320 TFLOP/s: within each
// warpgroup a tile's products wait for each other (S and dP, then the
// exponentials, then dq or dk and dv), and the causal diagonal leaves the
// two warpgroups unequal work.
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

// ---- bf16 on wgmma, with TMA and warp specialisation
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int NC = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (NC + 1);  // warpgroup 0 loads, the others compute
constexpr int BT = 64;                   // rows of a streamed tile (q in dk/dv, kv in dq)
constexpr int VEC = BT * 4;              // bytes of a q tile's lse or D (fp32)
constexpr int MAX_STAGES = 4;
constexpr int EXTRA = 1024 + 256;        // alignment to 1024 bytes, barriers
// registers per thread after setmaxnreg (168 at launch): the loader gives up
// what the consumers take (128 x 24 + 256 x 240 <= 65536)
constexpr int LOADER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int HD>
struct Geo {
  static constexpr int PW = HD < 64 ? HD : 64;          // panel width (elements) = swizzle span
  static constexpr int PANELS = (HD + PW - 1) / PW;
  static constexpr int LASTW = HD - (PANELS - 1) * PW;  // width of the last panel's product
  static constexpr int RB = PW * 2;                     // bytes per panel row
  static constexpr int PANEL = 64 * RB;                 // bytes of a 64-row panel
  static constexpr int TILE = PANELS * PANEL;           // bytes of a 64-row tile
  static constexpr int LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  // hd 256: a warpgroup's dk and dv (2 x 64 x 256 fp32) would not fit its
  // registers, so both consumer warpgroups take the same 64 rows, each
  // accumulating half of hd's columns (and each computing S and dP)
  static constexpr int SPLIT = HD > 128 ? 2 : 1;
  static constexpr int ROWS = 64 * NC / SPLIT;            // rows an item owns
  static constexpr int RES = 2 * (ROWS / 64) * TILE;      // its two resident operands
  static constexpr int COLS = HD / SPLIT;                 // columns a warpgroup accumulates
  static constexpr int WPANELS = PANELS / SPLIT;
  // stages of the streamed pair of tiles (and, in dk/dv, their lse and D)
  __host__ __device__ static constexpr int stages(int vec) {
    return (232448 - EXTRA - RES) / (2 * TILE + vec) < MAX_STAGES
               ? (232448 - EXTRA - RES) / (2 * TILE + vec)
               : MAX_STAGES;
  }
  __host__ __device__ static constexpr int smem(int vec) {
    return RES + stages(vec) * (2 * TILE + vec) + EXTRA;
  }
};

// one TMA box (PW columns x 64 rows) of a 4-d map: the map's axes are (hd,
// row, head, batch), or (hd, head, row, batch) when not rows_first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int head, int batch, int rows_first, uint32_t bar) {
  tma_load_4d(dst, map, col, rows_first ? row : head, rows_first ? head : row, batch, bar);
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (W == 64) wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(d), a, b);
  if constexpr (W == 48) wgmma_rs_n48(*reinterpret_cast<float(*)[24]>(d), a, b);
  if constexpr (W == 32) wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(d), a, b);
  if constexpr (W == 16) wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(d), a, b);
}

// D = A B^T over hd (m64n64, both K-major 64-row tiles in shared memory),
// issued, not committed
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t b) {
  using Gm = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk * 16 / Gm::PW) * Gm::PANEL + (kk * 16 % Gm::PW) * 2;
    wgmma_ss_n64(d, make_desc(a + off, 16, 8 * Gm::RB, Gm::LAYOUT),
                 make_desc(b + off, 16, 8 * Gm::RB, Gm::LAYOUT), kk > 0);
  }
}

// acc += A B for the 64 x 64 A in registers (4 k16 fragments) and the
// 64-row tile b (MN-major: rows are the contraction), over this warpgroup's
// panels of hd from p0; issued, not committed
template <int HD>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t (&a)[BT / 16][4], uint32_t b,
                                         int p0) {
  using Gm = Geo<HD>;
#pragma unroll
  for (int kt = 0; kt < BT / 16; ++kt) {
    const uint32_t row = b + kt * 16 * Gm::RB;
#pragma unroll
    for (int p = 0; p < Gm::WPANELS; ++p) {
      const uint64_t desc =
          make_desc(row + (p0 + p) * Gm::PANEL, Gm::PANEL, 8 * Gm::RB, Gm::LAYOUT);
      if (Gm::SPLIT == 1 && p == Gm::PANELS - 1)
        wgmma_rs<Gm::LASTW>(&acc[p * Gm::PW / 2], a[kt], desc);
      else
        wgmma_rs<Gm::PW>(&acc[p * Gm::PW / 2], a[kt], desc);
    }
  }
}

// rounds a 64 x 64 fp32 accumulator to bf16 A fragments of the next
// product (k step t covers its n8 tiles 2 t and 2 t + 1)
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[BT / 16][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n >> 1][(n & 1) * 2] = pack_bf16(x[4 * n], x[4 * n + 1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
  }
}

struct Out {  // element strides (batch, head, row) of an output
  long long b, h, s;
};

// stores a warpgroup's rows of an fp32 accumulator (mma.sync's C layout per
// warp) times `mul` as bf16, 4 bytes a lane, rows past `rows` dropped
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, const Out& st, const float (&acc)[N],
                                           int wrow, int rows, int col0, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wrow + lane / 4 + 8 * half;
      if (r < rows)
        *reinterpret_cast<uint32_t*>(out + r * st.s + col0 + 8 * n + 2 * (lane & 3)) =
            pack_bf16(acc[4 * n + 2 * half] * mul, acc[4 * n + 2 * half + 1] * mul);
    }
}

// dq, and each row's lse (times log2 e) and D = rowsum(do o) into the
// workspace the dk/dv launch reads (zeros past Sq up to the item's end)
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ ws_lse,
                  float* __restrict__ ws_d, bf16* __restrict__ dq, int G, int H, int B, int Sq,
                  int Skv, int Sqp, Out os, Out dos, Out dqs, int causal, int rows_first,
                  float scale_log2, float scale) {
  using Gm = Geo<HD>;
  constexpr int ST = Gm::stages(0);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base;                      // ROWS / 64 tiles
  const uint32_t dOs = Qs + Gm::RES / 2;         // ROWS / 64 tiles
  const uint32_t ring = Qs + Gm::RES;            // ST stages of (K tile, V tile)
  const uint32_t bars = ring + ST * 2 * Gm::TILE;
  auto k_at = [&](int s) { return ring + s * 2 * Gm::TILE; };
  auto v_at = [&](int s) { return ring + s * 2 * Gm::TILE + Gm::TILE; };
  const uint32_t full_r = bars;
  const uint32_t empty_r = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + ST + s); };

  // items: ROWS q rows of one (head, batch), the last q tiles (the most
  // work under the causal mask) first across the grid; round-robin over the
  // blocks, reversed every other round
  const int nq = (Sq + Gm::ROWS - 1) / Gm::ROWS;
  const int items = nq * H * B;
  auto item_of = [&](int k) {
    const int c = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return k * static_cast<int>(gridDim.x) + c;
  };
  auto decode = [&](int i, int& q0, int& h, int& b, int& tiles) {
    const int r = i % (H * B);
    h = r % H;
    b = r / H;
    q0 = (nq - 1 - i / (H * B)) * Gm::ROWS;
    const int kv_end = causal ? min(Skv, min(q0 + Gm::ROWS, Sq)) : Skv;
    tiles = (kv_end + BT - 1) / BT;
  };
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_r, 1);
    mbar_init(empty_r, 4 * NC);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread loads each item's Q and dO, and keeps the
    // ring of K and V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int k = 0; item_of(k) < items; ++k) {
        int q0, h, b, tiles;
        decode(item_of(k), q0, h, b, tiles);
        mbar_wait(empty_r, (k & 1) ^ 1);
        mbar_expect(full_r, Gm::RES);
        for (int t = 0; t < Gm::ROWS / 64; ++t)
          for (int p = 0; p < Gm::PANELS; ++p) {
            const int off = t * Gm::TILE + p * Gm::PANEL;
            tma_load(Qs + off, &tq, p * Gm::PW, q0 + 64 * t, h, b, rows_first & 1, full_r);
            tma_load(dOs + off, &tdo, p * Gm::PW, q0 + 64 * t, h, b, rows_first & 8, full_r);
          }
        for (int j = 0; j < tiles; ++j, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          mbar_expect(full(s), 2 * Gm::TILE);
          for (int p = 0; p < Gm::PANELS; ++p) {
            tma_load(k_at(s) + p * Gm::PANEL, &tk, p * Gm::PW, j * BT, h / G, b, rows_first & 2,
                     full(s));
            tma_load(v_at(s) + p * Gm::PANEL, &tv, p * Gm::PW, j * BT, h / G, b, rows_first & 4,
                     full(s));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns an item's q rows 64 w .. 64 w + 63 (at
  // hd 256 both own the item's 64 rows, each half of hd's columns)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wgi - 1;
  const int t128 = threadIdx.x - 128 * wgi;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wt = Gm::SPLIT > 1 ? 0 : w;  // the warpgroup's 64-row tile of the item
  const int p0 = Gm::SPLIT > 1 ? w * Gm::WPANELS : 0;
  const uint32_t Qw = Qs + wt * Gm::TILE;
  const uint32_t dOw = dOs + wt * Gm::TILE;
  float acc[Gm::COLS / 2];

  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int it = 0;
  for (int k = 0; item_of(k) < items; ++k) {
    int q0, h, b, tiles;
    decode(item_of(k), q0, h, b, tiles);
    const int r0 = q0 + 64 * wt;
    const int wrow = r0 + 16 * warp;
    const long long bh = static_cast<long long>(b) * H + h;
    // D = rowsum(do o) and lse for rows wrow + grp and wrow + grp + 8, each
    // quad summing its rows' columns 8 n + 2 tig, + 1 in fp32
    float lse2[2], dsum[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wrow + grp + 8 * half;
      float d = 0.0f;
      if (r < Sq) {
        const bf16* orow = o + b * os.b + h * os.h + r * os.s;
        const bf16* drow = dout + b * dos.b + h * dos.h + r * dos.s;
#pragma unroll 4
        for (int n = 0; n < HD / 8; ++n) {
          const int col = 8 * n + 2 * tig;
          const __nv_bfloat162 ov = *reinterpret_cast<const __nv_bfloat162*>(orow + col);
          const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(drow + col);
          d = fmaf(__low2float(ov), __low2float(dv), d);
          d = fmaf(__high2float(ov), __high2float(dv), d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dsum[half] = d;
      lse2[half] = r < Sq ? lse[bh * Sq + r] * LOG2E : 0.0f;
      if (tig == 0 && (Gm::SPLIT == 1 || w == 0) && r < Sqp) {
        ws_lse[bh * Sqp + r] = lse2[half];
        ws_d[bh * Sqp + r] = d;
      }
    }
    const int kv_end_w = r0 >= Sq ? 0 : causal ? min(Skv, min(r0 + 64, Sq)) : Skv;
    const int tiles_w = (kv_end_w + BT - 1) / BT;
#pragma unroll
    for (int i = 0; i < Gm::COLS / 2; ++i) acc[i] = 0.0f;

    mbar_wait(full_r, k & 1);
    for (int j = 0; j < tiles; ++j, ++it) {
      const int s = it % ST;
      mbar_wait(full(s), (it / ST) & 1);
      if (j >= tiles_w) {  // past this warpgroup's last row (causal): handed back unread
        release(empty(s));
        continue;
      }
      float sc[32], dp[32];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      issue_ss<HD>(sc, Qw, k_at(s));   // S = Q K^T
      issue_ss<HD>(dp, dOw, v_at(s));  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const int k0 = j * BT;
      const bool edge = k0 + BT > Skv || (causal && k0 + BT - 1 > wrow);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int half = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[half]));
        if (edge) {
          const int k_pos = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
          const int q_pos = wrow + grp + 8 * half;
          if (k_pos >= Skv || (causal && k_pos > q_pos)) p = 0.0f;
        }
        dp[i] = p * (dp[i] - dsum[half]);  // dS
      }
      uint32_t da[BT / 16][4];
      pack_a(dp, da);
      fence_regs(acc);
      wgmma_fence();
      issue_rs<HD>(acc, da, k_at(s), p0);  // dq += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release(empty(s));
    }
    release(empty_r);
    store_rows(dq + b * dqs.b + h * dqs.h, dqs, acc, wrow, Sq, p0 * Gm::PW, scale);
  }
}

// dk and dv of ROWS kv rows of one (kv head, batch), over the q tiles of its
// G query heads that see them
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap td,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int G, int KV, int B, int Sq,
                    int Skv, Out dks, Out dvs, int causal, int rows_first, float scale_log2,
                    float scale) {
  using Gm = Geo<HD>;
  constexpr int ST = Gm::stages(2 * VEC);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Ks = base;                  // ROWS / 64 tiles
  const uint32_t Vs = Ks + Gm::RES / 2;      // ROWS / 64 tiles
  const uint32_t ring = Ks + Gm::RES;        // ST stages of (Q tile, dO tile)
  const uint32_t vecs = ring + ST * 2 * Gm::TILE;  // ST stages of (lse, D)
  const uint32_t bars = vecs + ST * 2 * VEC;
  auto q_at = [&](int s) { return ring + s * 2 * Gm::TILE; };
  auto do_at = [&](int s) { return ring + s * 2 * Gm::TILE + Gm::TILE; };
  auto lse_at = [&](int s) { return vecs + s * 2 * VEC; };
  auto d_at = [&](int s) { return vecs + s * 2 * VEC + VEC; };
  const uint32_t full_r = bars;
  const uint32_t empty_r = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + ST + s); };

  // items: ROWS kv rows of one (kv head, batch), the first kv tiles (the
  // most work under the causal mask) first across the grid
  const int nk = (Skv + Gm::ROWS - 1) / Gm::ROWS;
  const int nq = (Sq + BT - 1) / BT;
  const int items = nk * KV * B;
  auto item_of = [&](int k) {
    const int c = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return k * static_cast<int>(gridDim.x) + c;
  };
  // a query row q sees key k0 only if k0 <= q (causal): the item's q tiles
  // start at its first row's
  auto decode = [&](int i, int& k0, int& kh, int& b, int& j0) {
    const int r = i % (KV * B);
    kh = r % KV;
    b = r / KV;
    k0 = (i / (KV * B)) * Gm::ROWS;
    j0 = causal ? min(k0 / BT, nq) : 0;
  };
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_r, 1);
    mbar_init(empty_r, 4 * NC);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: each item's K and V, then the ring of Q and dO tiles
    // with their rows' lse and D, head by head
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int k = 0; item_of(k) < items; ++k) {
        int k0, kh, b, j0;
        decode(item_of(k), k0, kh, b, j0);
        mbar_wait(empty_r, (k & 1) ^ 1);
        mbar_expect(full_r, Gm::RES);
        for (int t = 0; t < Gm::ROWS / 64; ++t)
          for (int p = 0; p < Gm::PANELS; ++p) {
            const int off = t * Gm::TILE + p * Gm::PANEL;
            tma_load(Ks + off, &tk, p * Gm::PW, k0 + 64 * t, kh, b, rows_first & 2, full_r);
            tma_load(Vs + off, &tv, p * Gm::PW, k0 + 64 * t, kh, b, rows_first & 4, full_r);
          }
        for (int g = 0; g < G; ++g) {
          const int h = kh * G + g;
          for (int j = j0; j < nq; ++j, ++it) {
            const int s = it % ST;
            mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
            mbar_expect(full(s), 2 * Gm::TILE + 2 * VEC);
            for (int p = 0; p < Gm::PANELS; ++p) {
              tma_load(q_at(s) + p * Gm::PANEL, &tq, p * Gm::PW, j * BT, h, b, rows_first & 1,
                       full(s));
              tma_load(do_at(s) + p * Gm::PANEL, &tdo, p * Gm::PW, j * BT, h, b, rows_first & 8,
                       full(s));
            }
            tma_load_3d(lse_at(s), &tlse, j * BT, h, b, full(s));
            tma_load_3d(d_at(s), &td, j * BT, h, b, full(s));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns an item's kv rows 64 w .. 64 w + 63 (at
  // hd 256 both own its 64 rows, each half of hd's columns)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wgi - 1;
  const int t128 = threadIdx.x - 128 * wgi;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wt = Gm::SPLIT > 1 ? 0 : w;
  const int p0 = Gm::SPLIT > 1 ? w * Gm::WPANELS : 0;
  const uint32_t Kw = Ks + wt * Gm::TILE;
  const uint32_t Vw = Vs + wt * Gm::TILE;
  const float* vec_ptr = reinterpret_cast<const float*>(smem_raw + (vecs - raw));
  float adk[Gm::COLS / 2], adv[Gm::COLS / 2];

  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int it = 0;
  for (int k = 0; item_of(k) < items; ++k) {
    int k0, kh, b, j0;
    decode(item_of(k), k0, kh, b, j0);
    const int r0 = k0 + 64 * wt;  // this warpgroup's first kv row
    const int row = r0 + 16 * warp + grp;  // and this lane's (and row + 8)
    const int jw = causal ? r0 / BT : 0;   // its first q tile
#pragma unroll
    for (int i = 0; i < Gm::COLS / 2; ++i) adk[i] = adv[i] = 0.0f;

    mbar_wait(full_r, k & 1);
    for (int g = 0; g < G; ++g) {
      for (int j = j0; j < nq; ++j, ++it) {
        const int s = it % ST;
        mbar_wait(full(s), (it / ST) & 1);
        if (j < jw) {  // wholly above this warpgroup's rows (causal): handed back unread
          release(empty(s));
          continue;
        }
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        issue_ss<HD>(st, Kw, q_at(s));    // S^T = K Q^T
        issue_ss<HD>(dpt, Vw, do_at(s));  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        const int q0 = j * BT;
        const bool edge = q0 + BT > Sq || (causal && q0 < r0 + 63);
        const float* lsev = vec_ptr + s * 2 * (VEC / 4);
        const float* dv_ = lsev + VEC / 4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 8 * n + 2 * tig;
          const float2 l2 = *reinterpret_cast<const float2*>(lsev + c);
          const float2 dd = *reinterpret_cast<const float2*>(dv_ + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            float p = ex2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int q_pos = q0 + c + (e & 1);
              if (q_pos >= Sq || (causal && row + 8 * (e >> 1) > q_pos)) p = 0.0f;
            }
            st[i] = p;                                         // P^T
            dpt[i] = p * (dpt[i] - ((e & 1) ? dd.y : dd.x));  // dS^T
          }
        }
        uint32_t pa[BT / 16][4], da[BT / 16][4];
        pack_a(st, pa);
        pack_a(dpt, da);
        fence_regs(adv);
        fence_regs(adk);
        wgmma_fence();
        issue_rs<HD>(adv, pa, do_at(s), p0);  // dv += P^T dO
        issue_rs<HD>(adk, da, q_at(s), p0);   // dk += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(adv);
        fence_regs(adk);
        fence_regs(pa);
        fence_regs(da);
        release(empty(s));
      }
    }
    release(empty_r);
    const int wrow = r0 + 16 * warp;
    store_rows(dk + b * dks.b + kh * dks.h, dks, adk, wrow, Skv, p0 * Gm::PW, scale);
    store_rows(dv + b * dvs.b + kh * dvs.h, dvs, adv, wrow, Skv, p0 * Gm::PW, 1.0f);
  }
}

// a (batch, head, row, hd) bf16 view as a 4-d TMA map of PW x 64 boxes; the
// head and row axes go in order of their strides, and the box is 1 head deep
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads, int batch,
              long long sb, long long sh, long long sr) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  using Gm = Geo<HD>;
  const bool rows_first = sr <= sh;
  cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(rows_first ? rows : heads),
                        static_cast<cuuint64_t>(rows_first ? heads : rows),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (rows_first ? sr : sh)),
                           static_cast<cuuint64_t>(2 * (rows_first ? sh : sr)),
                           static_cast<cuuint64_t>(2 * sb)};
  cuuint32_t box[4] = {Gm::PW, rows_first ? 64u : 1u, rows_first ? 1u : 64u, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Gm::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Gm::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous (B, H, Sqp) fp32 workspace as a 3-d TMA map of 64-row boxes
bool make_vec_map(CUtensorMap* map, const float* ptr, int Sqp, int H, int B) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(Sqp), static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(4LL * Sqp),
                           static_cast<cuuint64_t>(4LL * Sqp * H)};
  cuuint32_t box[3] = {BT, 1, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* ws, void* dq, void* dk, void* dv, int B, int H, int KV,
           int Sq, int Skv, const Strides& st, int causal, float scale, cudaStream_t stream) {
  using Gm = Geo<HD>;
  // TMA: q, k, v and do start on 16 bytes with (batch, head, row) strides
  // that are multiples of 8 elements; o and the outputs take 4-byte stores
  const uintptr_t starts = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                           reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dq) |
                           reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (starts % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long* all[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i)
      if (all[t][i] % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int Sqp = (Sq + 127) / 128 * 128;
  float* ws_lse = ws;
  float* ws_d = ws + static_cast<long long>(B) * H * Sqp;
  CUtensorMap tq, tk, tv, tdo, tlse, td;
  if (!make_map<HD>(&tq, q, Sq, H, B, st.q[0], st.q[1], st.q[2]) ||
      !make_map<HD>(&tk, k, Skv, KV, B, st.k[0], st.k[1], st.k[2]) ||
      !make_map<HD>(&tv, v, Skv, KV, B, st.v[0], st.v[1], st.v[2]) ||
      !make_map<HD>(&tdo, dout, Sq, H, B, st.dout[0], st.dout[1], st.dout[2]) ||
      !make_vec_map(&tlse, ws_lse, Sqp, H, B) || !make_vec_map(&td, ws_d, Sqp, H, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_first = (st.q[2] <= st.q[1]) | ((st.k[2] <= st.k[1]) << 1) |
                         ((st.v[2] <= st.v[1]) << 2) | ((st.dout[2] <= st.dout[1]) << 3);
  constexpr int dq_bytes = Gm::smem(0);
  constexpr int kv_bytes = Gm::smem(2 * VEC);
  static_assert(Gm::stages(2 * VEC) >= 2 && kv_bytes <= 232448 && dq_bytes <= 232448,
                "tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long dq_items = static_cast<long long>((Sq + Gm::ROWS - 1) / Gm::ROWS) * H * B;
  const long long kv_items = static_cast<long long>((Skv + Gm::ROWS - 1) / Gm::ROWS) * KV * B;
  const float scale_log2 = scale * LOG2E;
  const Out os{st.o[0], st.o[1], st.o[2]}, dos{st.dout[0], st.dout[1], st.dout[2]},
      dqs{st.dq[0], st.dq[1], st.dq[2]}, dks{st.dk[0], st.dk[1], st.dk[2]},
      dvs{st.dv[0], st.dv[1], st.dv[2]};
  attn_bwd_dq_wgmma<HD><<<static_cast<int>(dq_items < sms ? dq_items : sms), THREADS, dq_bytes,
                          stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, ws_lse,
      ws_d, static_cast<bf16*>(dq), G, H, B, Sq, Skv, Sqp, os, dos, dqs, causal, rows_first,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_wgmma<HD><<<static_cast<int>(kv_items < sms ? kv_items : sms), THREADS, kv_bytes,
                            stream>>>(tq, tk, tv, tdo, tlse, td, static_cast<bf16*>(dk),
                                      static_cast<bf16*>(dv), G, KV, B, Sq, Skv, dks, dvs, causal,
                                      rows_first, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dsum, void* dq, void* dk, void* dv,
              int B, int H, int KV, int Sq, int Skv, const Strides& st, int causal, float scale,
              cudaStream_t s) {
#define CASE(HD)                                                                              \
  case HD:                                                                                    \
    if constexpr (sizeof(T) == 2)                                                             \
      return wg::launch<HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, st,  \
                            causal, scale, s);                                                \
    else                                                                                      \
      return launch<T, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, Sq, Skv, st,   \
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
// q, k, v, o, do, dq, dk and dv in that order; lse is contiguous (B, H, Sq)
// fp32, and dsum a workspace this call fills: D as contiguous (B, H, Sq)
// fp32 in fp32; in bf16 (2, B, H, Sqp) fp32 with Sqp = Sq rounded up to 128
// (each row's lse times log2 e, then D, zeros past Sq). bf16 takes q, k, v,
// o, do, dq, dk and dv on 16-byte boundaries with strides that are
// multiples of 8 elements. Two launches on `stream`. Returns a CUDA error
// code (0 when both launches were accepted).
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
