// ssd_scan: the Mamba2 SSD chunk scan for Hopper (sm_90a). x (B, S, H, P),
// dt (B, S, H) fp32, A (H,) fp32, B and C (B, S, G, N), fp32 or bf16 in;
// y (B, S, H, P) in x's type and the final state (B, H, P, N) in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:88 (ssd_scan,
// _ssd_kernel), and computes what the model's chunked path computes
// (repro/models/ssm.py::ssd_chunked). For each (batch, head) and each chunk of
// Q positions, in order, with the (P, N) fp32 state carried across chunks:
//   dA = dt * A;  cs = inclusive cumsum of dA over the chunk;
//   y  = ((C B^T) o L) (x dt) + (C state^T) * exp(cs),
//        L[i, j] = exp(cs[i] - cs[j]) for j <= i, else 0;
//   state' = state * exp(cs[Q-1]) + (x dt)^T (B * exp(cs[Q-1] - cs)).
// Positions past S inside the last chunk load as zeros (dt = 0), so they
// neither decay nor add to the state: the final state equals the padded
// computation's. Head h reads group h / (H / G) of B and C; nothing is
// broadcast in memory.
//
// What differs from the TPU kernel: that one walks a (batch, head, chunk)
// grid whose chunk axis is sequential and keeps the state in VMEM scratch.
// Here one block of 256 threads owns one (batch, head), keeps the state in
// shared memory and walks the chunks itself. A chunk's rows are taken in
// tiles of 64 so that the shared memory stays near 135 KB at P 64, N 128 and
// Q 256 (one chunk of B and C in fp32 alone would be 256 KB): for each row
// tile, the inter-chunk term, then the intra-chunk term over the column tiles
// at or below the diagonal (tiles above it are all masked and are skipped).
// The mask is applied before the exp: above the diagonal cs[i] - cs[j] >= 0
// and its exp can overflow, and inf * 0 is NaN. The cumsum is an exact
// scan (a serial run per lane, then a warp scan of the lanes' totals), not
// the TPU kernel's product with a triangular matrix.
//
// What bounds it on an H100: at mamba2-370m's prefill (B 8, S 1024, H 32,
// P 64, G 1, N 128, Q 256, bf16) the four products are 21.5 GFLOP under the
// causal mask against 81 MB of inputs and outputs (x, dt, A, B and C read
// once, y and the final state written once): bound by bytes, 0.0241 ms at
// 3.35 TB/s (the operations take 0.0218 ms at the bf16 tensor-core peak;
// chip_smoke.py's ssd_bound_parts_ms computes both). This first version
// does every product as fp32 FMAs from shared memory (4 x 4 outputs per
// thread), off the tensor cores, and runs one block per SM (256 blocks over
// 132 SMs at that shape), so it sits far above that bound. mma/wgmma tiles
// and more blocks per (batch, head) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int T = 64;         // rows (and columns) of a tile of a chunk
constexpr int TP = T + 1;     // padded row length of the transposed tiles
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int MAX_P = 64;     // head_dim: 4 columns of 16 per thread
constexpr int MAX_N = 128;    // state size: 8 columns of 16 per thread
constexpr int MAX_Q = 4096;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T_>
__device__ __forceinline__ T_ from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// element strides of (batch, position, head or group) for x, y, dt, B, C
struct Strides {
  long long xb, xs, xh;
  long long yb, ys, yh;
  long long db, ds, dh;
  long long bb, bs, bg;
  long long cb, cs, cg;
};

// shared-memory layout in floats; PW and NW are P and N rounded up to 16
struct Layout {
  int state, ct, bt, xd, ss, cs, dtv, total;
  __host__ __device__ Layout(int N, int PW, int NW, int Q) {
    state = 0;                               // state^T: NW x (PW + 1)
    ct = state + NW * (PW + 1);              // C tile^T: N x TP
    bt = ct + N * TP;                        // B tile^T: N x TP, or B tile: T x NW
    const int bt_len = N * TP > T * NW ? N * TP : T * NW;
    xd = bt + bt_len;                        // (x dt) tile: T x PW
    ss = xd + T * PW;                        // masked scores^T: T x TP
    cs = ss + T * TP;                        // cumsum of dA over the chunk: Q
    dtv = cs + Q;                            // dt over the chunk: Q
    total = dtv + Q;
  }
};

template <typename T_>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T_* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T_* __restrict__ Bm,
               const T_* __restrict__ Cm, T_* __restrict__ y,
               float* __restrict__ final_state, int S, int H, int G, int P, int N,
               int Q, Strides st) {
  extern __shared__ float smem[];
  const int PW = (P + 15) / 16 * 16;
  const int NW = (N + 15) / 16 * 16;
  const int cp = PW / 16;
  const int cn = NW / 16;
  const Layout lay(N, PW, NW, Q);
  float* Sst = smem + lay.state;
  float* Ct = smem + lay.ct;
  float* Bt = smem + lay.bt;
  float* Xd = smem + lay.xd;
  float* Ss = smem + lay.ss;
  float* cs = smem + lay.cs;
  float* dtv = smem + lay.dtv;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const T_* xp = x + b * st.xb + h * st.xh;
  T_* yp = y + b * st.yb + h * st.yh;
  const float* dp = dt + b * st.db + h * st.dh;
  const T_* bp = Bm + b * st.bb + g * st.bg;
  const T_* cq = Cm + b * st.cb + g * st.cg;

  for (int idx = tid; idx < NW * (PW + 1); idx += THREADS) Sst[idx] = 0.0f;

  for (int r0 = 0; r0 < S; r0 += Q) {
    // dt and dA over the chunk (zero past S), then the inclusive scan of dA
    __syncthreads();  // the last chunk's readers of cs and dtv are done
    for (int i = tid; i < Q; i += THREADS) {
      const float d = r0 + i < S ? dp[(r0 + i) * st.ds] : 0.0f;
      dtv[i] = d;
      cs[i] = d * a;
    }
    __syncthreads();
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int i0 = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per && i0 + k < Q; ++k) {
        run += cs[i0 + k];
        cs[i0 + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float excl = incl - run;
      for (int k = 0; k < per && i0 + k < Q; ++k) cs[i0 + k] += excl;
    }
    __syncthreads();

    // y, one tile of 64 rows at a time
    for (int i0 = 0; i0 < Q; i0 += T) {
      for (int idx = tid; idx < T * N; idx += THREADS) {
        const int i = idx / N;
        const int n = idx % N;
        const int row = r0 + i0 + i;
        Ct[n * TP + i] = (i0 + i < Q && row < S) ? to_f32(cq[row * st.cs + n]) : 0.0f;
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      // inter-chunk term: (C state^T) * exp(cs)
      for (int n = 0; n < N; ++n) {
        float av[4];
        float sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = Ct[n * TP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = c < cp ? Sst[n * (PW + 1) + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float dec = i < Q ? expf(cs[i]) : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= dec;
      }

      // intra-chunk term over the column tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += T) {
        __syncthreads();  // the last tile's Bt, Xd and Ss are read
        for (int idx = tid; idx < T * N; idx += THREADS) {
          const int j = idx / N;
          const int n = idx % N;
          const int row = r0 + j0 + j;
          Bt[n * TP + j] = (j0 + j < Q && row < S) ? to_f32(bp[row * st.bs + n]) : 0.0f;
        }
        for (int idx = tid; idx < T * PW; idx += THREADS) {
          const int j = idx / PW;
          const int p = idx % PW;
          const int row = r0 + j0 + j;
          Xd[idx] = (p < P && j0 + j < Q && row < S)
                        ? to_f32(xp[row * st.xs + p]) * dtv[j0 + j] : 0.0f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float av[4];
          float bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = Ct[n * TP + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bt[n * TP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // mask first: exp only where j <= i
            const float l = (j <= i && i < Q) ? expf(cs[i] - cs[j]) : 0.0f;
            Ss[(tx + 16 * c) * TP + ty + 16 * r] = s[r][c] * l;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < T; ++j) {
          float av[4];
          float xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = Ss[j * TP + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = c < cp ? Xd[j * PW + tx + 16 * c] : 0.0f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], xv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const int row = r0 + i;
        if (i >= Q || row >= S) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yp[row * st.ys + p] = from_f32<T_>(acc[r][c]);
        }
      }
      __syncthreads();  // Ct and Ss are read before the next row tile
    }

    // state' = state * exp(tot) + (x dt)^T (B * exp(tot - cs))
    const float tot = cs[Q - 1];
    const float decay = expf(tot);
    float sacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sacc[r][c] = (r < cp && c < cn)
                         ? Sst[(tx + 16 * c) * (PW + 1) + ty + 16 * r] * decay : 0.0f;
    for (int j0 = 0; j0 < Q; j0 += T) {
      __syncthreads();  // the last tile's Bt and Xd are read
      for (int idx = tid; idx < T * NW; idx += THREADS) {
        const int j = idx / NW;
        const int n = idx % NW;
        const int row = r0 + j0 + j;
        Bt[idx] = (n < N && j0 + j < Q && row < S)
                      ? to_f32(bp[row * st.bs + n]) * expf(tot - cs[j0 + j]) : 0.0f;
      }
      for (int idx = tid; idx < T * PW; idx += THREADS) {
        const int j = idx / PW;
        const int p = idx % PW;
        const int row = r0 + j0 + j;
        Xd[idx] = (p < P && j0 + j < Q && row < S)
                      ? to_f32(xp[row * st.xs + p]) * dtv[j0 + j] : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < T; ++j) {
        float xv[4];
        float bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = r < cp ? Xd[j * PW + ty + 16 * r] : 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = c < cn ? Bt[j * NW + tx + 16 * c] : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[r][c] = fmaf(xv[r], bv[c], sacc[r][c]);
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (r < cp && c < cn) Sst[(tx + 16 * c) * (PW + 1) + ty + 16 * r] = sacc[r][c];
  }

  __syncthreads();
  float* fs = final_state + (static_cast<long long>(b) * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N;
    const int n = idx % N;
    fs[idx] = Sst[n * (PW + 1) + p];
  }
}

template <typename T_>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* final_state, int B, int S, int H, int G, int P, int N, int Q,
           const Strides& st, cudaStream_t stream) {
  const Layout lay(N, (P + 15) / 16 * 16, (N + 15) / 16 * 16, Q);
  const int bytes = static_cast<int>(sizeof(float) * lay.total);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<T_>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan<T_><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const T_*>(x), dt, A, static_cast<const T_*>(Bm),
      static_cast<const T_*>(Cm), static_cast<T_*>(y), final_state, S, H, G, P, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x, B, C and y). strides: 15 element strides,
// (batch, position, head or group) of x, y, dt, B and C in that order; each
// tensor has unit stride along its last dim. final_state is a contiguous
// (B, H, P, N) fp32 tensor. Returns a CUDA error code (0 when the launch was
// accepted).
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, void* final_state,
                               int B, int S, int H, int G, int P, int N, int Q,
                               const long long* strides, void* stream) {
  if (G <= 0 || H % G != 0 || P <= 0 || P > MAX_P || N <= 0 || N > MAX_N || Q <= 0 ||
      Q > MAX_Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* fs = static_cast<float*>(final_state);
  if (dtype == 0)
    return launch<float>(x, dtf, af, Bm, Cm, y, fs, B, S, H, G, P, N, Q, st, cs);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, af, Bm, Cm, y, fs, B, S, H, G, P, N, Q, st, cs);
  return static_cast<int>(cudaErrorInvalidValue);
}
