// ssd_scan: the Mamba2 SSD chunk scan for Hopper (sm_90a). x (B, S, H, P),
// dt (B, S, H) fp32, A (H,) fp32, B and C (B, S, G, N), fp32 or bf16 in;
// y (B, S, H, P) in x's type and the final state (B, H, P, N) in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:88 (ssd_scan,
// _ssd_kernel), and computes what the model's chunked path computes
// (repro/models/ssm.py::ssd_chunked). For each (batch, head) and each chunk of
// Q positions, with the (P, N) fp32 state carried across chunks:
//   dA = dt * A;  cs = inclusive cumsum of dA over the chunk;  tot = cs[Q-1];
//   y  = ((C B^T) o L) (x dt) + (C state^T) * exp(cs),
//        L[i, j] = exp(cs[i] - cs[j]) for j <= i, else 0;
//   state' = state * exp(tot) + (x dt)^T (B * exp(tot - cs)).
// Positions past S inside the last chunk load as zeros (dt = 0), so they
// neither decay nor add to the state. Head h reads group h / (H / G) of B and
// C; nothing is broadcast in memory.
//
// What bounds it on an H100: at mamba2-370m's prefill (B 8, S 1024, H 32,
// P 64, G 1, N 128, Q 256, bf16) the four products are 21.5 GFLOP under the
// causal mask against 81 MB of inputs and outputs: bound by bytes, 0.0241 ms
// at 3.35 TB/s (the operations take 0.0218 ms at the bf16 tensor-core peak;
// chip_smoke.py's ssd_bound_parts_ms computes both). The TPU kernel walks a
// (batch, head, chunk) grid whose chunk axis is sequential. This kernel's
// first version did the same with one CTA per (batch, head) and its products
// as FMAs off the tensor cores: 256 CTAs, 85x the bound.
//
// Design:
//   * A (batch, head)'s chunks are split over the CTAs of a thread-block
//     cluster (2; 4 or 8 only for very few (batch, head)s: elsewhere clusters
//     of 4 or 8 CTAs this large took longer than clusters of 2 walking more
//     groups; the planner in ssd_scan.py chooses). Rank r owns chunk r of
//     each group of `cluster` chunks. Each CTA computes its chunk's cumsum,
//     its own state contribution dS_r = (x dt)^T (B exp(tot_r - cs)) and decay
//     e_r = exp(tot_r) into its shared memory; after a cluster barrier it
//     builds its incoming state from the ranks below it through distributed
//     shared memory, in rank order (so the sum is deterministic):
//       S_in(r) = S_carry prod_{k<r} e_k + sum_{k<r} dS_k prod_{k<j<r} e_j,
//     as the recurrence S <- S e_k + dS_k over k = 0 .. r-1; a second cluster
//     barrier keeps every dS readable until all are read. A sequence longer
//     than a cluster walks its groups in order: the last rank runs the
//     recurrence over the whole group and leaves the carry in the final-state
//     output, which the next group's ranks read (in L2) after their first
//     barrier; after the last group it is the final state. One launch, no
//     workspace.
//   * Loads: B, C and x come through TMA (4-d maps over the (batch, position,
//     head or group) strides) as tiles of 128-byte rows in the 128-byte
//     swizzle, 64 positions of B and x a ring stage and 128 rows of C a
//     buffer, each with an mbarrier that its copy completes. Where the ring
//     can hold a whole chunk (bf16 at Q 256) each tile is loaded once and
//     read by both passes; else (fp32, longer chunks) the tiles stream
//     through the ring, once for the state pass and again for the y pass, and
//     a block barrier after each tile hands its stage back. A whole chunk
//     never has to fit (Q 256 of B and C in fp32 alone is 256 KB). TMA
//     zero-fills positions past S and columns past P and N. dt, one float a
//     position, is read with plain loads. A map needs 16-byte strides and
//     start; the wrapper copies a tensor that has not into padded rows (the
//     model's tensors never).
//   * Products on the tensor cores, warp-level mma.sync, 8 warps. The state
//     contribution takes 32 x N/4 of the state per warp. y takes 16 rows of
//     a 128-row C tile per warp: a warp's scores stay in registers and feed
//     the product with x as its A operand (as flash attention feeds P V). A
//     warp skips the 64-position tiles that the causal mask empties for its
//     rows; inside a tile nothing branches (on the diagonal every product is
//     taken and the mask, put on the exponent as -inf, zeroes it), so the
//     products of a tile issue back to back. The mask is applied before the
//     exp: above the diagonal cs[i] - cs[j] >= 0 and its exp can overflow.
//     bf16 inputs, fragments by ldmatrix: C B^T on m16n8k16 (exact products,
//     fp32 sum); the masked scores, the state contribution's x dt e and S_in
//     are fp32, and go in as bf16 hi + lo (two m16n8k16 products against the
//     bf16 operand, which is exact; hi + lo keeps about 16 bits), so the
//     final state keeps fp32 accuracy (held at 1e-3 of its max). fp32 inputs:
//     3xTF32 on every product (as ibn_pointwise.cu).
//   * The cumsum cs is an exact scan in shared memory (a serial run per
//     thread, then a scan of the threads' totals), kept scaled by log2(e) so
//     that every exp is an exp2f.
//
// What bounds it now: the passes are latency-bound at 8 warps on an SM (a
// CTA takes about 200 KB of shared memory and up to 255 registers a thread),
// with the loads, barriers and stores of a chunk about a third of the time.
// Every mbarrier wait traps after about 2 s (hopper.cuh) instead of spinning
// on a fault of the protocol. PERF.md has the kernel's times against its bound
// and the plain version.
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TJ = 64;               // positions of a B or x tile
constexpr int PW = 64;               // head_dim as the kernel pads it (P <= 64)
constexpr int TI = 16 * WARPS;       // rows of a C tile: 16 per warp
constexpr int MAX_N = 128;
constexpr int MAX_Q = 4096;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 232448;     // bytes a block may take on an H100
constexpr int MAX_DEVICES = 64;      // devices a process launches on, for the launch cache
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int PANEL = 32;  // elements in a 128-byte row
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elem<bf16> {
  static constexpr int PANEL = 64;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// the byte layout of one CTA's shared memory, from a 1024-byte aligned base:
// the ring of B and x tiles, the C buffers, the (P, N) state (dS in fp32, then
// S_in: fp32, or for bf16 inputs its bf16 hi and lo parts), cs (times
// log2(e)) and dt over the chunk, the decay and the scan's warp totals,
// mbarriers. ssd_scan.py's smem_bytes computes the same.
template <typename T, int NW>
struct Layout {
  static constexpr int E = sizeof(T);
  static constexpr int X_BYTES = TJ * PW * E;
  static constexpr int B_BYTES = TJ * NW * E;
  static constexpr int STAGE = X_BYTES + B_BYTES;
  static constexpr int C_BYTES = TI * NW * E;
  static constexpr int SP = NW + 4;  // floats per fp32 state row (conflict-free fragments)
  static constexpr int S_BYTES = PW * SP * 4;
  int cbuf, state, cs, dtv, misc, bars, total, smem;
  __host__ __device__ Layout(int stages, int cbufs, int q) {
    const int qw = (q + TJ - 1) / TJ * TJ;
    cbuf = stages * STAGE;
    state = cbuf + cbufs * C_BYTES;
    cs = state + S_BYTES;
    dtv = cs + 4 * qw;
    misc = dtv + 4 * qw;  // decay (16 bytes) and 8 warp totals
    bars = misc + 64;
    total = bars + 8 * (stages + cbufs);
    smem = total + 1024;  // room to align the base
  }
};

// byte offset of element (r, c) of a tile of ROWS rows: panels of 128-byte
// rows (PANEL columns), each ROWS rows, in TMA's 128-byte swizzle (the
// 16-byte chunk k of row r sits at chunk k ^ (r % 8))
template <typename T, int ROWS>
__device__ __forceinline__ uint32_t toff(int r, int c) {
  constexpr int PANEL = Elem<T>::PANEL;
  const int b = (c % PANEL) * static_cast<int>(sizeof(T));
  return static_cast<uint32_t>((c / PANEL) * (ROWS * 128) + r * 128 +
                               ((((b >> 4) ^ (r & 7)) << 4) | (b & 15)));
}

template <typename T, int ROWS>
__device__ __forceinline__ float ld1(const uint8_t* t, int r, int c) {
  return to_f32(*reinterpret_cast<const T*>(t + toff<T, ROWS>(r, c)));
}

// elements (r, c) and (r, c + 1) of an fp32 tile, c even
template <int ROWS>
__device__ __forceinline__ float2 ld2(const uint8_t* t, int r, int c) {
  return *reinterpret_cast<const float2*>(t + toff<float, ROWS>(r, c));
}

// bf16 hi and lo of two floats, each as a bf16x2 register (first in the low
// half): hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register m holds matrix m's (row t / 4, columns
// 2 (t % 4), + 1) for lane t, or with trans its (rows 2 (t % 4), + 1, column t / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the B fragments (b0, b1) of n8 blocks 2 h and 2 h + 1 for a k16 step, from
// a bf16 tile whose rows are n and columns k (K-major): ldsm rows n, columns k0 ..
template <int ROWS>
__device__ __forceinline__ void frag_b_kmajor(uint32_t (&b)[8][2], uint32_t base, int n0, int k0,
                                              int lane) {
  const int mat = lane >> 3;
  const int rr = lane & 7;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t q[4];
    ldsm_x4(q, base + toff<bf16, ROWS>(n0 + 8 * (2 * h + (mat >> 1)) + rr, k0 + (mat & 1) * 8));
    b[2 * h][0] = q[0];
    b[2 * h][1] = q[1];
    b[2 * h + 1][0] = q[2];
    b[2 * h + 1][1] = q[3];
  }
}

// the A fragment of rows r0 .. r0 + 15 for a k16 step from a K-major bf16 tile
template <int ROWS>
__device__ __forceinline__ void frag_a_kmajor(uint32_t (&a)[4], uint32_t base, int r0, int k0,
                                              int lane) {
  const int mat = lane >> 3;
  ldsm_x4(a, base + toff<bf16, ROWS>(r0 + (mat & 1) * 8 + (lane & 7), k0 + (mat >> 1) * 8));
}

struct Dims {
  int S, H, G, P, N, Q, nc, cluster, stages, cbufs;  // stages >= a chunk's tiles: resident
  int rows_x, rows_b, rows_c;  // 1 when the map's position axis precedes its head axis
  long long db, ds, dh;        // dt's element strides
  long long yb, ys, yh;        // y's
};

// one tile of `rows` positions from `s0` of a (inner, head, position, batch)
// map into dst, panel by panel
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int panels,
                                          int rows, int head, int s0, int b, int rows_first,
                                          uint32_t bar) {
  for (int p = 0; p < panels; ++p) {
    const int c0 = p * Elem<T>::PANEL;
    if (rows_first)
      tma_load_4d(dst + p * rows * 128, map, c0, s0, head, b, bar);
    else
      tma_load_4d(dst + p * rows * 128, map, c0, head, s0, b, bar);
  }
}

// the state contribution of one tile of 64 positions, j0 into the chunk:
// acc (P x N, this warp's 32 x NW/4) += (x w)^T B, w[j] = dt[j] exp(tot - cs[j]).
// bf16: x w as bf16 hi + lo against B (exact), on m16n8k16, fragments by
// ldmatrix; fp32: 3xTF32.
template <typename T, int NW>
__device__ __forceinline__ void state_tile(const uint8_t* xt, const uint8_t* bt, const float* cs2,
                                           const float* dtv, float tot2, int j0,
                                           float (&acc)[2][NW / 32][4], int wp, int wn,
                                           int lane) {
  constexpr int NI = NW / 32;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  if constexpr (sizeof(T) == 2) {
    const uint32_t xb = smem_u32(xt);
    const uint32_t bb = smem_u32(bt);
    const int mat = lane >> 3;
    const int rr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < TJ / 16; ++kk) {
      const int j = j0 + 16 * kk + 2 * tig;
      const float w0 = dtv[j] * exp2f(tot2 - cs2[j]);
      const float w1 = dtv[j + 1] * exp2f(tot2 - cs2[j + 1]);
      const float w2 = dtv[j + 8] * exp2f(tot2 - cs2[j + 8]);
      const float w3 = dtv[j + 9] * exp2f(tot2 - cs2[j + 9]);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A[p][j] = x[j][p] w[j]: x's rows are j, so the fragment is transposed
        uint32_t q[4];
        ldsm_x4_trans(q, xb + toff<bf16, TJ>(16 * kk + (mat >> 1) * 8 + rr,
                                             wp + 16 * i + (mat & 1) * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = unpack_bf16(q[e]);
          split_bf16(v.x * (e < 2 ? w0 : w2), v.y * (e < 2 ? w1 : w3), ah[i][e], al[i][e]);
        }
      }
      uint32_t bq[NI][2];
#pragma unroll
      for (int jn = 0; jn < NI; jn += 2) {
        uint32_t q[4];  // B[j][n]: rows j, so transposed
        ldsm_x4_trans(q, bb + toff<bf16, TJ>(16 * kk + (mat & 1) * 8 + rr,
                                             wn + 8 * (jn + (mat >> 1))));
        bq[jn][0] = q[0];
        bq[jn][1] = q[1];
        bq[jn + 1][0] = q[2];
        bq[jn + 1][1] = q[3];
      }
      // pass-major: consecutive mma write different accumulators
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_bf16(acc[i][jn], al[i], bq[jn]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_bf16(acc[i][jn], ah[i], bq[jn]);
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < TJ / 8; ++kk) {
      const int ja = 8 * kk + tig;
      const int jb = ja + 4;
      const float wa = dtv[j0 + ja] * exp2f(tot2 - cs2[j0 + ja]);
      const float wb = dtv[j0 + jb] * exp2f(tot2 - cs2[j0 + jb]);
      uint32_t ah[2][4], al[2][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = wp + 16 * i + grp;
        split(ld1<T, TJ>(xt, ja, p) * wa, ah[i][0], al[i][0]);
        split(ld1<T, TJ>(xt, ja, p + 8) * wa, ah[i][1], al[i][1]);
        split(ld1<T, TJ>(xt, jb, p) * wb, ah[i][2], al[i][2]);
        split(ld1<T, TJ>(xt, jb, p + 8) * wb, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int jn = 0; jn < NI; ++jn) {
        const int n = wn + 8 * jn + grp;
        split(ld1<T, TJ>(bt, ja, n), bh[jn][0], bl[jn][0]);
        split(ld1<T, TJ>(bt, jb, n), bh[jn][1], bl[jn][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_tf32(acc[i][jn], al[i], bh[jn]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_tf32(acc[i][jn], ah[i], bl[jn]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < NI; ++jn) mma_tf32(acc[i][jn], ah[i], bh[jn]);
    }
  }
}

// y of this warp's 16 rows (C tile rows lr ..) from the incoming state:
// yacc = C S_in^T (the caller scales rows by exp(cs); rows past the chunk are
// computed and not stored). bf16: S_in as bf16 hi + lo (sst holds the two
// parts) against C (exact) on m16n8k16, fragments by ldmatrix. fp32: 3xTF32,
// with the k index of each 8-step permuted (fragment column t holds n = 2t,
// column t + 4 holds n = 2t + 1) so that both operands load as pairs.
template <typename T, int NW>
__device__ __forceinline__ void inter_rows(const uint8_t* ct, const uint8_t* sst, int lr,
                                           float (&yacc)[8][4], int lane) {
  using L = Layout<T, NW>;
  constexpr int SH_BYTES = PW * NW * 2;  // one bf16 part of S_in
#pragma unroll
  for (int pb = 0; pb < 8; ++pb)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pb][e] = 0.0f;
  if constexpr (sizeof(T) == 2) {
    const uint32_t cb = smem_u32(ct);
    const uint32_t sh = smem_u32(sst);
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) {
      uint32_t a[4], bh[8][2], bl[8][2];
      frag_a_kmajor<TI>(a, cb, lr, 16 * kk, lane);
      frag_b_kmajor<PW>(bh, sh, 0, 16 * kk, lane);
      frag_b_kmajor<PW>(bl, sh + SH_BYTES, 0, 16 * kk, lane);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], a, bl[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], a, bh[pb]);
    }
  } else {
    const int grp = lane >> 2;
    const int tig = lane & 3;
    const float* sf = reinterpret_cast<const float*>(sst);
#pragma unroll 2
    for (int kk = 0; kk < NW / 8; ++kk) {
      const int n = 8 * kk + 2 * tig;
      const float2 c0 = ld2<TI>(ct, lr + grp, n);
      const float2 c1 = ld2<TI>(ct, lr + grp + 8, n);
      uint32_t ah[4], al[4];
      split(c0.x, ah[0], al[0]);
      split(c1.x, ah[1], al[1]);
      split(c0.y, ah[2], al[2]);
      split(c1.y, ah[3], al[3]);
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) {
        const float2 v = *reinterpret_cast<const float2*>(sf + (8 * pb + grp) * L::SP + n);
        split(v.x, bh[pb][0], bl[pb][0]);
        split(v.y, bh[pb][1], bl[pb][1]);
      }
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], ah, bl[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], al, bh[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], ah, bh[pb]);
    }
  }
}

// y of this warp's 16 rows (chunk rows r .., C tile rows lr ..) += the
// intra-chunk term over one tile of 64 positions from j0: ((C B^T) o L dt) x.
// The mask goes on the exponent (-inf above the diagonal) before the exp,
// L[i, j] = exp2(cs2[i] - cs2[j]). No branch inside: the
// caller skips the tiles that the mask empties for these rows; on the
// diagonal tile every product is taken and masked. bf16: C B^T on m16n8k16
// (exact products), the masked scores as bf16 hi + lo against x; fragments
// by ldmatrix. fp32: 3xTF32.
template <typename T, int NW>
__device__ __forceinline__ void intra_tile(const uint8_t* ct, const uint8_t* bt,
                                           const uint8_t* xt, const float* cs2,
                                           const float* dtv, int r, int lr, int j0,
                                           float (&yacc)[8][4],
                                           int lane) {
  const int grp = lane >> 2;
  const int tig = lane & 3;
  float sc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nb][e] = 0.0f;
  if constexpr (sizeof(T) == 2) {
    const uint32_t cb = smem_u32(ct);
    const uint32_t bb = smem_u32(bt);
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) {
      uint32_t a[4], b[8][2];
      frag_a_kmajor<TI>(a, cb, lr, 16 * kk, lane);
      frag_b_kmajor<TJ>(b, bb, 0, 16 * kk, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mma_bf16(sc[nb], a, b[nb]);
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < NW / 8; ++kk) {
      const int n = 8 * kk + 2 * tig;
      const float2 c0 = ld2<TI>(ct, lr + grp, n);
      const float2 c1 = ld2<TI>(ct, lr + grp + 8, n);
      uint32_t ah[4], al[4];
      split(c0.x, ah[0], al[0]);
      split(c1.x, ah[1], al[1]);
      split(c0.y, ah[2], al[2]);
      split(c1.y, ah[3], al[3]);
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 bv = ld2<TJ>(bt, 8 * nb + grp, n);
        split(bv.x, bh[nb][0], bl[nb][0]);
        split(bv.y, bh[nb][1], bl[nb][1]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mma_tf32(sc[nb], al, bh[nb]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mma_tf32(sc[nb], ah, bl[nb]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mma_tf32(sc[nb], ah, bh[nb]);
    }
  }
  // the mask on the exponent, then the exp: keep (i, j) for j <= i
  const int ia = r + grp;
  const int ib = ia + 8;
  const float csa = cs2[ia];
  const float csb = cs2[ib];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 8 * nb + 2 * tig + c;
      const float cj = cs2[j];
      const float dj = dtv[j];
      sc[nb][c] *= exp2f(j <= ia ? csa - cj : -INFINITY) * dj;
      sc[nb][2 + c] *= exp2f(j <= ib ? csb - cj : -INFINITY) * dj;
    }
  // y += scores x (k = the tile's positions)
  if constexpr (sizeof(T) == 2) {
    const uint32_t xb = smem_u32(xt);
    const int mat = lane >> 3;
    const int rr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4], b[8][2];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int pb = 0; pb < 8; pb += 2) {
        uint32_t q[4];  // b0, b1 of p block pb, then of pb + 1 (x's rows are j: transposed)
        ldsm_x4_trans(q, xb + toff<bf16, TJ>(16 * kk + (mat & 1) * 8 + rr,
                                             8 * (pb + (mat >> 1))));
        b[pb][0] = q[0];
        b[pb][1] = q[1];
        b[pb + 1][0] = q[2];
        b[pb + 1][1] = q[3];
      }
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], al, b[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_bf16(yacc[pb], ah, b[pb]);
    }
  } else {
    // the scores' accumulator layout is the A fragment of m16n8k8 with the
    // k index permuted as in inter_rows (column t: j = 2t, t + 4: j = 2t + 1)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int j = 8 * nb + 2 * tig;
      uint32_t ah[4], al[4], bh[8][2], bl[8][2];
      split(sc[nb][0], ah[0], al[0]);
      split(sc[nb][2], ah[1], al[1]);
      split(sc[nb][1], ah[2], al[2]);
      split(sc[nb][3], ah[3], al[3]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) {
        const int p = 8 * pb + grp;
        split(ld1<T, TJ>(xt, j, p), bh[pb][0], bl[pb][0]);
        split(ld1<T, TJ>(xt, j + 1, p), bh[pb][1], bl[pb][1]);
      }
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], al, bh[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], ah, bl[pb]);
#pragma unroll
      for (int pb = 0; pb < 8; ++pb) mma_tf32(yacc[pb], ah, bh[pb]);
    }
  }
}

// the last 64-position tile that C tile `it` reaches
__device__ __forceinline__ int last_tile(int it, int nj) {
  return min(nj - 1, (TI * (it + 1) - 1) / TJ);
}

// ring item w of a group: the 64-position tile it loads. Resident (the ring
// holds the chunk): tile w once. Else the state pass's tiles, then for each
// C tile its tiles 0 .. last_tile.
__device__ __forceinline__ int bx_tile(int w, int nj, bool resident) {
  if (resident || w < nj) return w;
  w -= nj;
  for (int i = 0;; ++i) {
    const int n = last_tile(i, nj) + 1;
    if (w < n) return w;
    w -= n;
  }
}

// One CTA: (batch, head) blockIdx.x / cluster, rank blockIdx.x % cluster, and
// chunks rank, rank + cluster, ... in groups.
template <typename T, int NW>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
               const float* __restrict__ A, T* __restrict__ y, float* final_state,
               const Dims d) {
  using L = Layout<T, NW>;
  constexpr int SP = L::SP;
  constexpr int NV = PW * NW / 4 / THREADS;  // float4s of the state per thread
  constexpr int X_PANELS = PW / Elem<T>::PANEL;
  constexpr int B_PANELS = NW / Elem<T>::PANEL;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the same offsets in every CTA of a cluster
  uint8_t* const sb = smem_raw + (base - raw);
  const L lay(d.stages, d.cbufs, d.Q);
  float* const sst = reinterpret_cast<float*>(sb + lay.state);
  float* const cs2 = reinterpret_cast<float*>(sb + lay.cs);  // cumsum of dA, times log2(e)
  float* const dtv = reinterpret_cast<float*>(sb + lay.dtv);
  float* const misc = reinterpret_cast<float*>(sb + lay.misc);
  auto ring_bar = [&](int s) { return base + lay.bars + 8 * s; };
  auto c_bar = [&](int s) { return base + lay.bars + 8 * (d.stages + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int cl = d.cluster;
  const int rank = cl > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int bh = blockIdx.x / cl;
  const int b = bh / d.H;
  const int h = bh % d.H;
  const int g = h / (d.H / d.G);
  const float a2 = A[h] * LOG2E;
  const int Q = d.Q;
  const int qw = (Q + TJ - 1) / TJ * TJ;
  const int nj = qw / TJ;              // 64-position tiles of a chunk
  const int nr = (Q + TI - 1) / TI;    // C tiles of a chunk
  const bool resident = d.stages >= nj;  // the ring holds a whole chunk's B and x
  const int groups = (d.nc + cl - 1) / cl;
  const int own = rank < d.nc ? (d.nc - rank + cl - 1) / cl : 0;  // groups with a chunk here
  int per = nj;                        // ring items per group
  if (!resident)
    for (int i = 0; i < nr; ++i) per += last_tile(i, nj) + 1;
  const int total_bx = own * per;
  const int total_c = own * nr;
  float* const fs = final_state + (static_cast<long long>(b) * d.H + h) * d.P * d.N;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tc)) : "memory");
    for (int s = 0; s < d.stages + d.cbufs; ++s) mbar_init(base + lay.bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* map_x = &tx;
  const CUtensorMap* map_b = &tb;
  const CUtensorMap* map_c = &tc;
  auto issue_bx = [&](int k) {
    if (k >= total_bx) return;
    const int s = k % d.stages;
    const uint32_t dst = base + s * L::STAGE;
    const int s0 = ((k / per) * cl + rank) * Q + bx_tile(k % per, nj, resident) * TJ;
    mbar_expect(ring_bar(s), L::STAGE);
    load_tile<T>(dst, map_x, X_PANELS, TJ, h, s0, b, d.rows_x, ring_bar(s));
    load_tile<T>(dst + L::X_BYTES, map_b, B_PANELS, TJ, g, s0, b, d.rows_b, ring_bar(s));
  };
  auto issue_c = [&](int k) {
    if (k >= total_c) return;
    const int s = k % d.cbufs;
    const int s0 = ((k / nr) * cl + rank) * Q + (k % nr) * TI;
    mbar_expect(c_bar(s), L::C_BYTES);
    load_tile<T>(base + lay.cbuf + s * L::C_BYTES, map_c, B_PANELS, TI, g, s0, b, d.rows_c,
                 c_bar(s));
  };
  if (tid == 0) {
    for (int k = 0; k < (resident ? nj : d.stages); ++k) issue_bx(k);
    for (int k = 0; k < d.cbufs; ++k) issue_c(k);
  }

  const float* dtp = dt + b * d.db + h * d.dh;
  int kb = 0;  // ring items consumed
  int kc = 0;  // C tiles consumed

  for (int gi = 0; gi < groups; ++gi) {
    const int chunk = gi * cl + rank;
    const bool live = chunk < d.nc;
    const long long pos0 = static_cast<long long>(chunk) * Q;

    // ---- dt over the chunk (zero past Q and S) and the scan of dA
    __syncthreads();  // the last group's readers of cs2 and dt are done
    if (live) {
      for (int i = tid; i < qw; i += THREADS) {
        const long long s = pos0 + i;
        const float v = i < Q && s < d.S ? dtp[s * d.ds] : 0.0f;
        dtv[i] = v;
        cs2[i] = v * a2;
      }
      __syncthreads();
      const int each = (qw + THREADS - 1) / THREADS;
      const int i0 = tid * each;
      float run = 0.0f;
      for (int k = 0; k < each && i0 + k < qw; ++k) {
        run += cs2[i0 + k];
        cs2[i0 + k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      if (lane == 31) misc[8 + warp] = incl;
      __syncthreads();
      float excl = incl - run;
      for (int w = 0; w < warp; ++w) excl += misc[8 + w];
      for (int k = 0; k < each && i0 + k < qw; ++k) cs2[i0 + k] += excl;
      __syncthreads();
    }
    const float tot2 = live ? cs2[qw - 1] : 0.0f;

    // ---- this chunk's state contribution dS = (x dt exp(tot - cs))^T B
    float acc[2][NW / 32][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NW / 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    const int wp = (warp % 2) * 32;
    const int wn = (warp / 2) * (NW / 4);
    const int kb0 = kb;  // the group's first ring item
    if (live) {
      for (int jt = 0; jt < nj; ++jt, ++kb) {
        const int s = kb % d.stages;
        mbar_wait(ring_bar(s), (kb / d.stages) & 1);
        const uint8_t* xt = sb + s * L::STAGE;
        state_tile<T, NW>(xt, xt + L::X_BYTES, cs2, dtv, tot2, jt * TJ, acc, wp, wn, lane);
        if (!resident) {
          __syncthreads();  // every warp is done with stage s
          if (tid == 0) issue_bx(kb + d.stages);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NW / 32; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(sst + (wp + 16 * i + grp + 8 * hh) * SP + wn + 8 * j +
                                     2 * tig) = make_float2(acc[i][j][2 * hh],
                                                            acc[i][j][2 * hh + 1]);
    if (tid == 0) misc[0] = exp2f(tot2);

    // ---- the incoming state, in rank order through distributed shared memory
    if (cl > 1)
      cluster_sync();  // every rank's dS and decay are written (and the last group's carry)
    else
      __syncthreads();
    const bool last_group = gi == groups - 1;
    // ranks below this one give S_in; the whole group gives the carry to the
    // next group (and, in the last, the final state), which the last rank
    // keeps in final_state: it is read here by the next group's ranks after
    // the barrier above, in L2 (ld.global.cg)
    const int upto = last_group && rank != cl - 1 ? rank : cl;
    float4 st[NV];
    float4 s_in[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      st[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int q = tid + THREADS * v;
      const int p = q / (NW / 4);
      const int n = 4 * (q % (NW / 4));
      if (gi > 0 && p < d.P) {
        const float* src = fs + static_cast<long long>(p) * d.N + n;
        if (d.N % 4 == 0) {
          if (n < d.N) st[v] = __ldcg(reinterpret_cast<const float4*>(src));
        } else {
          st[v].x = n < d.N ? __ldcg(src) : 0.0f;
          st[v].y = n + 1 < d.N ? __ldcg(src + 1) : 0.0f;
          st[v].z = n + 2 < d.N ? __ldcg(src + 2) : 0.0f;
          st[v].w = n + 3 < d.N ? __ldcg(src + 3) : 0.0f;
        }
      }
    }
    for (int k = 0; k < upto; ++k) {
      if (k == rank) {
#pragma unroll
        for (int v = 0; v < NV; ++v) s_in[v] = st[v];
      }
      const uint32_t mine = base + lay.misc;
      const float e = cl > 1 ? ld_cluster_f4(map_cluster(mine, k)).x : misc[0];
      float4 ds[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int q = tid + THREADS * v;
        const int p = q / (NW / 4);
        const int n = 4 * (q % (NW / 4));
        const uint32_t off = base + lay.state + static_cast<uint32_t>((p * SP + n) * 4);
        ds[v] = cl > 1 ? ld_cluster_f4(map_cluster(off, k))
                       : *reinterpret_cast<const float4*>(sb + (off - base));
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        st[v].x = st[v].x * e + ds[v].x;
        st[v].y = st[v].y * e + ds[v].y;
        st[v].z = st[v].z * e + ds[v].z;
        st[v].w = st[v].w * e + ds[v].w;
      }
    }
    if (upto == rank) {
#pragma unroll
      for (int v = 0; v < NV; ++v) s_in[v] = st[v];
    }
    if (cl > 1)
      cluster_sync();  // no rank's dS (or the carry) is read any more
    else
      __syncthreads();
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int q = tid + THREADS * v;
      const int p = q / (NW / 4);
      const int n = 4 * (q % (NW / 4));
      if constexpr (sizeof(T) == 2) {  // S_in as bf16 hi and lo, for inter_rows
        uint2 hi, lo;
        split_bf16(s_in[v].x, s_in[v].y, hi.x, lo.x);
        split_bf16(s_in[v].z, s_in[v].w, hi.y, lo.y);
        uint8_t* sh = sb + lay.state + toff<bf16, PW>(p, n);
        *reinterpret_cast<uint2*>(sh) = hi;
        *reinterpret_cast<uint2*>(sh + PW * NW * 2) = lo;
      } else {
        *reinterpret_cast<float4*>(sst + p * SP + n) = s_in[v];
      }
      if (rank == cl - 1 && p < d.P) {  // the carry, and after the last group the final state
        float* dst = fs + static_cast<long long>(p) * d.N + n;
        if (d.N % 4 == 0) {
          if (n < d.N) *reinterpret_cast<float4*>(dst) = st[v];
        } else {
          const float vals[4] = {st[v].x, st[v].y, st[v].z, st[v].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < d.N) dst[e] = vals[e];
        }
      }
    }
    __syncthreads();  // S_in is in shared memory
    if (!live) continue;

    // ---- y, one C tile at a time
    for (int it = 0; it < nr; ++it, ++kc) {
      const int cb = kc % d.cbufs;
      mbar_wait(c_bar(cb), (kc / d.cbufs) & 1);
      const uint8_t* ct = sb + lay.cbuf + cb * L::C_BYTES;
      const int lr = warp * 16;     // the warp's rows in the C tile
      const int r = it * TI + lr;   // and in the chunk
      const bool rows = r < Q;
      float yacc[8][4];
      if (rows) {
        inter_rows<T, NW>(ct, sb + lay.state, lr, yacc, lane);
        const float da = exp2f(cs2[r + grp]);
        const float db = exp2f(cs2[r + grp + 8]);
#pragma unroll
        for (int pb = 0; pb < 8; ++pb) {
          yacc[pb][0] *= da;
          yacc[pb][1] *= da;
          yacc[pb][2] *= db;
          yacc[pb][3] *= db;
        }
      }
      const int jm = last_tile(it, nj);
      for (int jt = 0; jt <= jm; ++jt) {
        int s = (kb0 + jt) % d.stages;  // resident: the state pass waited for it
        if (!resident) {
          s = kb % d.stages;
          mbar_wait(ring_bar(s), (kb / d.stages) & 1);
        }
        const uint8_t* xt = sb + s * L::STAGE;
        if (rows && jt * TJ <= r + 15)  // the tiles past the diagonal are all masked
          intra_tile<T, NW>(ct, xt + L::X_BYTES, xt, cs2, dtv, r, lr, jt * TJ, yacc, lane);
        if (!resident) {
          __syncthreads();  // every warp is done with stage s (and, at the last, with ct)
          if (tid == 0) issue_bx(kb + d.stages);
          ++kb;
        }
      }
      if (resident) __syncthreads();  // every warp is done with ct
      if (tid == 0) issue_c(kc + d.cbufs);
      if (rows) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r + grp + 8 * hh;
          const long long s = pos0 + row;
          if (row >= Q || s >= d.S) continue;
          T* yr = y + b * d.yb + s * d.ys + h * d.yh;
#pragma unroll
          for (int pb = 0; pb < 8; ++pb) {
            const int p = 8 * pb + 2 * tig;
            const float u0 = yacc[pb][2 * hh];
            const float u1 = yacc[pb][2 * hh + 1];
            if (p + 1 < d.P && d.P % 2 == 0) {
              if constexpr (sizeof(T) == 4) {
                *reinterpret_cast<float2*>(yr + p) = make_float2(u0, u1);
              } else {
                *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(u0, u1);
              }
            } else {
              if (p < d.P) yr[p] = from_f32<T>(u0);
              if (p + 1 < d.P) yr[p + 1] = from_f32<T>(u1);
            }
          }
        }
      }
    }
    if (resident) {
      __syncthreads();  // every warp is done with the ring: the next chunk's tiles go in
      if (tid == 0)
        for (int k = 0; k < nj; ++k) issue_bx(kb + k);
    }
  }
}

// a (batch, position, head or group, inner) tensor as a 4-d TMA map of
// PANEL x rows boxes, the position and head axes in order of their strides
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int inner, int heads, int S, int B,
              long long sb, long long ss, long long sh, int rows, int* rows_first) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const bool rf = ss <= sh;
  *rows_first = rf ? 1 : 0;
  constexpr long long E = sizeof(T);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rf ? S : heads),
                        static_cast<cuuint64_t>(rf ? heads : S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(E * (rf ? ss : sh)),
                           static_cast<cuuint64_t>(E * (rf ? sh : ss)),
                           static_cast<cuuint64_t>(E * sb)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(Elem<T>::PANEL),
                       static_cast<cuuint32_t>(rf ? rows : 1),
                       static_cast<cuuint32_t>(rf ? 1 : rows), 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, Elem<T>::TMA, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* fs;
  int B, S, H, G, P, N, Q, cluster, stages, cbufs;
  const long long* st;  // (batch, position, head or group) of x, y, dt, B, C
};

template <typename T, int NW>
int launch_cfg(const Args& g, cudaStream_t stream) {
  auto kernel = ssd_chunk_scan<T, NW>;
  const Layout<T, NW> lay(g.stages, g.cbufs, g.Q);
  if (lay.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory limit and the cluster-size attribute, set at the first
  // launch on each device, so later launches ask the driver nothing
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const long long* s = g.st;
  Dims d{};
  d.S = g.S;
  d.H = g.H;
  d.G = g.G;
  d.P = g.P;
  d.N = g.N;
  d.Q = g.Q;
  d.nc = (g.S + g.Q - 1) / g.Q;
  d.cluster = g.cluster;
  d.stages = g.stages;
  d.cbufs = g.cbufs;
  d.yb = s[3];
  d.ys = s[4];
  d.yh = s[5];
  d.db = s[6];
  d.ds = s[7];
  d.dh = s[8];
  CUtensorMap tx, tb, tc;
  const bool ok =
      make_map<T>(&tx, g.x, g.P, g.H, g.S, g.B, s[0], s[1], s[2], TJ, &d.rows_x) &&
      make_map<T>(&tb, g.Bm, g.N, g.G, g.S, g.B, s[9], s[10], s[11], TJ, &d.rows_b) &&
      make_map<T>(&tc, g.Cm, g.N, g.G, g.S, g.B, s[12], s[13], s[14], TI, &d.rows_c);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(g.B) * g.H * g.cluster;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tb, tc, g.dt, g.A, static_cast<T*>(g.y), g.fs, d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (x, B, C and y). strides: 15 element strides,
// (batch, position, head or group) of x, y, dt, B and C in that order; each
// tensor has unit stride along its last dim, and x, B and C start on 16 bytes
// with strides of 16-byte multiples (TMA's rule). final_state is a contiguous
// (B, H, P, N) fp32 tensor. cluster: CTAs per (batch, head) (1, 2, 4 or 8);
// stages and cbufs: the ring's stages and the C buffers (ssd_scan.py's plan).
// Returns a CUDA error code (0 when the launch was accepted).
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, void* final_state,
                               int B, int S, int H, int G, int P, int N, int Q, int cluster,
                               int stages, int cbufs, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > PW || N <= 0 ||
      N > MAX_N || Q <= 0 || Q > MAX_Q || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || stages < 1 || cbufs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, y,
               static_cast<float*>(final_state), B, S, H, G, P, N, Q, cluster, stages, cbufs,
               strides};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N > 64;
  if (dtype == 0) return wide ? launch_cfg<float, 128>(g, s) : launch_cfg<float, 64>(g, s);
  if (dtype == 1) return wide ? launch_cfg<bf16, 128>(g, s) : launch_cfg<bf16, 64>(g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared memory one CTA takes (bytes) for this type, state size, chunk
// and buffers: what ssd_scan.py's plan computes
extern "C" int ssd_scan_smem(int dtype, int N, int Q, int stages, int cbufs) {
  const bool wide = N > 64;
  if (dtype == 0)
    return wide ? Layout<float, 128>(stages, cbufs, Q).smem
                : Layout<float, 64>(stages, cbufs, Q).smem;
  return wide ? Layout<bf16, 128>(stages, cbufs, Q).smem
              : Layout<bf16, 64>(stages, cbufs, Q).smem;
}
