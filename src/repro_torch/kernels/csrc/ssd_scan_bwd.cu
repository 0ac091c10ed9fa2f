// ssd_scan_bwd: the gradient of ssd_scan.cu's chunk scan for Hopper
// (sm_90a): dx, dt's, A's, B's and C's gradients from the forward's inputs,
// y's cotangent dy and the final state's dstate (fp32, or none). x, B, C and
// dy fp32 or bf16 (one type), dt and A fp32; the gradients in the inputs'
// types.
//
// The TPU kernel (src/repro/kernels/ssd_scan.py:88) has no VJP: the
// reference's Mamba2 mixer differentiates its jnp chunked scan. These
// kernels compute that gradient, which ref.py's ssd_chunked_bwd writes out:
// per (batch, head) and chunk c of Q positions (cs the chunk's cumsum of
// dt A, tot its last entry, L[i, j] = exp(cs_i - cs_j) for j <= i, xdt = x dt)
//   Sf(c) = sum_j xdt_j^T B_j e^(tot - cs_j),  Sb(c) = sum_i e^cs_i dy_i^T C_i;
//   h_in(c + 1) = e^tot h_in(c) + Sf(c) from 0;
//   dh_out(c - 1) = e^tot dh_out(c) + Sb(c) from dstate;
//   dxdt = ((C B^T) o L)^T dy + e^(tot - cs) B dh_out^T;
//   dC = ((dy xdt^T) o L) B + e^cs dy h_in;
//   dB = ((dy xdt^T) o L)^T C + e^(tot - cs) xdt dh_out;
//   dcs = rowsum(M) - colsum(M) + e^cs rowsum(dy o (C h_in^T)) - w, with
//   M = (dy xdt^T) o (C B^T) o L and w_j = xdt_j . (e^(tot - cs_j) dh_out B_j);
//   dtot = e^tot <h_in, dh_out> + sum_j w_j; d(dt A) = reverse cumsum of
//   dcs, plus dtot; dt's gradient d(dt A) A + rowsum(dxdt o x), A's the sum
//   of d(dt A) dt, dx = dxdt dt; B's and C's gradients summed over each
//   group's heads. Padded tail positions (dt = 0, zeros) add nothing.
//
// Five launches, each parallel over (batch, head) and more; the only
// sequential part is the state pass, one element of the (P, N) states a
// thread:
//   ssd_bwd_states  (chunk, head, batch): the chunk's cumsum (kept in a
//     workspace for the others), Sf and Sb, 8 warps (4 on each);
//   ssd_bwd_pass    (state elements, head, batch): Sf into h_in and Sb into
//     dh_out in place, in chunk order. The forward's per-chunk states are
//     recomputed here, not saved by the forward: that would hold B H nc P N
//     floats a layer from forward to backward (33.5 MB at mamba2-370m's
//     training shape, 1.6 GB over its 48 layers), and the serve path's
//     forward would change;
//   ssd_bwd_chunk   (batch, head, chunk, 64-position tile), 4 warps of 16
//     rows: the tile's rows as keys (j) against every tile i >= it (dxdt, dB,
//     colsum M), then as queries (i) against every tile j <= it (dC, rowsum
//     M), so every block walks the chunk's tiles once plus one; dx and dt's
//     x-part written, dB and dC per head and dcs and w per position into
//     workspaces;
//   ssd_bwd_finish  (chunk, head, batch): dtot, the reverse cumsum, dt's
//     gradient completed and A's per (batch, chunk, head);
//   ssd_bwd_reduce: dB and dC summed over each group's heads, A's gradient
//     over batches and chunks.
// Every sum across heads, chunks or a block is taken in a fixed order, with
// no atomics: the same inputs give bitwise the same gradients. Products on
// warp_tiles.cuh (mma.sync m16n8k16 on bf16 with fp32 sums; fp32 FMAs on
// fp32); loads are plain strided loads. dA sums terms that cancel, so in
// bf16 what feeds the cumsum's cotangent keeps fp32 accuracy: dy xdt^T is
// taken as (dy x^T) dt on the exact bf16 x, and the scaled chunk terms of Sf
// and Sb and the states h_in and dh_out enter their products as bf16 hi and
// lo parts (two products, about 16 bits); only the operands of dx's, dB's
// and dC's Q x Q products (the masked scores) are rounded to bf16.
//
// What bounds it on an H100: at mamba2-370m's training shape (B 8, S 1024,
// H 32, P 64, G 1, N 128, Q 256, bf16) the plain backward's products need
// 60 GFLOP under the causal mask against about 111 MB of inputs and
// outputs: bound by operations, 0.061 ms at 989 TFLOP/s (chip_smoke.py's
// ssd_bwd_bound_parts_ms computes both). The five launches move their
// fp32 workspaces too (about 0.34 GB there: the per-chunk states, and dB
// and dC per head before the sum over the group).
#include <cstdint>

#include "warp_tiles.cuh"

namespace {

using namespace tiles;
constexpr int TJ = 64;          // positions of a tile
constexpr int PW = 64;          // head_dim as the kernels pad it (P <= 64)
constexpr int MAX_N = 128;
constexpr int MAX_Q = 4096;
constexpr int MAX_SMEM = 232448;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dstate;  // (B, H, P, N) contiguous, or null
  void* dx;             // (B, S, H, P) contiguous
  float* ddt;           // (B, S, H)
  float* dA;            // (H,)
  void* dB;             // (B, S, G, N)
  void* dC;
  // workspaces, fp32: cs, dcs and w (B, H, nc, Q); Sf -> h_in and Sb -> dh_out
  // (B, H, nc, P, N); dB and dC per head (B, S, H, N); A's per (B, nc, H)
  float *cs, *dcs, *w, *sf, *sb, *dbh, *dch, *dap;
  int B, S, H, G, P, N, Q, nc;
  long long sx[4], sdt[3], sb_[4], sc[4], sdy[4];  // element strides
};

__device__ __forceinline__ float dt_at(const Args& g, int b, int pos, int h) {
  return g.dt[b * g.sdt[0] + pos * g.sdt[1] + h * g.sdt[2]];
}

template <typename T>
__device__ __forceinline__ const T* row4(const void* base, const long long* st, int b, int pos,
                                         int head) {
  return static_cast<const T*>(base) + b * st[0] + pos * st[1] + head * st[2];
}

// the chunk's positions [r0, r0 + TJ) that hold data: inside the chunk and
// before S (may be <= 0)
__device__ __forceinline__ int rows_in(const Args& g, int c, int r0) {
  return min(TJ, min(g.Q - r0, g.S - c * g.Q - r0));
}

template <typename T, int NW>
__global__ void __launch_bounds__(256) ssd_bwd_states(Args g) {
  constexpr int LX = PW + PAD<T>;
  constexpr int LB = NW + PAD<T>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr bool SPLIT = sizeof(T) == 2;    // bf16: hi and lo parts
  T* Xs = reinterpret_cast<T*>(smem_raw);  // x dt e^(tot - cs)
  T* Ys = Xs + TJ * LX;                    // dy e^cs
  T* Xl = Ys + TJ * LX;                    // their lo parts (bf16)
  T* Yl = Xl + (SPLIT ? TJ * LX : 0);
  T* Bs = Yl + (SPLIT ? TJ * LX : 0);
  T* Cs = Bs + TJ * LB;
  float* fx = reinterpret_cast<float*>(Cs + TJ * LB);  // a tile's row factors
  float* fy = fx + TJ;
  float* cs = fy + TJ;
  float* tmp = cs + g.Q;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (g.H / g.G);
  const int p0 = c * g.Q;
  const float a = g.A[h];
  for (int l = threadIdx.x; l < g.Q; l += blockDim.x)
    cs[l] = p0 + l < g.S ? dt_at(g, b, p0 + l, h) * a : 0.0f;
  block_scan(cs, g.Q, false, tmp);
  const float tot = cs[g.Q - 1];
  float* csw = g.cs + ((static_cast<long long>(b) * g.H + h) * g.nc + c) * g.Q;
  for (int l = threadIdx.x; l < g.Q; l += blockDim.x) csw[l] = cs[l];

  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3;
  const bool fwd = warp < 4;  // warps 0-3: Sf; 4-7: Sb
  float acc[NW / 8][4];
  zero(acc);
  for (int j0 = 0; j0 < g.Q; j0 += TJ) {
    __syncthreads();
    const int rows = rows_in(g, c, j0);
    load_tile<TJ, PW, 256>(Xs, LX, row4<T>(g.x, g.sx, b, p0 + j0, h), g.sx[1], g.sx[3], rows,
                           g.P);
    load_tile<TJ, PW, 256>(Ys, LX, row4<T>(g.dy, g.sdy, b, p0 + j0, h), g.sdy[1], g.sdy[3],
                           rows, g.P);
    load_tile<TJ, NW, 256>(Bs, LB, row4<T>(g.Bm, g.sb_, b, p0 + j0, grp), g.sb_[1], g.sb_[3],
                           rows, g.N);
    load_tile<TJ, NW, 256>(Cs, LB, row4<T>(g.Cm, g.sc, b, p0 + j0, grp), g.sc[1], g.sc[3], rows,
                           g.N);
    for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
      const int l = j0 + r;
      fx[r] = r < rows ? dt_at(g, b, p0 + l, h) * expf(tot - cs[l]) : 0.0f;
      fy[r] = r < rows ? expf(cs[l]) : 0.0f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TJ * PW; idx += blockDim.x) {  // x dt e^(tot-cs), dy e^cs
      const int at = idx / PW * LX + idx % PW;
      const float xv = to_f32(Xs[at]) * fx[idx / PW];
      const float yv = to_f32(Ys[at]) * fy[idx / PW];
      Xs[at] = from_f32<T>(xv);
      Ys[at] = from_f32<T>(yv);
      if constexpr (SPLIT) {
        Xl[at] = from_f32<T>(xv - to_f32(Xs[at]));
        Yl[at] = from_f32<T>(yv - to_f32(Ys[at]));
      }
    }
    __syncthreads();
    const T* lo = fwd ? Xl : Yl;
    mma<T, NW / 8, TJ, true, true>(acc, (fwd ? Xs : Ys) + 16 * wr, LX, fwd ? Bs : Cs, LB);
    if constexpr (SPLIT) mma<T, NW / 8, TJ, true, true>(acc, lo + 16 * wr, LX, fwd ? Bs : Cs, LB);
  }
  float* out = (fwd ? g.sf : g.sb) +
               ((static_cast<long long>(b) * g.H + h) * g.nc + c) * g.P * g.N;
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * wr + frag_row(e);
      const int n = frag_col(t, e);
      if (p < g.P && n < g.N) out[p * g.N + n] = acc[t][e];
    }
}

// a thread takes 4 neighbouring state elements and loads 4 chunks' values
// ahead, so 16 loads are in flight while the recurrence runs
constexpr int PASS_VEC = 4;
constexpr int PASS_AHEAD = 4;

__global__ void __launch_bounds__(256) ssd_bwd_pass(Args g) {
  const int pn = g.P * g.N;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * PASS_VEC;
  if (e0 >= pn) return;
  const int nv = min(PASS_VEC, pn - e0);
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * g.H + h;
  const float* csw = g.cs + bh * g.nc * g.Q;
  // one direction of the pass over `buf` (Sf -> h_in forwards from 0, or
  // Sb -> dh_out backwards from dstate): out(c) = carry; carry = carry
  // e^tot(c) + own(c)
  auto pass = [&](float* buf, const float* start, bool forward) {
    float carry[PASS_VEC];
#pragma unroll
    for (int j = 0; j < PASS_VEC; ++j) carry[j] = start != nullptr && j < nv ? start[j] : 0.0f;
    for (int c0 = 0; c0 < g.nc; c0 += PASS_AHEAD) {
      float own[PASS_AHEAD][PASS_VEC];
      float decay[PASS_AHEAD];
#pragma unroll
      for (int u = 0; u < PASS_AHEAD; ++u) {
        const int c = forward ? c0 + u : g.nc - 1 - c0 - u;
        const bool in = c0 + u < g.nc;
        decay[u] = in ? expf(csw[c * g.Q + g.Q - 1]) : 0.0f;
#pragma unroll
        for (int j = 0; j < PASS_VEC; ++j)
          own[u][j] = in && j < nv ? buf[static_cast<long long>(c) * pn + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < PASS_AHEAD; ++u) {
        if (c0 + u >= g.nc) break;
        const int c = forward ? c0 + u : g.nc - 1 - c0 - u;
#pragma unroll
        for (int j = 0; j < PASS_VEC; ++j) {
          if (j < nv) buf[static_cast<long long>(c) * pn + j] = carry[j];
          carry[j] = carry[j] * decay[u] + own[u][j];
        }
      }
    }
  };
  pass(g.sf + bh * g.nc * pn + e0, nullptr, true);
  pass(g.sb + bh * g.nc * pn + e0, g.dstate != nullptr ? g.dstate + bh * pn + e0 : nullptr,
       false);
}

template <typename T, int NW>
constexpr int chunk_smem() {
  constexpr int LX = PW + PAD<T>, LB = NW + PAD<T>, LS = TJ + PAD<T>;
  constexpr int own = 2 * TJ * LB + 2 * TJ * LX;
  constexpr int loop = TJ * LB + TJ * LX + 2 * TJ * LS;
  constexpr int states = (sizeof(T) == 2 ? 2 : 1) * PW * LB;
  return (own + (loop > states ? loop : states)) * static_cast<int>(sizeof(T)) + 4 * TJ * 4;
}

template <typename T, int NW>
__global__ void __launch_bounds__(128) ssd_bwd_chunk(Args g) {
  constexpr int LX = PW + PAD<T>;
  constexpr int LB = NW + PAD<T>;
  constexpr int LS = TJ + PAD<T>;
  constexpr bool SPLIT = sizeof(T) == 2;  // bf16: the states as hi and lo parts
  constexpr int own_elems = 2 * TJ * LB + 2 * TJ * LX;
  constexpr int loop = TJ * LB + TJ * LX + 2 * TJ * LS;
  constexpr int states = (SPLIT ? 2 : 1) * PW * LB;
  constexpr int union_elems = loop > states ? loop : states;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Bo = reinterpret_cast<T*>(smem_raw);  // the block's own tile: B, C, dy, x
  T* Co = Bo + TJ * LB;
  T* Do = Co + TJ * LB;
  T* xo = Do + TJ * LX;
  T* Hs = xo + TJ * LX;  // dh_out, later h_in (P x N), and its lo part; or the
  T* Hl = Hs + PW * LB;  // loop's tiles:
  T* L1 = Hs;            //   C_i or B_j
  T* L2 = L1 + TJ * LB;  //   dy_i or x_j
  T* S1 = L2 + TJ * LX;  //   the scores^T, a warp's 16 rows each
  T* S2 = S1 + TJ * LS;  //   (dy xdt^T) o L, or its transpose
  float* cs_o = reinterpret_cast<float*>(Bo + own_elems + union_elems);
  float* dt_o = cs_o + TJ;
  float* cs_l = dt_o + TJ;
  float* dt_l = cs_l + TJ;

  // the chunk's tiles are neighbours in the grid: they read each other's
  // rows, which then come from L2
  const int nt = (g.Q + TJ - 1) / TJ;
  const int tile = blockIdx.x % nt;
  const long long bhc = blockIdx.x / nt;  // (b H + h) nc + c
  const int c = bhc % g.nc;
  const int b = bhc / g.nc / g.H, h = bhc / g.nc % g.H;
  const int grp = h / (g.H / g.G);
  const int r0 = tile * TJ;
  const int p0 = c * g.Q;
  const float* csw = g.cs + bhc * g.Q;
  const float tot = csw[g.Q - 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int own = rows_in(g, c, r0);

  for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
    cs_o[r] = r0 + r < g.Q ? csw[r0 + r] : tot;
    dt_o[r] = r < own ? dt_at(g, b, p0 + r0 + r, h) : 0.0f;
  }
  load_tile<TJ, NW, 128>(Bo, LB, row4<T>(g.Bm, g.sb_, b, p0 + r0, grp), g.sb_[1], g.sb_[3], own,
                         g.N);
  load_tile<TJ, NW, 128>(Co, LB, row4<T>(g.Cm, g.sc, b, p0 + r0, grp), g.sc[1], g.sc[3], own,
                         g.N);
  load_tile<TJ, PW, 128>(xo, LX, row4<T>(g.x, g.sx, b, p0 + r0, h), g.sx[1], g.sx[3], own, g.P);
  load_tile<TJ, PW, 128>(Do, LX, row4<T>(g.dy, g.sdy, b, p0 + r0, h), g.sdy[1], g.sdy[3], own,
                         g.P);
  load_tile<PW, NW, 128>(Hs, LB, g.sb + bhc * g.P * g.N, g.N, 1, g.P, g.N,
                         SPLIT ? Hl : nullptr);  // dh_out
  __syncthreads();

  // ---- the tile's rows as keys j: dxdt and dB, from dh_out and every tile i >= it
  const int w16 = 16 * warp;
  float dxdt[PW / 8][4];
  float db[NW / 8][4];
  zero(dxdt);
  zero(db);
  float wj[2] = {0.0f, 0.0f};
  float colm[2] = {0.0f, 0.0f};
  mma<T, PW / 8, NW, false, false>(dxdt, Bo + w16 * LB, LB, Hs, LB);  // B dh_out^T
  mma<T, NW / 8, PW, false, true>(db, xo + w16 * LX, LX, Hs, LB);     // x dh_out
  if constexpr (SPLIT) {
    mma<T, PW / 8, NW, false, false>(dxdt, Bo + w16 * LB, LB, Hl, LB);
    mma<T, NW / 8, PW, false, true>(db, xo + w16 * LX, LX, Hl, LB);
  }
#pragma unroll
  for (int t = 0; t < PW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = w16 + frag_row(e);
      dxdt[t][e] *= expf(tot - cs_o[rr]);  // u
      wj[e >> 1] += to_f32(xo[rr * LX + frag_col(t, e)]) * dt_o[rr] * dxdt[t][e];
    }
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = w16 + frag_row(e);
      db[t][e] *= dt_o[rr] * expf(tot - cs_o[rr]);  // xdt dh_out e^(tot - cs)
    }

  T* S1w = S1 + w16 * LS;
  T* S2w = S2 + w16 * LS;
  for (int it = tile; it < nt; ++it) {
    const int i0 = it * TJ;
    __syncthreads();  // the states and the last tile are read
    const int rows = rows_in(g, c, i0);
    load_tile<TJ, NW, 128>(L1, LB, row4<T>(g.Cm, g.sc, b, p0 + i0, grp), g.sc[1], g.sc[3], rows,
                           g.N);
    load_tile<TJ, PW, 128>(L2, LX, row4<T>(g.dy, g.sdy, b, p0 + i0, h), g.sdy[1], g.sdy[3], rows,
                           g.P);
    for (int r = threadIdx.x; r < TJ; r += blockDim.x) cs_l[r] = i0 + r < g.Q ? csw[i0 + r] : tot;
    __syncthreads();
    float st[TJ / 8][4];
    float ds[TJ / 8][4];
    zero(st);
    zero(ds);
    mma<T, TJ / 8, NW, false, false>(st, Bo + w16 * LB, LB, L1, LB);  // (C B^T)^T
    mma<T, TJ / 8, PW, false, false>(ds, xo + w16 * LX, LX, L2, LX);  // (dy x^T)^T
#pragma unroll
    for (int t = 0; t < TJ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = w16 + frag_row(e);
        const int ci = frag_col(t, e);
        const float lm = i0 + ci >= r0 + rr ? expf(cs_l[ci] - cs_o[rr]) : 0.0f;
        const float sc = st[t][e] * lm;
        const float dsc = ds[t][e] * dt_o[rr];  // (dy xdt^T)^T
        colm[e >> 1] += dsc * sc;
        S1w[frag_row(e) * LS + ci] = from_f32<T>(sc);
        S2w[frag_row(e) * LS + ci] = from_f32<T>(dsc * lm);
      }
    __syncwarp();
    mma<T, PW / 8, TJ, false, true>(dxdt, S1w, LS, L2, LX);
    mma<T, NW / 8, TJ, false, true>(db, S2w, LS, L1, LB);
  }
  float ddt_x[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < PW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = w16 + frag_row(e);
      const int p = frag_col(t, e);
      ddt_x[e >> 1] += dxdt[t][e] * to_f32(xo[rr * LX + p]);
      if (rr < own && p < g.P)
        static_cast<T*>(g.dx)[((static_cast<long long>(b) * g.S + p0 + r0 + rr) * g.H + h) * g.P +
                              p] = from_f32<T>(dxdt[t][e] * dt_o[rr]);
    }
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = w16 + frag_row(e);
      const int n = frag_col(t, e);
      if (rr < own && n < g.N)
        g.dbh[((static_cast<long long>(b) * g.S + p0 + r0 + rr) * g.H + h) * g.N + n] = db[t][e];
    }
  float dcs[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    ddt_x[half] = quad_sum(ddt_x[half]);
    wj[half] = quad_sum(wj[half]);
    dcs[half] = -quad_sum(colm[half]) - wj[half];
    const int rr = w16 + (lane >> 2) + 8 * half;
    if ((lane & 3) == 0 && rr < own)
      g.ddt[(static_cast<long long>(b) * g.S + p0 + r0 + rr) * g.H + h] = ddt_x[half];
  }

  // ---- the tile's rows as queries i: dC from h_in and every tile j <= it
  __syncthreads();  // every warp is done with the loop's tiles
  load_tile<PW, NW, 128>(Hs, LB, g.sf + bhc * g.P * g.N, g.N, 1, g.P, g.N,
                         SPLIT ? Hl : nullptr);  // h_in
  __syncthreads();
  float dc[NW / 8][4];
  zero(dc);
  mma<T, NW / 8, PW, false, true>(dc, Do + w16 * LX, LX, Hs, LB);  // dy h_in
  if constexpr (SPLIT) mma<T, NW / 8, PW, false, true>(dc, Do + w16 * LX, LX, Hl, LB);
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[t][e] *= expf(cs_o[w16 + frag_row(e)]);
  float rowm[2] = {0.0f, 0.0f};
  {
    float ys[PW / 8][4];
    zero(ys);
    mma<T, PW / 8, NW, false, false>(ys, Co + w16 * LB, LB, Hs, LB);  // C h_in^T
    if constexpr (SPLIT) mma<T, PW / 8, NW, false, false>(ys, Co + w16 * LB, LB, Hl, LB);
#pragma unroll
    for (int t = 0; t < PW / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = w16 + frag_row(e);
        rowm[e >> 1] += to_f32(Do[rr * LX + frag_col(t, e)]) * ys[t][e] * expf(cs_o[rr]);
      }
  }
  for (int jt = 0; jt <= tile; ++jt) {
    const int j0 = jt * TJ;
    __syncthreads();  // h_in and the last tile are read
    const int rows = rows_in(g, c, j0);
    load_tile<TJ, NW, 128>(L1, LB, row4<T>(g.Bm, g.sb_, b, p0 + j0, grp), g.sb_[1], g.sb_[3],
                           rows, g.N);
    load_tile<TJ, PW, 128>(L2, LX, row4<T>(g.x, g.sx, b, p0 + j0, h), g.sx[1], g.sx[3], rows,
                           g.P);
    for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
      cs_l[r] = j0 + r < g.Q ? csw[j0 + r] : tot;
      dt_l[r] = r < rows ? dt_at(g, b, p0 + j0 + r, h) : 0.0f;
    }
    __syncthreads();
    float s[TJ / 8][4];
    float ds[TJ / 8][4];
    zero(s);
    zero(ds);
    mma<T, TJ / 8, NW, false, false>(s, Co + w16 * LB, LB, L1, LB);  // C B^T
    mma<T, TJ / 8, PW, false, false>(ds, Do + w16 * LX, LX, L2, LX);  // dy x^T
#pragma unroll
    for (int t = 0; t < TJ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = w16 + frag_row(e);
        const int cj = frag_col(t, e);
        const float lm = j0 + cj <= r0 + rr ? expf(cs_o[rr] - cs_l[cj]) : 0.0f;
        const float dsc = ds[t][e] * dt_l[cj];  // dy xdt^T
        rowm[e >> 1] += dsc * s[t][e] * lm;
        S2w[frag_row(e) * LS + cj] = from_f32<T>(dsc * lm);
      }
    __syncwarp();
    mma<T, NW / 8, TJ, false, true>(dc, S2w, LS, L1, LB);
  }
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = w16 + frag_row(e);
      const int n = frag_col(t, e);
      if (rr < own && n < g.N)
        g.dch[((static_cast<long long>(b) * g.S + p0 + r0 + rr) * g.H + h) * g.N + n] = dc[t][e];
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float total = dcs[half] + quad_sum(rowm[half]);
    const int rr = w16 + (lane >> 2) + 8 * half;
    if ((lane & 3) == 0 && r0 + rr < g.Q) {
      g.dcs[bhc * g.Q + r0 + rr] = total;
      g.w[bhc * g.Q + r0 + rr] = wj[half];
    }
  }
}

__global__ void __launch_bounds__(256) ssd_bwd_finish(Args g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* v = reinterpret_cast<float*>(smem_raw);
  float* tmp = v + g.Q;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bhc = (static_cast<long long>(b) * g.H + h) * g.nc + c;
  const int p0 = c * g.Q;
  const float tot = g.cs[bhc * g.Q + g.Q - 1];
  float wpart = 0.0f;
  for (int l = threadIdx.x; l < g.Q; l += blockDim.x) {
    v[l] = g.dcs[bhc * g.Q + l];
    wpart += g.w[bhc * g.Q + l];
  }
  const float wsum = block_sum(wpart, tmp);
  const int pn = g.P * g.N;
  float dpart = 0.0f;
  for (int e = threadIdx.x; e < pn; e += blockDim.x)
    dpart += g.sf[bhc * pn + e] * g.sb[bhc * pn + e];
  const float dtot = expf(tot) * block_sum(dpart, tmp) + wsum;
  block_scan(v, g.Q, true, tmp);
  const float a = g.A[h];
  float apart = 0.0f;
  for (int l = threadIdx.x; l < g.Q && p0 + l < g.S; l += blockDim.x) {
    const float dda = v[l] + dtot;
    g.ddt[(static_cast<long long>(b) * g.S + p0 + l) * g.H + h] += dda * a;
    apart += dda * dt_at(g, b, p0 + l, h);
  }
  const float asum = block_sum(apart, tmp);
  if (threadIdx.x == 0) g.dap[(static_cast<long long>(b) * g.nc + c) * g.H + h] = asum;
}

template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_reduce(Args g, int blocks) {
  const long long total = static_cast<long long>(g.B) * g.S * g.G * g.N;
  if (static_cast<int>(blockIdx.x) < 2 * blocks) {
    const bool isc = static_cast<int>(blockIdx.x) >= blocks;
    const long long idx =
        static_cast<long long>(blockIdx.x - (isc ? blocks : 0)) * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int n = idx % g.N;
    const long long r = idx / g.N;
    const int gi = r % g.G;
    const long long bs = r / g.G;
    const int hg = g.H / g.G;
    const float* src = (isc ? g.dch : g.dbh) + (bs * g.H + gi * hg) * g.N + n;
    float sum = 0.0f;
    for (int k = 0; k < hg; ++k) sum += src[k * g.N];
    static_cast<T*>(isc ? g.dC : g.dB)[idx] = from_f32<T>(sum);
  } else {
    for (int h = threadIdx.x; h < g.H; h += blockDim.x) {
      float sum = 0.0f;
      for (int bc = 0; bc < g.B * g.nc; ++bc) sum += g.dap[static_cast<long long>(bc) * g.H + h];
      g.dA[h] = sum;
    }
  }
}

template <typename T, int NW>
int launch(Args& g, cudaStream_t s) {
  constexpr int LX = PW + PAD<T>, LB = NW + PAD<T>;
  const int states_bytes = ((sizeof(T) == 2 ? 4 : 2) * TJ * LX + 2 * TJ * LB) *
                               static_cast<int>(sizeof(T)) +
                           (2 * TJ + g.Q + 256) * 4;
  constexpr int chunk_bytes = chunk_smem<T, NW>();
  static_assert(chunk_bytes <= MAX_SMEM, "the chunk kernel's tiles exceed shared memory");
  const int finish_bytes = (g.Q + 256) * 4;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states<T, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         states_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk<T, NW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states<T, NW><<<dim3(g.nc, g.H, g.B), 256, states_bytes, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pass<<<dim3((g.P * g.N + 256 * PASS_VEC - 1) / (256 * PASS_VEC), g.H, g.B), 256, 0,
                  s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<T, NW><<<g.B * g.H * g.nc * ((g.Q + TJ - 1) / TJ), 128, chunk_bytes, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_finish<<<dim3(g.nc, g.H, g.B), 256, finish_bytes, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(g.B) * g.S * g.G * g.N;
  const int blocks = static_cast<int>((total + 255) / 256);
  ssd_bwd_reduce<T><<<2 * blocks + 1, 256, 0, s>>>(g, blocks);
  return static_cast<int>(cudaGetLastError());
}

// the workspace's floats in Args's order: cs, dcs, w, sf, sb, dbh, dch, dap
void carve(float* ws, Args& g) {
  const long long bh = static_cast<long long>(g.B) * g.H;
  const long long pos = bh * g.nc * g.Q;
  const long long state = bh * g.nc * g.P * g.N;
  const long long head = static_cast<long long>(g.B) * g.S * g.H * g.N;
  g.cs = ws;
  g.dcs = g.cs + pos;
  g.w = g.dcs + pos;
  g.sf = g.w + pos;
  g.sb = g.sf + state;
  g.dbh = g.sb + state;
  g.dch = g.dbh + head;
  g.dap = g.dch + head;
}

}  // namespace

// the fp32 workspace (floats) a backward of this shape takes
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P, int N, int Q) {
  const long long nc = (S + Q - 1) / Q;
  const long long bh = static_cast<long long>(B) * H;
  return 3 * bh * nc * Q + 2 * bh * nc * P * N + 2LL * B * S * H * N + B * nc * H;
}

// dtype: 0 fp32, 1 bf16. strides: 19 element strides: x (4), dt (3), B (4),
// C (4), dy (4). dstate: contiguous (B, H, P, N) fp32, or null for none.
// dx (B, S, H, P), ddt (B, S, H), dB and dC (B, S, G, N) contiguous, dA (H,);
// ws: ssd_scan_bwd_workspace floats. Five launches on `stream`. Returns a
// CUDA error code (0 when every launch was accepted).
extern "C" int ssd_scan_bwd_launch(int dtype, const void* x, const void* dt, const void* A,
                                   const void* Bm, const void* Cm, const void* dy,
                                   const void* dstate, void* dx, void* ddt, void* dA, void* dB,
                                   void* dC, void* ws, int B, int S, int H, int G, int P, int N,
                                   int Q, const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > PW || N <= 0 ||
      N > MAX_N || Q <= 0 || Q > MAX_Q)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{};
  g.x = x;
  g.dt = static_cast<const float*>(dt);
  g.A = static_cast<const float*>(A);
  g.Bm = Bm;
  g.Cm = Cm;
  g.dy = dy;
  g.dstate = static_cast<const float*>(dstate);
  g.dx = dx;
  g.ddt = static_cast<float*>(ddt);
  g.dA = static_cast<float*>(dA);
  g.dB = dB;
  g.dC = dC;
  g.B = B;
  g.S = S;
  g.H = H;
  g.G = G;
  g.P = P;
  g.N = N;
  g.Q = Q;
  g.nc = (S + Q - 1) / Q;
  for (int i = 0; i < 4; ++i) {
    g.sx[i] = strides[i];
    g.sb_[i] = strides[7 + i];
    g.sc[i] = strides[11 + i];
    g.sdy[i] = strides[15 + i];
  }
  for (int i = 0; i < 3; ++i) g.sdt[i] = strides[4 + i];
  carve(static_cast<float*>(ws), g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N > 64;
  if (dtype == 0) return wide ? launch<float, 128>(g, s) : launch<float, 64>(g, s);
  if (dtype == 1) return wide ? launch<bf16, 128>(g, s) : launch<bf16, 64>(g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
