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
//   dcs = rowsum(M) - colsum(M) + e^cs rowsum(C o (dy h_in)) - w, with
//   M = (dy xdt^T) o (C B^T) o L and w_j = xdt_j . (e^(tot - cs_j) dh_out B_j);
//   dtot = e^tot <h_in, dh_out> + sum_j w_j; d(dt A) = reverse cumsum of
//   dcs, plus dtot; dt's gradient d(dt A) A + rowsum(dxdt o x), A's the sum
//   of d(dt A) dt, dx = dxdt dt; B's and C's gradients summed over each
//   group's heads. Padded tail positions (dt = 0, zeros) add nothing.
//   (rowsum(C o (dy h_in)) is the plain form's rowsum(dy o (C h_in^T)); the
//   bf16 body takes it so, since dy h_in is taken for dC anyway, and the
//   fp32 body in the plain form.)
//
// What bounds it on an H100: at mamba2-370m's training shape (B 8, S 1024,
// H 32, P 64, G 1, N 128, Q 256, bf16) the plain backward's products need
// 60 GFLOP under the causal mask against about 111 MB of inputs and
// outputs: bound by operations, 0.061 ms at 989 TFLOP/s (chip_smoke.py's
// ssd_bwd_bound_parts_ms computes both). The five launches this replaced
// (mma.sync on plain strided loads; each tile pair's scores taken twice;
// dB and dC per head through fp32 workspaces, 339 MB there) took 1.41 ms.
//
// Three launches, no atomics, every sum in a fixed order, so two calls give
// bitwise the same gradients:
//   ssd_bwd_states  one CTA a (batch, head). One group of warps walks the
//     chunks forwards: h_in(c) = carry, then carry = carry e^tot + Sf(c);
//     the other walks them backwards from dstate: dh_out(c) = carry, then
//     carry = carry e^tot + Sb(c) (bf16; fp32 takes Sb of each chunk in the
//     forward walk, keeps it raw in dh_out's slot and walks back over the
//     slots). The state pass is the carry in registers: no launch of its
//     own. Each chunk's cumsum is taken in fp64 and kept as fp32 hi + lo
//     parts, written with dt as one float4 a position for the others. The
//     slots hold each state as the chunk launch reads it: bf16 hi and lo
//     parts, pre-swizzled into 64-column panels (bf16), or fp32 rows.
//   ssd_bwd_chunk   one CTA an item: (batch, group, chunk, 64-position tile
//     t, slice of the group's heads), looping over the slice's heads: the
//     query role of tile t (dC of its rows: the state term, then every key
//     tile j <= t) and the key role of tile t (dxdt and dB of its rows: the
//     state terms, then every query tile i >= t), so every item walks the
//     chunk's tiles once plus one. dC and dB are summed over the slice's
//     heads in registers, in head order, and written once: straight into
//     the output with one slice, else as fp32 partials per slice (no (B, S,
//     H, N) buffer). dx, dt's x part and the cumsum's cotangent parts (fp64)
//     per head and position; the first tile's items also take <h_in,
//     dh_out> (fp64, one partial a warp).
//   ssd_bwd_finish  one CTA a head, a warp a (batch, chunk) at a time: dtot
//     = e^tot <h_in, dh_out> + sum w, the reverse cumsum (fp64, rows of 32
//     positions by shuffles), dt's gradient completed, A's summed over
//     batches and chunks in a fixed order; more CTAs sum the slices' dB and
//     dC partials in slice order.
// ssd_scan.py's bwd_plan picks the slices: of the divisors of a group's
// heads, the one whose items finish in the fewest waves of a head's work,
// the fewest on a tie (1 at the training shape, whose 128 items fill the
// card; zamba2's 112 heads 8). The workspace there is 77.6 MB, 67 MB of it
// the per-chunk states.
//
// Two bodies of the states and chunk launches, chosen by the type:
//   bf16: warp-specialised on wgmma fed by TMA (as flash_attention_bwd.cu):
//     384 threads, warpgroups 0 and 1 compute, warpgroup 2 loads (setmaxnreg
//     24 / 240), one thread of it a stream. x, B, C and dy come through 4-d
//     TMA maps over their (batch, position, head or group) strides as
//     64-position tiles in the 128-byte swizzle, the states and each tile's
//     float4s by bulk copies, into buffers and rings guarded by full / empty
//     mbarrier pairs. States: A = (x dt e^(tot - cs))^T or (dy e^cs)^T from
//     ldmatrix.trans of the tile, scaled and split into bf16 hi and lo
//     fragments in registers, against B or C MN-major; the states go out as
//     16-byte chunks, gathered across each quad of lanes by shuffles (as
//     4-byte stores they took 4 us of each chunk's walk). Chunk:
//     warpgroup 0 is the query role, 1 the key role; the scores C B^T and
//     dS' = dy x^T (m64n64, both operands K-major) are masked and scaled in
//     registers and go straight into A fragments of dC += (dS' o L dt) B,
//     dxdt += ((C B^T) o L)^T dy and dB += (dS' o L)^T C (B operand
//     MN-major); the state terms read the states' hi and lo parts as B,
//     K-major (B dh_out^T) or MN-major (dy h_in, x dh_out). Off the diagonal
//     L is a row factor (per head) times a column factor, e^(cs_i - cs_j) =
//     e^(cs_i - cs_a) e^(cs_a - cs_j) from an anchor between the tiles, both
//     at most 1; the diagonal tile takes each decay, masked, in a branch of
//     its own (a select an element took every decay's exponential). A
//     role's state buffer goes back to its loader as soon as its state
//     products are done, so the next head's state loads under this head's
//     tile pairs. Ring stages: 2 at N 128 (the CTA takes 215 KB), 4 at N <=
//     64.
//   fp32: FMAs on warp_tiles.cuh's fragments (no TF32: fp32 stays fp32),
//     plain strided loads. States: 8 warps, 4 on Sf and 4 on Sb. Chunk: 4
//     warps of 16 rows, the key role over the slice's heads, then the query
//     role over them again.
// Each tile pair's scores C B^T and dS' are computed twice, once by the
// query role of i and once by the key role of j: seven Q x Q products where
// the plain backward takes five. Taking them once would need one CTA to
// hold, across the heads it sums, dC for every query tile of the chunk
// beside dB for every key tile: at Q 256, N 128 that is 256 KB of fp32
// sums, more than the SM's 227 KB of shared memory, before any tile.
// scripts/ssd_bwd_variants.py times the recompute's price and the slices.
//
// Precision: dA sums terms that cancel, so in bf16 what feeds the cumsum's
// cotangent keeps fp32 accuracy: dy xdt^T is taken as (dy x^T) dt on the
// exact bf16 x, and the scaled chunk terms of Sf and Sb and the states h_in
// and dh_out enter their products as bf16 hi and lo parts (two products,
// about 16 bits); only the operands of dx's, dB's and dC's Q x Q products
// (the masked scores) are rounded to bf16. The chunk's cumsum is taken in
// fp64 and kept as fp32 hi and lo parts, and every decay e^(cs_i - cs_j) is
// taken from the parts' differences (`decay`; the bf16 bodies through
// ex2.approx, `decay2`): at a chunk of 4096 positions cs reaches the
// thousands, where one fp32 value holds it to 1e-4. The cumsum's cotangent
// (rowsum(M) - colsum(M) - w, which cancels), its reverse scan, dtot and
// A's gradient are summed and kept in fp64; the bf16 chunk body sums a
// lane's 16 terms of one tile pair in fp32 before adding them to the fp64
// sums (one conversion a tile pair, not one a term), the fp32 body every
// term in fp64.
//
// What sets its pace now (scripts/ssd_bwd_variants.py, PERF.md): the chunk
// launch's key role of the first tiles, four tile pairs a head, each a chain
// that waits on itself: the scores' products, the mask and scale in
// registers, the products they feed; the query role waits on it for the
// first tiles' <h_in, dh_out>. Every mbarrier wait traps after about 2 s
// (hopper.cuh) instead of spinning on a fault of the protocol.
#include <cstdint>
#include <type_traits>

#include "warp_tiles.cuh"

namespace {

using namespace tiles;
constexpr int TJ = 64;           // positions of a tile
constexpr int PW = 64;           // head_dim as the kernels pad it (P <= 64)
constexpr int MAX_N = 128;
constexpr int MAX_Q = 4096;
constexpr int MAX_SMEM = 232448;
constexpr int PANEL = 64 * 128;  // bytes of a bf16 panel: 64 rows of 64 columns
constexpr int FIN_THREADS = 1024;
// the warp-specialised bodies: warpgroups 0 and 1 compute, warpgroup 2
// loads (setmaxnreg gives its registers to the others: 128 x 24 + 256 x 240
// <= 65536), one thread of it for each consumer's stream
constexpr int WG_THREADS = 384;
constexpr int LOADER = 256;  // the first loading thread; LOADER + 32 the second
constexpr int LOADER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

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
  // workspace: vec (B, H, nc, Qp) float4s (cs, its lo part, dt, 0); the
  // states, two slots of 64 NW fp32-sized elements a (batch, head, chunk):
  // h_in, then dh_out; the cumsum cotangent's parts dcq (query role) and
  // dck (key role) and w, fp64 (B, H, nc, Qp); <h_in, dh_out>'s four warp
  // partials, fp64 (B, H, nc, 4); dB's then dC's partial sums, fp32
  // (slices, B, S, G, N) each, with more than one slice
  float4* vec;
  uint8_t* st;
  double *dcq, *dck, *w, *hdp;
  float* part;
  int B, S, H, G, P, N, Q, nc, Qp, nt, slices, hs;  // hs: heads a slice
  long long sx[4], sdt[3], sb_[4], sc[4], sdy[4];   // element strides
};

template <int NW>
__host__ __device__ constexpr int slot_bytes() {
  return PW * NW * 4;
}

__device__ __forceinline__ long long bhc_of(const Args& g, int b, int h, int c) {
  return (static_cast<long long>(b) * g.H + h) * g.nc + c;
}

template <int NW>
__device__ __forceinline__ uint8_t* slot(const Args& g, long long bhc, int which) {
  return g.st + (bhc * 2 + which) * slot_bytes<NW>();
}

// e^((a + al) - (b + bl)) for cumsums held as hi + lo parts: the hi parts'
// difference is exact where they are close, as a decay's are, so the decay
// keeps fp32 accuracy however large the cumsums
__device__ __forceinline__ float decay(float a, float al, float b, float bl) {
  return expf((a - b) + (al - bl));
}

// the same through ex2.approx (relative error about 2^-22), for the bf16
// bodies, whose masked scores are rounded to 8 bits
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float decay2(float a, float al, float b, float bl) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(((a - b) + (al - bl)) * LOG2E));
  return y;
}

__device__ __forceinline__ float dt_at(const Args& g, int b, long long pos, int h) {
  return g.dt[b * g.sdt[0] + pos * g.sdt[1] + h * g.sdt[2]];
}

template <typename T>
__device__ __forceinline__ const T* row4(const void* base, const long long* st, int b,
                                         long long pos, int head) {
  return static_cast<const T*>(base) + b * st[0] + pos * st[1] + head * st[2];
}

// the chunk's positions [r0, r0 + TJ) that hold data: inside the chunk and
// before S (may be <= 0)
__device__ __forceinline__ int rows_in(const Args& g, int c, int r0) {
  return min(TJ, min(g.Q - r0, g.S - c * g.Q - r0));
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v[0 .. n) replaced by its inclusive prefix sums by a group of NT threads
// (k its index in the group, `bar` a named barrier of the group), in a fixed
// order: a serial run per thread over a contiguous stretch, then the runs'
// scan by warp shuffles and the warps' totals. The sums are taken in fp64,
// each rounded to fp32 once, and each sum's rounding error goes to lo[i],
// so v[i] + lo[i] holds it to about 48 bits. `tmp` holds NT / 32 doubles.
template <int NT>
__device__ void group_scan(float* v, float* lo, int n, int k, int bar, double* tmp) {
  const int per = (n + NT - 1) / NT;
  const int first = min(n, k * per);
  const int last = min(n, first + per);
  double run = 0.0;
  for (int i = first; i < last; ++i) run += v[i];
  const int lane = k & 31;
  const int warp = k >> 5;
  double inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  double ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.0;
  if (lane == 31) tmp[warp] = inc;
  named_bar(bar, NT);
  double acc = 0.0;
  for (int w = 0; w < warp; ++w) acc += tmp[w];
  acc += ex;
  for (int i = first; i < last; ++i) {
    acc += v[i];
    v[i] = static_cast<float>(acc);
    lo[i] = static_cast<float>(acc - static_cast<double>(v[i]));
  }
  named_bar(bar, NT);
}

// ---- a 64 x NW fp32 value held by a group of four warps (a warpgroup, or
// four warps of the fp32 bodies) as accumulator fragments: warp wq holds
// rows 16 wq .. 16 wq + 15, flat element 4 t + e at row 16 wq + lane / 4 +
// 8 (e / 2) and column 8 t + 2 (lane % 4) + e % 2 (wgmma's layout, and
// warp_tiles.cuh's acc[t][e])

__device__ __forceinline__ int frow(int wq, int e) {
  return 16 * wq + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int fcol(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

// byte offset of element (r, c) of a bf16 tile of 64-row panels of 64
// columns in TMA's 128-byte swizzle (16-byte chunk k of row r at k ^ r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int bb = (c & 63) * 2;
  return static_cast<uint32_t>((c >> 6) * PANEL + r * 128 +
                               ((((bb >> 4) ^ (r & 7)) << 4) | (bb & 15)));
}

// bf16 hi and lo of two floats, each as a bf16x2 register (first in the low
// half): hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// fp32 rows of 64 x NW
template <int NW>
__device__ __forceinline__ void store_raw(uint8_t* s, const float* v, int wq) {
  float* f = reinterpret_cast<float*>(s);
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2)
    *reinterpret_cast<float2*>(f + frow(wq, i) * NW + fcol(i)) = make_float2(v[i], v[i + 1]);
}
template <int NW>
__device__ __forceinline__ void load_raw(const uint8_t* s, float* v, int wq) {
  const float* f = reinterpret_cast<const float*>(s);
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2) {
    const float2 u = *reinterpret_cast<const float2*>(f + frow(wq, i) * NW + fcol(i));
    v[i] = u.x;
    v[i + 1] = u.y;
  }
}

// a quad's four lanes each hold one bf16 pair (columns 2 tig, + 1) of four
// 8-column blocks (mine[q]: block q); returns the four pairs of block tig
// (from lanes 0 .. 3), one 16-byte chunk, after three xor shuffles. Selects,
// not a register array indexed by the lane, which would go to local memory.
__device__ __forceinline__ uint4 quad_gather(const uint32_t (&mine)[4], int tig) {
  auto pick = [&](int q) {
    return q == 0 ? mine[0] : q == 1 ? mine[1] : q == 2 ? mine[2] : mine[3];
  };
  uint32_t g0 = pick(tig), g1 = g0, g2 = g0, g3 = g0;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const int src = tig ^ j;  // the partner, which gathers block src
    const uint32_t r = __shfl_xor_sync(0xffffffffu, pick(src), j);
    g0 = src == 0 ? r : g0;
    g1 = src == 1 ? r : g1;
    g2 = src == 2 ? r : g2;
    g3 = src == 3 ? r : g3;
  }
  return make_uint4(g0, g1, g2, g3);
}

// a state in its slot as the chunk launch reads it: bf16 hi and lo parts,
// each NW / 64 swizzled panels (bf16), or fp32 rows (fp32). bf16: a lane
// holds two columns of each 8-column block of its rows; the four lanes of a
// quad trade pairs (three xor shuffles a group of four blocks) so that each
// stores one block of a row as one 16-byte chunk, not four 4-byte stores.
template <typename T, int NW>
__device__ __forceinline__ void store_state(uint8_t* s, const float* v, int wq) {
  if constexpr (sizeof(T) == 4) {
    store_raw<NW>(s, v, wq);
  } else {
    const int tig = threadIdx.x & 3;
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int t0 = 0; t0 < NW / 8; t0 += 4) {
          uint32_t mine[4];  // this lane's pair of blocks t0 .. t0 + 3
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t hi, lo;
            split_bf16(v[4 * (t0 + q) + 2 * half], v[4 * (t0 + q) + 2 * half + 1], hi, lo);
            mine[q] = part == 0 ? hi : lo;
          }
          const int row = frow(wq, 2 * half);
          *reinterpret_cast<uint4*>(s + part * (NW / 64) * PANEL + swz(row, 8 * (t0 + tig))) =
              quad_gather(mine, tig);
        }
  }
}
// The fp32 body's Sb warps' backward walk over the chunks of (b, h), after
// the forward walk left Sb(c) raw in each chunk's dh_out slot: dh_out(c) =
// carry from dstate, written over it; carry = carry e^tot(c) + Sb(c). Each
// thread rewrites the elements it reads.
template <int NW>
__device__ void reverse_pass(const Args& g, int b, int h, int wq) {
  float carry[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int r = frow(wq, i);
    const int c = fcol(i);
    carry[i] = g.dstate != nullptr && r < g.P && c < g.N
                   ? g.dstate[((static_cast<long long>(b) * g.H + h) * g.P + r) * g.N + c]
                   : 0.0f;
  }
  for (int c = g.nc - 1; c >= 0; --c) {
    const long long bhc = bhc_of(g, b, h, c);
    float raw[NW / 2];
    load_raw<NW>(slot<NW>(g, bhc, 1), raw, wq);
    store_raw<NW>(slot<NW>(g, bhc, 1), carry, wq);
    const float4 tv = g.vec[bhc * g.Qp + g.Q - 1];
    const float e = decay(tv.x, tv.y, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) carry[i] = carry[i] * e + raw[i];
  }
}

// the chunk's dt into dtv, its cumsum of dt A as csh + csl and, with
// `write`, each position's float4 into the workspace, by the group of NT
// threads (k its index, `bar` its named barrier); positions past Q (up to
// Qp) and past S hold dt 0
template <int NT>
__device__ void chunk_cumsum(const Args& g, int b, int h, int c, float a, float* dtv, float* csh,
                             float* csl, double* tmp, int k, int bar, bool write = true) {
  named_bar(bar, NT);  // the last chunk's readers are done
  const long long p0 = static_cast<long long>(c) * g.Q;
  for (int l = k; l < g.Qp; l += NT) {
    const float d = l < g.Q && p0 + l < g.S ? dt_at(g, b, p0 + l, h) : 0.0f;
    dtv[l] = d;
    csh[l] = d * a;
  }
  named_bar(bar, NT);
  group_scan<NT>(csh, csl, g.Qp, k, bar, tmp);
  if (!write) return;
  const long long at = bhc_of(g, b, h, c) * g.Qp;
  for (int l = k; l < g.Qp; l += NT) g.vec[at + l] = make_float4(csh[l], csl[l], dtv[l], 0.0f);
}

// ---------------------------------------------------------------- fp32 bodies

// x and dy tiles, B and C tiles, two row factors, dt, cs and its lo parts
// over Qp, the scan's 8 doubles
template <int NW>
constexpr int states_f32_smem(int qp) {
  return (2 * TJ * (PW + 4) + 2 * TJ * (NW + 4)) * 4 + 2 * TJ * 4 + 3 * qp * 4 + 8 * 8;
}

template <int NW>
__global__ void __launch_bounds__(256) ssd_bwd_states_f32(const __grid_constant__ Args g) {
  constexpr int LX = PW + 4;
  constexpr int LB = NW + 4;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);  // x dt e^(tot - cs)
  float* Ys = Xs + TJ * LX;                        // dy e^cs
  float* Bs = Ys + TJ * LX;
  float* Cs = Bs + TJ * LB;
  float* fx = Cs + TJ * LB;  // a tile's row factors
  float* fy = fx + TJ;
  float* dtv = fy + TJ;
  float* csh = dtv + g.Qp;
  float* csl = csh + g.Qp;
  double* tmp = reinterpret_cast<double*>(csl + g.Qp);  // 8-byte aligned: Qp a multiple of 64

  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int grp = h / (g.H / g.G);
  const float a = g.A[h];
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3;
  const bool fwd = warp < 4;  // warps 0-3: Sf; 4-7: Sb
  float carry[NW / 8][4];
  zero(carry);
  for (int c = 0; c < g.nc; ++c) {
    chunk_cumsum<256>(g, b, h, c, a, dtv, csh, csl, tmp, threadIdx.x, 1);
    const float tot = csh[g.Q - 1], tot_l = csl[g.Q - 1];
    const long long p0 = static_cast<long long>(c) * g.Q;
    float acc[NW / 8][4];
    zero(acc);
    for (int j0 = 0; j0 < g.Q; j0 += TJ) {
      __syncthreads();
      const int rows = rows_in(g, c, j0);
      load_tile<TJ, PW, 256>(Xs, LX, row4<float>(g.x, g.sx, b, p0 + j0, h), g.sx[1], g.sx[3],
                             rows, g.P);
      load_tile<TJ, PW, 256>(Ys, LX, row4<float>(g.dy, g.sdy, b, p0 + j0, h), g.sdy[1],
                             g.sdy[3], rows, g.P);
      load_tile<TJ, NW, 256>(Bs, LB, row4<float>(g.Bm, g.sb_, b, p0 + j0, grp), g.sb_[1],
                             g.sb_[3], rows, g.N);
      load_tile<TJ, NW, 256>(Cs, LB, row4<float>(g.Cm, g.sc, b, p0 + j0, grp), g.sc[1], g.sc[3],
                             rows, g.N);
      for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
        const int l = j0 + r;
        fx[r] = r < rows ? dtv[l] * decay(tot, tot_l, csh[l], csl[l]) : 0.0f;
        fy[r] = r < rows ? decay(csh[l], csl[l], 0.0f, 0.0f) : 0.0f;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < TJ * PW; idx += blockDim.x) {
        const int at = idx / PW * LX + idx % PW;
        Xs[at] *= fx[idx / PW];
        Ys[at] *= fy[idx / PW];
      }
      __syncthreads();
      mma<float, NW / 8, TJ, true, true>(acc, (fwd ? Xs : Ys) + 16 * wr, LX, fwd ? Bs : Cs, LB);
    }
    const long long bhc = bhc_of(g, b, h, c);
    if (fwd) {
      store_state<float, NW>(slot<NW>(g, bhc, 0), &carry[0][0], wr);
      const float e = decay(tot, tot_l, 0.0f, 0.0f);
#pragma unroll
      for (int t = 0; t < NW / 8; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) carry[t][q] = carry[t][q] * e + acc[t][q];
    } else {
      store_raw<NW>(slot<NW>(g, bhc, 1), &acc[0][0], wr);
    }
  }
  __threadfence_block();
  __syncthreads();  // h_in, the raw Sb and the float4s are written
  if (!fwd) reverse_pass<NW>(g, b, h, wr);
}

template <int NW>
constexpr int chunk_f32_smem() {
  constexpr int LX = PW + 4, LB = NW + 4, LS = TJ + 4;
  constexpr int own = 2 * TJ * LB + 2 * TJ * LX;
  constexpr int loop = TJ * LB + TJ * LX + 2 * TJ * LS;
  constexpr int states = PW * LB;
  return (own + (loop > states ? loop : states)) * 4 + 6 * TJ * 4;
}

// the item of blockIdx.x: (batch, group, chunk, slice, tile), the tile
// fastest, so a chunk's items are neighbours in the grid and read each
// other's rows from L2
struct Item {
  int b, grp, c, t, h0, nh;
};
__device__ __forceinline__ Item item_of(const Args& g) {
  Item it;
  long long r = blockIdx.x;
  it.t = static_cast<int>(r % g.nt);
  r /= g.nt;
  const int sl = static_cast<int>(r % g.slices);
  r /= g.slices;
  it.c = static_cast<int>(r % g.nc);
  r /= g.nc;
  it.grp = static_cast<int>(r % g.G);
  it.b = static_cast<int>(r / g.G);
  const int hg = g.H / g.G;
  it.h0 = it.grp * hg + sl * g.hs;
  it.nh = min(g.hs, hg - sl * g.hs);
  return it;
}

// dB or dC of an item's 64 rows (summed over its heads): into the output
// (one slice) or its slice's fp32 partial
template <typename T, int NW>
__device__ __forceinline__ void store_group_grad(const Args& g, const Item& it, const float* v,
                                                 int wq, int which) {
  const int sl = (it.h0 - it.grp * (g.H / g.G)) / g.hs;
  const long long bsgn = static_cast<long long>(g.B) * g.S * g.G * g.N;
  T* out = static_cast<T*>(which == 0 ? g.dB : g.dC);
  float* part = g.slices > 1 ? g.part + (static_cast<long long>(which) * g.slices + sl) * bsgn
                             : nullptr;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int r = it.t * TJ + frow(wq, i);
    const long long pos = static_cast<long long>(it.c) * g.Q + r;
    const int n = fcol(i);
    if (r >= g.Q || pos >= g.S || n >= g.N) continue;
    const long long at = ((it.b * static_cast<long long>(g.S) + pos) * g.G + it.grp) * g.N + n;
    if (g.slices == 1)
      out[at] = from_f32<T>(v[i]);
    else
      part[at] = v[i];
  }
}

template <int NW>
__global__ void __launch_bounds__(128) ssd_bwd_chunk_f32(const __grid_constant__ Args g) {
  using T = float;
  constexpr int LX = PW + 4;
  constexpr int LB = NW + 4;
  constexpr int LS = TJ + 4;
  constexpr int own_elems = 2 * TJ * LB + 2 * TJ * LX;
  constexpr int loop = TJ * LB + TJ * LX + 2 * TJ * LS;
  constexpr int states = PW * LB;
  constexpr int union_elems = loop > states ? loop : states;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Bo = reinterpret_cast<T*>(smem_raw);  // the item's own tile: B, C, dy, x
  T* Co = Bo + TJ * LB;
  T* Do = Co + TJ * LB;
  T* xo = Do + TJ * LX;
  T* Hs = xo + TJ * LX;  // dh_out or h_in (P x N); or the loop's tiles:
  T* L1 = Hs;            //   C_i or B_j
  T* L2 = L1 + TJ * LB;  //   dy_i or x_j
  T* S1 = L2 + TJ * LX;  //   the scores^T, a warp's 16 rows each
  T* S2 = S1 + TJ * LS;  //   (dy xdt^T) o L, or its transpose
  float* cs_o = reinterpret_cast<float*>(Bo + own_elems + union_elems);
  float* cl_o = cs_o + TJ;  // lo parts
  float* dt_o = cl_o + TJ;
  float* cs_l = dt_o + TJ;
  float* cl_l = cs_l + TJ;
  float* dt_l = cl_l + TJ;

  const Item it = item_of(g);
  const int b = it.b, c = it.c, tile = it.t, grp = it.grp;
  const int r0 = tile * TJ;
  const long long p0 = static_cast<long long>(c) * g.Q;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w16 = 16 * warp;
  const int own = rows_in(g, c, r0);
  const int nt = g.nt;

  load_tile<TJ, NW, 128>(Bo, LB, row4<T>(g.Bm, g.sb_, b, p0 + r0, grp), g.sb_[1], g.sb_[3], own,
                         g.N);
  load_tile<TJ, NW, 128>(Co, LB, row4<T>(g.Cm, g.sc, b, p0 + r0, grp), g.sc[1], g.sc[3], own,
                         g.N);
  // the own rows' and a looped tile's cs, lo parts and dt from the float4s
  auto own_vec = [&](long long bhc) {
    for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
      const float4 v = g.vec[bhc * g.Qp + r0 + r];
      cs_o[r] = v.x;
      cl_o[r] = v.y;
      dt_o[r] = v.z;
    }
  };
  auto loop_vec = [&](long long bhc, int l0) {
    for (int r = threadIdx.x; r < TJ; r += blockDim.x) {
      const float4 v = g.vec[bhc * g.Qp + l0 + r];
      cs_l[r] = v.x;
      cl_l[r] = v.y;
      dt_l[r] = v.z;
    }
  };
  T* S1w = S1 + w16 * LS;
  T* S2w = S2 + w16 * LS;

  // ---- the key role over the slice's heads: dxdt (dx, dt's x part), w,
  // colsum(M), and dB summed over the heads
  float dbs[NW / 8][4];
  zero(dbs);
  for (int k = 0; k < it.nh; ++k) {
    const int h = it.h0 + k;
    const long long bhc = bhc_of(g, b, h, c);
    const float4 tv = g.vec[bhc * g.Qp + g.Q - 1];
    const float tot = tv.x, tot_l = tv.y;
    __syncthreads();  // the last head's tiles are read
    own_vec(bhc);
    load_tile<TJ, PW, 128>(xo, LX, row4<T>(g.x, g.sx, b, p0 + r0, h), g.sx[1], g.sx[3], own,
                           g.P);
    load_tile<PW, NW, 128>(Hs, LB, reinterpret_cast<const float*>(slot<NW>(g, bhc, 1)), NW, 1, PW,
                           NW);  // dh_out
    __syncthreads();
    float dxdt[PW / 8][4];
    float db[NW / 8][4];
    zero(dxdt);
    zero(db);
    double wj[2] = {0.0, 0.0};
    double colm[2] = {0.0, 0.0};
    mma<T, PW / 8, NW, false, false>(dxdt, Bo + w16 * LB, LB, Hs, LB);  // B dh_out^T
    mma<T, NW / 8, PW, false, true>(db, xo + w16 * LX, LX, Hs, LB);     // x dh_out
#pragma unroll
    for (int t = 0; t < PW / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = w16 + frag_row(e);
        dxdt[t][e] *= decay(tot, tot_l, cs_o[rr], cl_o[rr]);  // u
        wj[e >> 1] += to_f32(xo[rr * LX + frag_col(t, e)]) * dt_o[rr] * dxdt[t][e];
      }
#pragma unroll
    for (int t = 0; t < NW / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = w16 + frag_row(e);
        dbs[t][e] += db[t][e] * dt_o[rr] * decay(tot, tot_l, cs_o[rr], cl_o[rr]);
      }
    for (int ti = tile; ti < nt; ++ti) {
      const int i0 = ti * TJ;
      __syncthreads();  // the states and the last tile are read
      const int rows = rows_in(g, c, i0);
      load_tile<TJ, NW, 128>(L1, LB, row4<T>(g.Cm, g.sc, b, p0 + i0, grp), g.sc[1], g.sc[3], rows,
                             g.N);
      load_tile<TJ, PW, 128>(L2, LX, row4<T>(g.dy, g.sdy, b, p0 + i0, h), g.sdy[1], g.sdy[3],
                             rows, g.P);
      loop_vec(bhc, i0);
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
          const float lm = i0 + ci >= r0 + rr ? decay(cs_l[ci], cl_l[ci], cs_o[rr], cl_o[rr])
                                              : 0.0f;
          const float sc = st[t][e] * lm;
          const float dsc = ds[t][e] * dt_o[rr];  // (dy xdt^T)^T
          colm[e >> 1] += dsc * sc;
          S1w[frag_row(e) * LS + ci] = sc;
          S2w[frag_row(e) * LS + ci] = dsc * lm;
        }
      __syncwarp();
      mma<T, PW / 8, TJ, false, true>(dxdt, S1w, LS, L2, LX);
      mma<T, NW / 8, TJ, false, true>(dbs, S2w, LS, L1, LB);
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
          static_cast<T*>(g.dx)[((b * static_cast<long long>(g.S) + p0 + r0 + rr) * g.H + h) *
                                    g.P + p] = dxdt[t][e] * dt_o[rr];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ddt_x[half] = quad_sum(ddt_x[half]);
      const double wsum = quad_sum(wj[half]);
      const double dcs = -quad_sum(colm[half]) - wsum;
      const int rr = w16 + (lane >> 2) + 8 * half;
      if ((lane & 3) == 0) {
        if (rr < own)
          g.ddt[(b * static_cast<long long>(g.S) + p0 + r0 + rr) * g.H + h] = ddt_x[half];
        if (r0 + rr < g.Q) {
          g.dck[bhc * g.Qp + r0 + rr] = dcs;
          g.w[bhc * g.Qp + r0 + rr] = wsum;
        }
      }
    }
  }
  store_group_grad<T, NW>(g, it, &dbs[0][0], warp, 0);

  // ---- the query role over the slice's heads: rowsum(M) with the state
  // term, and dC summed over the heads
  float dcs_acc[NW / 8][4];
  zero(dcs_acc);
  for (int k = 0; k < it.nh; ++k) {
    const int h = it.h0 + k;
    const long long bhc = bhc_of(g, b, h, c);
    __syncthreads();  // the last head's tiles are read
    own_vec(bhc);
    load_tile<TJ, PW, 128>(Do, LX, row4<T>(g.dy, g.sdy, b, p0 + r0, h), g.sdy[1], g.sdy[3], own,
                           g.P);
    load_tile<PW, NW, 128>(Hs, LB, reinterpret_cast<const float*>(slot<NW>(g, bhc, 0)), NW, 1, PW,
                           NW);  // h_in
    if (tile == 0)  // dh_out beside it (over the loop's dy tile and scores), for <h_in, dh_out>
      load_tile<PW, NW, 128>(L2, LB, reinterpret_cast<const float*>(slot<NW>(g, bhc, 1)), NW, 1,
                             PW, NW);
    __syncthreads();
    if (tile == 0) {  // one fp64 partial a warp
      double hd = 0.0;
      for (int idx = threadIdx.x; idx < PW * NW; idx += blockDim.x)
        hd += static_cast<double>(Hs[idx / NW * LB + idx % NW]) * L2[idx / NW * LB + idx % NW];
      hd = warp_sum(hd);
      if (lane == 0) g.hdp[bhc * 4 + warp] = hd;
    }
    double rowm[2] = {0.0, 0.0};
    {
      float dc[NW / 8][4];
      float ys[PW / 8][4];
      zero(dc);
      zero(ys);
      mma<T, NW / 8, PW, false, true>(dc, Do + w16 * LX, LX, Hs, LB);   // dy h_in
      mma<T, PW / 8, NW, false, false>(ys, Co + w16 * LB, LB, Hs, LB);  // C h_in^T
#pragma unroll
      for (int t = 0; t < NW / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = w16 + frag_row(e);
          dcs_acc[t][e] += dc[t][e] * decay(cs_o[rr], cl_o[rr], 0.0f, 0.0f);
        }
#pragma unroll
      for (int t = 0; t < PW / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = w16 + frag_row(e);
          rowm[e >> 1] += to_f32(Do[rr * LX + frag_col(t, e)]) * ys[t][e] *
                          decay(cs_o[rr], cl_o[rr], 0.0f, 0.0f);
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
      loop_vec(bhc, j0);
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
          const float lm = j0 + cj <= r0 + rr ? decay(cs_o[rr], cl_o[rr], cs_l[cj], cl_l[cj])
                                              : 0.0f;
          const float dsc = ds[t][e] * dt_l[cj];  // dy xdt^T
          // M's element as the key role forms it, dsc (s lm), bitwise: the
          // two roles' scores are the same FMAs in the same order, so
          // rowsum(M) - colsum(M) cancels exactly in the reverse cumsum,
          // whose dt-weighted sum, A's gradient, would otherwise take each
          // rounding times a cumsum of dt in the thousands
          rowm[e >> 1] += dsc * (s[t][e] * lm);
          S2w[frag_row(e) * LS + cj] = dsc * lm;
        }
      __syncwarp();
      mma<T, NW / 8, TJ, false, true>(dcs_acc, S2w, LS, L1, LB);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const double total = quad_sum(rowm[half]);
      const int rr = w16 + (lane >> 2) + 8 * half;
      if ((lane & 3) == 0 && r0 + rr < g.Q) g.dcq[bhc * g.Qp + r0 + rr] = total;
    }
  }
  store_group_grad<T, NW>(g, it, &dcs_acc[0][0], warp, 1);
}

// ---------------------------------------------------------------- bf16 bodies

// 1-d bulk copy of `bytes` (a multiple of 16) from device memory, completing
// on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one 64-position tile of a (batch, position, head or group, inner) map
// into dst, panel by panel (64 columns each)
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int panels,
                                         int head, int s0, int b, int rows_first, uint32_t bar) {
  for (int p = 0; p < panels; ++p) {
    if (rows_first)
      tma_load_4d(dst + p * PANEL, map, p * 64, s0, head, b, bar);
    else
      tma_load_4d(dst + p * PANEL, map, p * 64, head, s0, b, bar);
  }
}

// D (+)= A B, m64n64k16: A (64 x 16) K-major and B (16 x 64) MN-major, both in
// shared memory; accumulate 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float (&n64(float* d))[32] {
  return *reinterpret_cast<float(*)[32]>(d);
}

// D (+)= A B^T over K columns (multiple of 16): A and B 64-row tiles, both
// K-major in 64-column panels; issued, not committed. With `acc0` 0 the
// first step overwrites D.
template <int K>
__device__ __forceinline__ void ss_k(float (&d)[32], uint32_t a, uint32_t b, int acc0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss_n64(d, make_desc(a + off, 16, 1024), make_desc(b + off, 16, 1024),
                 kk > 0 || acc0);
  }
}

// D (+)= A B: A a 64 x 64 K-major tile, B 64 rows (the contraction) of NW
// columns in panels, MN-major; issued, not committed
template <int NW>
__device__ __forceinline__ void ss_mn(float* d, uint32_t a, uint32_t b, int acc0) {
#pragma unroll
  for (int pn = 0; pn < NW / 64; ++pn)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64_mn(n64(d + 32 * pn), make_desc(a + kk * 32, 16, 1024),
                      make_desc(b + kk * 16 * 128 + pn * PANEL, PANEL, 1024), kk > 0 || acc0);
}

// D += A B: A 64 x 64 in registers (4 k16 fragments), B 64 rows of NW
// columns in panels, MN-major; issued, not committed
template <int NW>
__device__ __forceinline__ void rs_mn(float* d, const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int pn = 0; pn < NW / 64; ++pn)
      wgmma_rs_n64(n64(d + 32 * pn), a[kt], make_desc(b + kt * 16 * 128 + pn * PANEL, PANEL, 1024));
}

__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

struct Maps {  // 1 where a map's position axis precedes its head axis
  int x, b, c, dy;
};

template <int NW>
struct StatesGeo {
  static constexpr int X = TJ * PW * 2;
  static constexpr int BT = TJ * NW * 2;
  static constexpr int STAGE = X + BT;  // x and B, or dy and C
  static constexpr int MAX_STAGES = 4;
  // a warpgroup's dt, cs and its lo parts over Qp and its scan's 4 doubles
  __host__ __device__ static constexpr int scan_bytes(int qp) { return 3 * qp * 4 + 32; }
  // each warpgroup's ring stages: as many as fit, at most MAX_STAGES
  __host__ __device__ static constexpr int stages(int qp) {
    return (MAX_SMEM - 1024 - 256 - 2 * scan_bytes(qp)) / (2 * STAGE) < MAX_STAGES
               ? (MAX_SMEM - 1024 - 256 - 2 * scan_bytes(qp)) / (2 * STAGE)
               : MAX_STAGES;
  }
  __host__ __device__ static constexpr int smem(int qp) {
    return 1024 + 2 * stages(qp) * STAGE + 2 * scan_bytes(qp) + 256;
  }
};

// One CTA a (batch, head). Warpgroup 0 walks the chunks forwards: h_in(c) =
// carry, then carry = carry e^tot + Sf(c); warpgroup 1 walks them backwards
// from dstate: dh_out(c) = carry, then carry = carry e^tot + Sb(c). Each
// takes the chunk's cumsum itself (the same scan, so the same values);
// warpgroup 0 writes the float4s.
template <int NW>
__global__ void __launch_bounds__(WG_THREADS, 1)
ssd_bwd_states_wg(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ Args g, const Maps rf) {
  using Gm = StatesGeo<NW>;
  extern __shared__ uint8_t smem_raw[];
  const int ST = Gm::stages(g.Qp);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  const uint32_t ring0 = base;                      // x, B: warpgroup 0's ring
  const uint32_t ring1 = base + ST * Gm::STAGE;     // dy, C: warpgroup 1's
  const uint32_t scans = 2 * ST * Gm::STAGE;        // offsets from base
  const uint32_t bars = base + scans + 2 * Gm::scan_bytes(g.Qp);
  auto full = [&](int w, int s) { return bars + 8 * (2 * w * ST + s); };
  auto empty = [&](int w, int s) { return bars + 8 * (2 * w * ST + ST + s); };

  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int grp = h / (g.H / g.G);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < ST; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);  // one arrival per warp of the warpgroup
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= LOADER) {
    // ---- the loaders: thread LOADER streams x and B in chunk order into
    // warpgroup 0's ring, thread LOADER + 32 dy and C in reverse chunk order
    // into warpgroup 1's
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    if (threadIdx.x == LOADER || threadIdx.x == LOADER + 32) {
      const int w = (threadIdx.x - LOADER) / 32;
      int it = 0;
      for (int cc = 0; cc < g.nc; ++cc) {
        const int c = w == 0 ? cc : g.nc - 1 - cc;
        for (int kt = 0; kt < g.nt; ++kt, ++it) {
          const int s = it % ST;
          mbar_wait(empty(w, s), ((it / ST) & 1) ^ 1);
          mbar_expect(full(w, s), Gm::STAGE);
          const uint32_t at = (w == 0 ? ring0 : ring1) + s * Gm::STAGE;
          const int s0 = c * g.Q + kt * TJ;
          if (w == 0) {
            tma_tile(at, &tx, 1, h, s0, b, rf.x, full(w, s));
            tma_tile(at + Gm::X, &tb, NW / 64, grp, s0, b, rf.b, full(w, s));
          } else {
            tma_tile(at, &tdy, 1, h, s0, b, rf.dy, full(w, s));
            tma_tile(at + Gm::X, &tc, NW / 64, grp, s0, b, rf.c, full(w, s));
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wg;
  const bool fwd = w == 0;
  const int k = threadIdx.x - 128 * wg;  // 0 .. 127 in the warpgroup
  const int wq = k >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int mat = lane >> 3;
  const int rr = lane & 7;
  float* const dtv = reinterpret_cast<float*>(sb + scans + w * Gm::scan_bytes(g.Qp));
  float* const csh = dtv + g.Qp;
  float* const csl = csh + g.Qp;
  double* const tmp = reinterpret_cast<double*>(csl + g.Qp);
  const uint32_t ring = fwd ? ring0 : ring1;
  const float a = g.A[h];
  float carry[NW / 2];
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int r = frow(wq, i);
    const int c = fcol(i);
    carry[i] = !fwd && g.dstate != nullptr && r < g.P && c < g.N
                   ? g.dstate[((static_cast<long long>(b) * g.H + h) * g.P + r) * g.N + c]
                   : 0.0f;
  }
  int it = 0;
  for (int cc = 0; cc < g.nc; ++cc) {
    const int c = fwd ? cc : g.nc - 1 - cc;
    chunk_cumsum<128>(g, b, h, c, a, dtv, csh, csl, tmp, k, 1 + w, fwd);
    const float tot = csh[g.Q - 1], tot_l = csl[g.Q - 1];
    store_state<bf16, NW>(slot<NW>(g, bhc_of(g, b, h, c), fwd ? 0 : 1), carry, wq);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < g.nt; ++kt, ++it) {
      const int s = it % ST;
      const uint32_t at = ring + s * Gm::STAGE;
      // A[p][j] = src[j][p] f_j, this warp's rows p = 16 wq .., as bf16 hi and lo:
      // f_j = dt_j e^(tot - cs_j) (x, Sf) or e^cs_j (dy, Sb)
      uint32_t ah[4][4], al[4][4];
      float f[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = kt * TJ + 16 * kk + 2 * tig + (u & 1) + 8 * (u >> 1);
          f[kk][u] = j >= g.Q ? 0.0f
                     : fwd    ? dtv[j] * decay2(tot, tot_l, csh[j], csl[j])
                              : decay2(csh[j], csl[j], 0.0f, 0.0f);
        }
      mbar_wait(full(w, s), (it / ST) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t q[4];
        ldsm_x4_t(q, sb + (at - base) + swz(16 * kk + (mat >> 1) * 8 + rr, 16 * wq + (mat & 1) * 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = unpack_bf16(q[e]);
          split_bf16(v.x * f[kk][(e >> 1) * 2], v.y * f[kk][(e >> 1) * 2 + 1], ah[kk][e],
                     al[kk][e]);
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int pn = 0; pn < NW / 64; ++pn) {
          const uint64_t desc = make_desc(at + Gm::X + kk * 16 * 128 + pn * PANEL, PANEL, 1024);
          wgmma_rs_n64(n64(acc + 32 * pn), ah[kk], desc);
          wgmma_rs_n64(n64(acc + 32 * pn), al[kk], desc);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
      release(empty(w, s));
    }
    const float e = decay2(tot, tot_l, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) carry[i] = carry[i] * e + acc[i];
  }
}

template <int NW>
struct ChunkGeo {
  static constexpr int X = TJ * PW * 2;   // a 64-position tile of x or dy
  static constexpr int BT = TJ * NW * 2;  // of B or C
  static constexpr int SB = 2 * BT;       // a state's hi and lo parts
  static constexpr int VEC = TJ * 16;     // a tile's float4s
  static constexpr int RS = BT + X + VEC; // a ring stage: B_j, x_j (or C_i, dy_i), float4s
  static constexpr int R = NW == 128 ? 2 : 4;
  static constexpr int OWN_C = 0, OWN_B = BT, HIN = 2 * BT, DH = HIN + SB, DYT = DH + SB,
                       XT = DYT + X, VQ = XT + X, VK = VQ + VEC, RQ = VK + VEC, RK = RQ + R * RS,
                       BARS = RK + R * RS;
  static constexpr int SMEM = BARS + 256 + 1024;
};

template <int NW>
__global__ void __launch_bounds__(WG_THREADS, 1)
ssd_bwd_chunk_wg(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ Args g, const Maps rf) {
  using Gm = ChunkGeo<NW>;
  constexpr int R = Gm::R;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  const uint32_t bars = base + Gm::BARS;
  const uint32_t res_full = bars, hin_full = bars + 8, hin_empty = bars + 16, dh_full = bars + 24,
                 dh_empty = bars + 32, oq_full = bars + 40, oq_empty = bars + 48,
                 ok_full = bars + 56, ok_empty = bars + 64;
  auto rq_full = [&](int s) { return bars + 72 + 8 * s; };
  auto rq_empty = [&](int s) { return bars + 72 + 8 * (R + s); };
  auto rk_full = [&](int s) { return bars + 72 + 8 * (2 * R + s); };
  auto rk_empty = [&](int s) { return bars + 72 + 8 * (3 * R + s); };

  const Item it = item_of(g);
  const int b = it.b, c = it.c, t = it.t, grp = it.grp;
  const int r0 = t * TJ;
  const int pos0 = c * g.Q;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (uint32_t bar = hin_full; bar <= ok_empty; bar += 16) {
      mbar_init(bar, 1);      // a full barrier: the loader's arrival and the bytes
      mbar_init(bar + 8, 4);  // its empty one: one arrival per warp of the warpgroup
    }
    // the first tile's items: the query role reads dh_out too, for <h_in, dh_out>
    if (t == 0) mbar_init(dh_empty, 8);
    for (int s = 0; s < R; ++s) {
      mbar_init(rq_full(s), 1);
      mbar_init(rq_empty(s), 4);
      mbar_init(rk_full(s), 1);
      mbar_init(rk_empty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= LOADER) {
    // ---- the loaders, one thread a stream (lane 0 of warps 8 - 11), each
    // load issued as its buffer frees: the query role's tiles (per head dy_t
    // and its float4s, then B_j, x_j and theirs for j <= t), the key role's
    // (per head x_t and its float4s, then C_i, dy_i and theirs for i >= t),
    // and each role's state per head (h_in; dh_out). Apart, a state that
    // waits for its buffer holds back no tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    const int w = (threadIdx.x - LOADER) / 32;
    if ((threadIdx.x & 31) != 0) return;
    if (w >= 2) {  // states: h_in (w 2), dh_out (w 3)
      const uint32_t st_full = w == 2 ? hin_full : dh_full;  // its empty barrier is at + 8
      for (int k = 0; k < it.nh; ++k) {
        mbar_wait(st_full + 8, (k & 1) ^ 1);
        mbar_expect(st_full, Gm::SB);
        bulk_load(base + (w == 2 ? Gm::HIN : Gm::DH), slot<NW>(g, bhc_of(g, b, it.h0 + k, c), w - 2),
                  Gm::SB, st_full);
      }
      return;
    }
    if (w == 0) {
      mbar_expect(res_full, 2 * Gm::BT);
      tma_tile(base + Gm::OWN_C, &tc, NW / 64, grp, pos0 + r0, b, rf.c, res_full);
      tma_tile(base + Gm::OWN_B, &tb, NW / 64, grp, pos0 + r0, b, rf.b, res_full);
    }
    const uint32_t own_full = w == 0 ? oq_full : ok_full;
    const int lo = w == 0 ? 0 : t, hi = w == 0 ? t : g.nt - 1;
    int n = 0;
    for (int k = 0; k < it.nh; ++k) {
      const int h = it.h0 + k;
      const long long bhc = bhc_of(g, b, h, c);
      mbar_wait(own_full + 8, (k & 1) ^ 1);
      mbar_expect(own_full, Gm::X + Gm::VEC);
      tma_tile(base + (w == 0 ? Gm::DYT : Gm::XT), w == 0 ? &tdy : &tx, 1, h, pos0 + r0, b,
               w == 0 ? rf.dy : rf.x, own_full);
      bulk_load(base + (w == 0 ? Gm::VQ : Gm::VK), g.vec + bhc * g.Qp + r0, Gm::VEC, own_full);
      for (int tile = lo; tile <= hi; ++tile, ++n) {
        const int s = n % R;
        const uint32_t full = w == 0 ? rq_full(s) : rk_full(s);
        mbar_wait(w == 0 ? rq_empty(s) : rk_empty(s), ((n / R) & 1) ^ 1);
        mbar_expect(full, Gm::RS);
        const uint32_t at = base + (w == 0 ? Gm::RQ : Gm::RK) + s * Gm::RS;
        if (w == 0) {
          tma_tile(at, &tb, NW / 64, grp, pos0 + tile * TJ, b, rf.b, full);
          tma_tile(at + Gm::BT, &tx, 1, h, pos0 + tile * TJ, b, rf.x, full);
        } else {
          tma_tile(at, &tc, NW / 64, grp, pos0 + tile * TJ, b, rf.c, full);
          tma_tile(at + Gm::BT, &tdy, 1, h, pos0 + tile * TJ, b, rf.dy, full);
        }
        bulk_load(at + Gm::BT + Gm::X, g.vec + bhc * g.Qp + tile * TJ, Gm::VEC, full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int rowq = 16 * wq + (lane >> 2);  // this lane's rows in the tile: rowq, rowq + 8
  mbar_wait(res_full, 0);
  int n = 0;

  // A tile pair off the diagonal decays by a row factor (per head) times a
  // column factor, both at most 1 from an anchor position between the
  // tiles: e^(cs_i - cs_j) = e^(cs_i - cs_a) e^(cs_a - cs_j): one exponential
  // a column a thread, not one an element.

  if (wg == 0) {
    // ---- the query role of tile t: dC of its rows, summed over the heads;
    // anchor: the tile's first position
    const uint32_t own_c = base + Gm::OWN_C;
    const uint32_t dyt = base + Gm::DYT;
    const float4* vq = reinterpret_cast<const float4*>(sb + Gm::VQ);
    float dc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) dc[i] = 0.0f;
    for (int k = 0; k < it.nh; ++k) {
      const int h = it.h0 + k;
      const long long bhc = bhc_of(g, b, h, c);
      mbar_wait(oq_full, k & 1);
      const float4 va = vq[0];
      float csi[2], cli[2], ecs[2], rf_[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 v = vq[rowq + 8 * half];
        csi[half] = v.x;
        cli[half] = v.y;
        ecs[half] = decay2(v.x, v.y, 0.0f, 0.0f);
        rf_[half] = decay2(v.x, v.y, va.x, va.y);  // e^(cs_i - cs_a)
      }
      // the state term: dy h_in, h_in as hi and lo parts
      float tmp[NW / 2];
      mbar_wait(hin_full, k & 1);
      fence_regs(tmp);
      wgmma_fence();
      ss_mn<NW>(tmp, dyt, base + Gm::HIN, 0);
      ss_mn<NW>(tmp, dyt, base + Gm::HIN + (NW / 64) * PANEL, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
      if (t == 0) {
        // <h_in, dh_out> of (b, h, c) from the two buffers' hi and lo parts,
        // one fp64 partial a warp
        mbar_wait(dh_full, k & 1);
        double hd = 0.0;
#pragma unroll 4
        for (int i = 0; i < NW / 2; i += 2) {
          const uint32_t off = swz(frow(wq, i), fcol(i));
          const uint32_t lo = (NW / 64) * PANEL;
          const float2 ih = unpack_bf16(*reinterpret_cast<const uint32_t*>(sb + Gm::HIN + off));
          const float2 il = unpack_bf16(*reinterpret_cast<const uint32_t*>(sb + Gm::HIN + lo + off));
          const float2 dh = unpack_bf16(*reinterpret_cast<const uint32_t*>(sb + Gm::DH + off));
          const float2 dl = unpack_bf16(*reinterpret_cast<const uint32_t*>(sb + Gm::DH + lo + off));
          hd += static_cast<double>(ih.x + il.x) * (dh.x + dl.x) +
                static_cast<double>(ih.y + il.y) * (dh.y + dl.y);
        }
        release(dh_empty);
        hd = warp_sum(hd);
        if (lane == 0) g.hdp[bhc * 4 + wq] = hd;
      }
      release(hin_empty);
      double rowm[2] = {0.0, 0.0};
#pragma unroll
      for (int i = 0; i < NW / 2; i += 2) {
        const int half = (i >> 1) & 1;
        const float2 cv = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(sb + Gm::OWN_C + swz(rowq + 8 * half, fcol(i))));
        rowm[half] += (cv.x * tmp[i] + cv.y * tmp[i + 1]) * ecs[half];
        dc[i] += tmp[i] * ecs[half];
        dc[i + 1] += tmp[i + 1] * ecs[half];
      }
      // every key tile j <= t
      for (int j = 0; j <= t; ++j, ++n) {
        const int s = n % R;
        const uint32_t at = base + Gm::RQ + s * Gm::RS;
        const float4* vj = reinterpret_cast<const float4*>(sb + Gm::RQ + s * Gm::RS + Gm::BT + Gm::X);
        const bool diag = j == t;
        float sc[32], ds[32];
        mbar_wait(rq_full(s), (n / R) & 1);
        fence_regs(sc);
        fence_regs(ds);
        wgmma_fence();
        ss_k<NW>(sc, own_c, at, 0);        // C_t B_j^T
        ss_k<PW>(ds, dyt, at + Gm::BT, 0);  // dy_t x_j^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(ds);
        uint32_t pa[4][4];  // (dy xdt^T) o L as A fragments, packed as they are made
        float rp[2] = {0.0f, 0.0f};  // this tile's share of rowsum(M), fp32
        auto ew = [&](auto on_diag) {
          constexpr bool DIAG = decltype(on_diag)::value;
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            const int col = 8 * nn + 2 * tig;
            const float4 v2[2] = {vj[col], vj[col + 1]};
            float2 f2;  // e^(cs_a - cs_j), j < a
            if constexpr (!DIAG) {
              f2.x = decay2(va.x, va.y, v2[0].x, v2[0].y);
              f2.y = decay2(va.x, va.y, v2[1].x, v2[1].y);
            }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float o[2];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int i = 4 * nn + 2 * half + u;
                float lm;
                if constexpr (DIAG)
                  lm = col + u <= rowq + 8 * half
                           ? decay2(csi[half], cli[half], v2[u].x, v2[u].y)
                           : 0.0f;
                else
                  lm = rf_[half] * (u ? f2.y : f2.x);
                const float dsc = ds[i] * v2[u].z;  // dy xdt^T
                rp[half] += dsc * (sc[i] * lm);  // as the key role forms M
                o[u] = dsc * lm;
              }
              pa[nn >> 1][(nn & 1) * 2 + half] = pack_bf16(o[0], o[1]);
            }
          }
        };
        if (diag)
          ew(std::true_type{});
        else
          ew(std::false_type{});
        rowm[0] += rp[0];
        rowm[1] += rp[1];
        fence_regs(dc);
        wgmma_fence();
        rs_mn<NW>(dc, pa, at);  // dC += (dy xdt^T o L) B_j
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dc);
        fence_regs(pa);
        release(rq_empty(s));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const double total = quad_sum(rowm[half]);
        const int r = r0 + rowq + 8 * half;
        if (tig == 0 && r < g.Q) g.dcq[bhc * g.Qp + r] = total;
      }
      release(oq_empty);
    }
    store_group_grad<bf16, NW>(g, it, dc, wq, 1);
    return;
  }

  // ---- the key role of tile t: dxdt (dx, dt's x part) per head, dB of its
  // rows summed over the heads; anchor: the tile's last position
  const uint32_t own_b = base + Gm::OWN_B;
  const uint32_t xt = base + Gm::XT;
  const float4* vk = reinterpret_cast<const float4*>(sb + Gm::VK);
  float db[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) db[i] = 0.0f;
  for (int k = 0; k < it.nh; ++k) {
    const int h = it.h0 + k;
    const long long bhc = bhc_of(g, b, h, c);
    const float4 tv = g.vec[bhc * g.Qp + g.Q - 1];
    mbar_wait(ok_full, k & 1);
    const float4 va = vk[TJ - 1];
    float csj[2], clj[2], dtj[2], fo[2], rf_[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 v = vk[rowq + 8 * half];
      csj[half] = v.x;
      clj[half] = v.y;
      dtj[half] = v.z;
      fo[half] = decay2(tv.x, tv.y, v.x, v.y);   // e^(tot - cs_j)
      rf_[half] = decay2(va.x, va.y, v.x, v.y);  // e^(cs_a - cs_j)
    }
    // the state terms: B_t dh_out^T and x_t dh_out, dh_out as hi and lo parts
    float dxdt[32];
    float tmp[NW / 2];
    mbar_wait(dh_full, k & 1);
    fence_regs(dxdt);
    fence_regs(tmp);
    wgmma_fence();
    ss_k<NW>(dxdt, own_b, base + Gm::DH, 0);
    ss_k<NW>(dxdt, own_b, base + Gm::DH + (NW / 64) * PANEL, 1);
    ss_mn<NW>(tmp, xt, base + Gm::DH, 0);
    ss_mn<NW>(tmp, xt, base + Gm::DH + (NW / 64) * PANEL, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dxdt);
    fence_regs(tmp);
    release(dh_empty);
    double wj[2] = {0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i >> 1) & 1;
      const float2 xv = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(sb + Gm::XT + swz(rowq + 8 * half, fcol(i))));
      dxdt[i] *= fo[half];  // u
      dxdt[i + 1] *= fo[half];
      wj[half] += (xv.x * dxdt[i] + xv.y * dxdt[i + 1]) * dtj[half];
    }
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int half = (i >> 1) & 1;
      db[i] += tmp[i] * dtj[half] * fo[half];
    }
    // every query tile i >= t
    double colm[2] = {0.0, 0.0};
    for (int ti = t; ti < g.nt; ++ti, ++n) {
      const int s = n % R;
      const uint32_t at = base + Gm::RK + s * Gm::RS;
      const float4* vi = reinterpret_cast<const float4*>(sb + Gm::RK + s * Gm::RS + Gm::BT + Gm::X);
      const bool diag = ti == t;
      float st[32], ds[32];
      mbar_wait(rk_full(s), (n / R) & 1);
      fence_regs(st);
      fence_regs(ds);
      wgmma_fence();
      ss_k<NW>(st, own_b, at, 0);      // (C_i B_t^T)^T
      ss_k<PW>(ds, xt, at + Gm::BT, 0);  // (dy_i x_t^T)^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(ds);
      // ((C B^T) o L)^T and ((dy xdt^T) o L)^T as A fragments, packed as they are
      // made; the diagonal tile's decays taken one by one, the others' as
      // products of factors (one branch a tile, not a select an element,
      // which would take every decay's exponential)
      uint32_t pa[4][4], pb[4][4];
      float cp[2] = {0.0f, 0.0f};  // this tile's share of colsum(M), fp32
      auto ew = [&](auto on_diag) {
        constexpr bool DIAG = decltype(on_diag)::value;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int col = 8 * nn + 2 * tig;
          float2 f2, v2[2];
          if constexpr (DIAG) {
            v2[0] = make_float2(vi[col].x, vi[col].y);
            v2[1] = make_float2(vi[col + 1].x, vi[col + 1].y);
          } else {
            // e^(cs_i - cs_a), i > a; 0 for the rows past Q of the last
            // tile, which hold the next chunk's positions
            const float4 w0 = vi[col], w1 = vi[col + 1];
            f2.x = ti * TJ + col < g.Q ? decay2(w0.x, w0.y, va.x, va.y) : 0.0f;
            f2.y = ti * TJ + col + 1 < g.Q ? decay2(w1.x, w1.y, va.x, va.y) : 0.0f;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float oa[2], ob[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = 4 * nn + 2 * half + u;
              float lm;
              if constexpr (DIAG)
                lm = col + u >= rowq + 8 * half && r0 + col + u < g.Q
                         ? decay2(v2[u].x, v2[u].y, csj[half], clj[half])
                         : 0.0f;
              else
                lm = rf_[half] * (u ? f2.y : f2.x);
              const float sc = st[i] * lm;
              const float dsc = ds[i] * dtj[half];  // (dy xdt^T)^T
              cp[half] += dsc * sc;
              oa[u] = sc;
              ob[u] = dsc * lm;
            }
            pa[nn >> 1][(nn & 1) * 2 + half] = pack_bf16(oa[0], oa[1]);
            pb[nn >> 1][(nn & 1) * 2 + half] = pack_bf16(ob[0], ob[1]);
          }
        }
      };
      if (diag)
        ew(std::true_type{});
      else
        ew(std::false_type{});
      colm[0] += cp[0];
      colm[1] += cp[1];
      fence_regs(dxdt);
      fence_regs(db);
      wgmma_fence();
      rs_mn<PW>(dxdt, pa, at + Gm::BT);  // dxdt += ((C B^T) o L)^T dy_i
      rs_mn<NW>(db, pb, at);             // dB += ((dy xdt^T) o L)^T C_i
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxdt);
      fence_regs(db);
      fence_regs(pa);
      fence_regs(pb);
      release(rk_empty(s));
    }
    // dx, dt's x part, and the cumsum cotangent's key part for head h; x_t
    // goes back to the loader before the stores, so the next head's loads
    // under them
    float ddt_x[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i >> 1) & 1;
      const float2 xv = unpack_bf16(
          *reinterpret_cast<const uint32_t*>(sb + Gm::XT + swz(rowq + 8 * half, fcol(i))));
      ddt_x[half] += dxdt[i] * xv.x + dxdt[i + 1] * xv.y;
    }
    release(ok_empty);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + rowq + 8 * half;
      const long long pos = static_cast<long long>(pos0) + r;
      const bool in = r < g.Q && pos < g.S;
      bf16* dxr = static_cast<bf16*>(g.dx) + ((b * static_cast<long long>(g.S) + pos) * g.H + h) * g.P;
      if (g.P % 8 == 0) {
        // 16-byte chunks: the quad gathers each 8-column block into one lane
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += 4) {
          uint32_t mine[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mine[q] = pack_bf16(dxdt[4 * (n0 + q) + 2 * half] * dtj[half],
                                dxdt[4 * (n0 + q) + 2 * half + 1] * dtj[half]);
          const uint4 chunk = quad_gather(mine, tig);
          if (in && 8 * (n0 + tig) < g.P) *reinterpret_cast<uint4*>(dxr + 8 * (n0 + tig)) = chunk;
        }
      } else {
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int p = 8 * nn + 2 * tig;
          const float u0 = dxdt[4 * nn + 2 * half] * dtj[half];
          const float u1 = dxdt[4 * nn + 2 * half + 1] * dtj[half];
          if (!in) continue;
          if (p + 1 < g.P && g.P % 2 == 0) {
            *reinterpret_cast<uint32_t*>(dxr + p) = pack_bf16(u0, u1);
          } else {
            if (p < g.P) dxr[p] = __float2bfloat16(u0);
            if (p + 1 < g.P) dxr[p + 1] = __float2bfloat16(u1);
          }
        }
      }
      const float dx_t = quad_sum(ddt_x[half]);
      const double wsum = quad_sum(wj[half]);
      const double dcs = -quad_sum(colm[half]) - wsum;
      if (tig == 0) {
        if (in) g.ddt[(b * static_cast<long long>(g.S) + pos) * g.H + h] = dx_t;
        if (r < g.Q) {
          g.dck[bhc * g.Qp + r] = dcs;
          g.w[bhc * g.Qp + r] = wsum;
        }
      }
    }
  }
  store_group_grad<bf16, NW>(g, it, db, wq, 0);
}

// ---------------------------------------------------------------- finish

// blocks [0, H): head h. Each warp takes the (batch, chunk)s w, w + 32, ...:
// dtot = e^tot <h_in, dh_out> + sum w, then the chunk's rows of 32
// positions from its end, each row's suffix sums by shuffles plus the sum
// past the row (fp64): d(dt A) = that + dtot, dt's gradient += d(dt A) A,
// and A's gradient summed per lane, per warp, then over the warps in order,
// in fp64. Blocks past H: the slices' dB and dC partials summed in slice
// order.
template <typename T>
__global__ void __launch_bounds__(FIN_THREADS) ssd_bwd_finish(const __grid_constant__ Args g) {
  __shared__ double warp_total[FIN_THREADS / 32];
  if (static_cast<int>(blockIdx.x) >= g.H) {
    const long long bsgn = static_cast<long long>(g.B) * g.S * g.G * g.N;
    const long long idx = static_cast<long long>(blockIdx.x - g.H) * FIN_THREADS + threadIdx.x;
    if (idx >= 2 * bsgn) return;
    const int which = static_cast<int>(idx / bsgn);
    const long long at = idx % bsgn;
    float sum = 0.0f;
    for (int s = 0; s < g.slices; ++s)
      sum += g.part[(static_cast<long long>(which) * g.slices + s) * bsgn + at];
    static_cast<T*>(which == 0 ? g.dB : g.dC)[at] = from_f32<T>(sum);
    return;
  }
  const int h = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float a = g.A[h];
  double apart = 0.0;
  for (int bc = warp; bc < g.B * g.nc; bc += FIN_THREADS / 32) {
    const int b = bc / g.nc, c = bc % g.nc;
    const long long bhc = bhc_of(g, b, h, c);
    const int qv = min(g.Q, g.S - c * g.Q);
    const int rows = (qv + 31) / 32;
    const double* dq = g.dcq + bhc * g.Qp;
    const double* dk = g.dck + bhc * g.Qp;
    const double* wv = g.w + bhc * g.Qp;
    const float4* vv = g.vec + bhc * g.Qp;
    float* ddt = g.ddt + (b * static_cast<long long>(g.S) + static_cast<long long>(c) * g.Q) *
                             g.H + h;
    double wsum = 0.0;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const int l = 32 * r + lane;
      if (l < qv) wsum += wv[l];
    }
    wsum = warp_sum(wsum);
    const double* hp = g.hdp + bhc * 4;
    const double hd = ((hp[0] + hp[1]) + hp[2]) + hp[3];
    const float4 tv = vv[g.Q - 1];
    const double dtot = static_cast<double>(decay(tv.x, tv.y, 0.0f, 0.0f)) * hd + wsum;
    double past = 0.0;  // the chunk's dcs past the current row
    // rows from the chunk's end, RB at a time: every load of a batch is
    // issued before its sums
    constexpr int RB = 8;
    for (int top = rows; top > 0; top -= RB) {
      double v[RB];
      float dtl[RB], old[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int l = 32 * (top - 1 - u) + lane;
        const bool in = top - 1 - u >= 0 && l < qv;
        v[u] = in ? dq[l] + dk[l] : 0.0;
        dtl[u] = in ? vv[l].z : 0.0f;
        old[u] = in ? ddt[static_cast<long long>(l) * g.H] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int l = 32 * (top - 1 - u) + lane;
        double inc = v[u];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double t = __shfl_down_sync(0xffffffffu, inc, off);
          if (lane + off < 32) inc += t;
        }
        const double row = __shfl_sync(0xffffffffu, inc, 0);
        if (top - 1 - u >= 0 && l < qv) {
          const double dda = (inc + past) + dtot;
          ddt[static_cast<long long>(l) * g.H] = old[u] + static_cast<float>(dda * a);
          apart += dda * dtl[u];
        }
        past += row;
      }
    }
  }
  apart = warp_sum(apart);
  if (lane == 0) warp_total[warp] = apart;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < FIN_THREADS / 32; ++w) total += warp_total[w];
    g.dA[h] = static_cast<float>(total);
  }
}

// ---------------------------------------------------------------- launch

// a (batch, position, head or group, inner) bf16 tensor as a 4-d TMA map of
// 64 x 64 boxes, the position and head axes in order of their strides
bool make_map(CUtensorMap* map, const void* ptr, int inner, int heads, int S, int B,
              long long sb, long long ss, long long sh, int* rows_first) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const bool rf = ss <= sh;
  *rows_first = rf ? 1 : 0;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rf ? S : heads),
                        static_cast<cuuint64_t>(rf ? heads : S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (rf ? ss : sh)),
                           static_cast<cuuint64_t>(2 * (rf ? sh : ss)),
                           static_cast<cuuint64_t>(2 * sb)};
  cuuint32_t box[4] = {64, rf ? 64u : 1u, rf ? 1u : 64u, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the workspace's regions in Args's order, each on 1024 bytes; returns
// their total (bytes)
long long carve(uint8_t* ws, Args& g) {
  const long long bhc = static_cast<long long>(g.B) * g.H * g.nc;
  const int nw = g.N > 64 ? 128 : 64;
  const long long sizes[6] = {bhc * g.Qp * 16, bhc * 2 * PW * nw * 4, 3 * bhc * g.Qp * 8,
                              bhc * 4 * 8,
                              g.slices > 1 ? 2LL * g.slices * g.B * g.S * g.G * g.N * 4 : 0, 0};
  long long at[6];
  long long total = 0;
  for (int i = 0; i < 5; ++i) {
    at[i] = total;
    total += (sizes[i] + 1023) / 1024 * 1024;
  }
  if (ws != nullptr) {
    g.vec = reinterpret_cast<float4*>(ws + at[0]);
    g.st = ws + at[1];
    g.dcq = reinterpret_cast<double*>(ws + at[2]);
    g.dck = g.dcq + bhc * g.Qp;
    g.w = g.dck + bhc * g.Qp;
    g.hdp = reinterpret_cast<double*>(ws + at[3]);
    g.part = g.slices > 1 ? reinterpret_cast<float*>(ws + at[4]) : nullptr;
  }
  return total;
}

template <typename T, int NW>
int launch(Args& g, cudaStream_t s) {
  cudaError_t err;
  const long long items = static_cast<long long>(g.B) * g.G * g.nc * g.slices * g.nt;
  if (items > 0x7fffffffLL || static_cast<long long>(g.B) * g.H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {
    CUtensorMap tx, tb, tc, tdy;
    Maps rf{};
    if (!make_map(&tx, g.x, g.P, g.H, g.S, g.B, g.sx[0], g.sx[1], g.sx[2], &rf.x) ||
        !make_map(&tb, g.Bm, g.N, g.G, g.S, g.B, g.sb_[0], g.sb_[1], g.sb_[2], &rf.b) ||
        !make_map(&tc, g.Cm, g.N, g.G, g.S, g.B, g.sc[0], g.sc[1], g.sc[2], &rf.c) ||
        !make_map(&tdy, g.dy, g.P, g.H, g.S, g.B, g.sdy[0], g.sdy[1], g.sdy[2], &rf.dy))
      return static_cast<int>(cudaErrorInvalidValue);
    const int states_bytes = StatesGeo<NW>::smem(g.Qp);
    constexpr int chunk_bytes = ChunkGeo<NW>::SMEM;
    if (StatesGeo<NW>::stages(g.Qp) < 2) return static_cast<int>(cudaErrorInvalidValue);
    static_assert(chunk_bytes <= MAX_SMEM, "the chunk launch's buffers exceed shared memory");
    if (states_bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(ssd_bwd_states_wg<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               states_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_wg<NW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_states_wg<NW><<<g.B * g.H, WG_THREADS, states_bytes, s>>>(tx, tb, tc, tdy, g, rf);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_chunk_wg<NW><<<static_cast<int>(items), WG_THREADS, chunk_bytes, s>>>(tx, tb, tc,
                                                                                  tdy, g, rf);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  } else {
    const int states_bytes = states_f32_smem<NW>(g.Qp);
    constexpr int chunk_bytes = chunk_f32_smem<NW>();
    static_assert(chunk_bytes <= MAX_SMEM, "the chunk launch's tiles exceed shared memory");
    if (states_bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(ssd_bwd_states_f32<NW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, states_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_f32<NW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_states_f32<NW><<<g.B * g.H, 256, states_bytes, s>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_chunk_f32<NW><<<static_cast<int>(items), 128, chunk_bytes, s>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const long long parts = g.slices > 1
                              ? (2LL * g.B * g.S * g.G * g.N + FIN_THREADS - 1) / FIN_THREADS
                              : 0;
  ssd_bwd_finish<T><<<static_cast<int>(g.H + parts), FIN_THREADS, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

Args shape_args(int B, int S, int H, int G, int P, int N, int Q, int slices) {
  Args g{};
  g.B = B;
  g.S = S;
  g.H = H;
  g.G = G;
  g.P = P;
  g.N = N;
  g.Q = Q;
  g.nc = (S + Q - 1) / Q;
  g.nt = (Q + TJ - 1) / TJ;
  g.Qp = g.nt * TJ;
  g.slices = slices;
  const int hg = H / G;
  g.hs = (hg + slices - 1) / slices;
  return g;
}

bool shape_ok(int B, int S, int H, int G, int P, int N, int Q, int slices) {
  return B > 0 && S > 0 && H > 0 && G > 0 && H % G == 0 && P > 0 && P <= PW && N > 0 &&
         N <= MAX_N && Q > 0 && Q <= MAX_Q && slices > 0 && slices <= H / G;
}

}  // namespace

// the workspace (bytes) a backward of this shape takes with `slices` slices
// of each group's heads, or -1 for a shape the kernels do not take
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int G, int P, int N, int Q,
                                            int slices) {
  if (!shape_ok(B, S, H, G, P, N, Q, slices)) return -1;
  Args g = shape_args(B, S, H, G, P, N, Q, slices);
  return carve(nullptr, g);
}

// dtype: 0 fp32, 1 bf16. strides: 19 element strides: x (4), dt (3), B (4),
// C (4), dy (4); bf16 reads x, B, C and dy through TMA maps (unit stride
// along the last dim, start and other strides on 16 bytes). dstate:
// contiguous (B, H, P, N) fp32, or null for none. dx (B, S, H, P), ddt (B,
// S, H), dB and dC (B, S, G, N) contiguous, dA (H,); ws:
// ssd_scan_bwd_workspace bytes. `slices` slices of each group's heads (the
// last may hold fewer). Three launches on `stream`. Returns a CUDA error
// code (0 when every launch was accepted).
extern "C" int ssd_scan_bwd_launch(int dtype, const void* x, const void* dt, const void* A,
                                   const void* Bm, const void* Cm, const void* dy,
                                   const void* dstate, void* dx, void* ddt, void* dA, void* dB,
                                   void* dC, void* ws, int B, int S, int H, int G, int P, int N,
                                   int Q, int slices, const long long* strides, void* stream) {
  if (!shape_ok(B, S, H, G, P, N, Q, slices)) return static_cast<int>(cudaErrorInvalidValue);
  Args g = shape_args(B, S, H, G, P, N, Q, slices);
  // every slice holds at least one head
  if ((slices - 1) * g.hs >= H / G) return static_cast<int>(cudaErrorInvalidValue);
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
  for (int i = 0; i < 4; ++i) {
    g.sx[i] = strides[i];
    g.sb_[i] = strides[7 + i];
    g.sc[i] = strides[11 + i];
    g.sdy[i] = strides[15 + i];
  }
  for (int i = 0; i < 3; ++i) g.sdt[i] = strides[4 + i];
  carve(static_cast<uint8_t*>(ws), g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = N > 64;
  if (dtype == 0) return wide ? launch<float, 128>(g, s) : launch<float, 64>(g, s);
  if (dtype == 1) return wide ? launch<bf16, 128>(g, s) : launch<bf16, 64>(g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
