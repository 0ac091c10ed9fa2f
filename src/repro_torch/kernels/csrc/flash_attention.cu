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
// The bf16 body keeps m in the units of the unscaled product and takes
// exp(scale * (s - m)) as exp2(s * scale * log2(e) - m * scale * log2(e)):
// the same function, with the scale folded into one FMA before exp2.
//
// Layout: q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o like q, each read
// through its own (batch, head, row) element strides with unit stride along
// hd, so the model's (B, S, H, hd) tensors are passed as transposed views
// and nothing is copied. hd is one of 16, 32, 64, 80, 112, 128, 256 (a
// template argument). What differs from the TPU kernel: that one walks a
// sequential grid and keeps (m, l, acc) in VMEM scratch across the kv axis;
// here a block loops over the kv tiles of its q tile itself, with m, l and
// the accumulator in registers. Under the causal mask that loop stops at the
// q tile's last row, so kv tiles wholly above the diagonal are never read,
// and the q tiles with the most work go first.
//
// Two bodies, chosen by the type:
//   bf16: FlashAttention-3's layout on wgmma, persistent. One block of 384
//         threads per SM walks items, an item being 128 q rows of one
//         (batch, head): warpgroup 0 loads, warpgroups 1 and 2 compute 64
//         rows each (setmaxnreg moves registers from the loader to them).
//         One thread of the loader issues TMA copies: the item's Q tiles,
//         then 64-row K and V tiles into rings of 3 stages (2 at hd 256),
//         each stage with a "full" mbarrier (TMA bytes) and an "empty" one
//         (one arrival per consumer warp), and Q too has such a pair, so the
//         next item's Q and first tiles arrive while this item ends. A tile
//         is hd split into panels of 64 columns (hd itself below 64), each
//         panel 64 rows of 128 bytes in the 128-byte swizzle (64- and 32-byte
//         at hd 32 and 16), which is the layout wgmma reads without bank
//         conflicts; TMA zero-fills rows past Sq or Skv and columns past hd.
//         S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//         memory; O += P V is wgmma with P from registers and V from shared
//         memory, MN-major, one instruction per panel (n64, and n16 or n48
//         for the last panel at hd 80 and 112). The scores of tile j are
//         computed while P V of tile j - 1 runs. The online softmax stays in
//         registers: row max across the 4 lanes of a quad with
//         __shfl_xor_sync, the row sum kept per lane and summed across the
//         quad once at the end; P is rounded to bf16 and packed from S's
//         accumulator straight into P V's A fragments (wgmma's accumulator
//         and register-A layouts are mma.sync's, per warp). The mask is
//         applied only on tiles that reach past a warp's first row or past
//         Skv. The output goes from registers to memory, 4 bytes a lane. Items
//         go to blocks round-robin, reversed every other round. Longest first
//         across the whole grid (the q tile as an item's slowest index)
//         balances the SMs best but spreads the blocks in flight over every
//         (batch, head), which pays only while all of K and V fit in L2: the
//         launcher compares the two. It takes 16-byte-aligned q, k, v with
//         (batch, head, row) strides that are multiples of 8 elements (TMA's
//         rule; the wrapper copies anything else). ptxas reports 168
//         registers at launch; only hd 256 spills (a few bytes: its 128 fp32
//         accumulators per thread; the build prints the count). Every
//         mbarrier wait traps after about 2 s (mbar_wait), which ends the
//         process's CUDA context instead of hanging the card;
//   fp32: FMAs from shared memory, off the tensor cores (no TF32: fp32 stays
//         fp32). 256 threads per 64-row q tile, kv tiles of 32 rows; q, the
//         kv tile (k transposed) and p sit in shared memory as fp32, each
//         thread holds 4 rows by hd/16 columns of the accumulator.
//
// What bounds it on an H100: at the served model's prefill (B 8, H 16, KV 8,
// S 1024, hd 128, bf16, causal) the work is 4 * hd operations per unmasked
// (q, k) pair, about 34 GFLOP, against about 0.1 GB of q, k, v and o: bound by
// operations, 35 us at the bf16 tensor-core peak (989 TFLOP/s). On that shape
// the first version of this kernel (fp32 FMAs for bf16 too) took 2.24 ms, the
// FlashAttention-2 layout on mma.sync 0.20 ms, and this one about 0.11 ms
// (chip_smoke.py's attention phase; PERF.md), against 0.08 ms for PyTorch's
// scaled_dot_product_attention. At S 4096 it runs at about 460 TFLOP/s; at
// S 1024 an item walks at most 16 kv tiles, and the first S and the last P V
// of each item, which nothing overlaps, and the causal diagonal, where
// warpgroup 1 has one tile more than warpgroup 0, weigh more.
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16 on wgmma, with TMA and warp specialisation
constexpr int NC = 2;                    // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * NC;              // q rows per block
constexpr int BK = 64;                   // kv rows per tile
constexpr int THREADS = 128 * (NC + 1);  // warpgroup 0 loads, the others compute
// registers per thread after setmaxnreg (168 at launch): the loader gives up
// what the consumers take
constexpr int LOADER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int HD>
struct Geo {
  static constexpr int PW = HD < 64 ? HD : 64;          // panel width (elements) = swizzle span
  static constexpr int PANELS = (HD + PW - 1) / PW;
  static constexpr int LASTW = HD - (PANELS - 1) * PW;  // width of the last panel's product
  static constexpr int RB = PW * 2;                     // bytes per panel row
  static constexpr int PANEL = 64 * RB;                 // bytes of a 64-row panel
  static constexpr int TILE = PANELS * PANEL;           // bytes of a 64-row tile
  static constexpr int STAGES = HD <= 128 ? 3 : 2;
  static constexpr int SMEM = (NC + 2 * STAGES) * TILE + 1024 + 256;  // + alignment, barriers
  // wgmma descriptor's swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
};

// one TMA box (PW columns x 64 rows) of a 4-d map into shared memory: the map's
// axes are (hd, row, head, batch), or (hd, head, row, batch) when not rows_first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         int head, int batch, int rows_first, uint32_t bar) {
  const int c1 = rows_first ? row : head;
  const int c2 = rows_first ? head : row;
  tma_load_4d(dst, map, col, c1, c2, batch, bar);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b) {
  if constexpr (W == 64) wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(d), a, b);
  if constexpr (W == 48) wgmma_rs_n48(*reinterpret_cast<float(*)[24]>(d), a, b);
  if constexpr (W == 32) wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(d), a, b);
  if constexpr (W == 16) wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(d), a, b);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int G, int H,
               int B, int Sq, int Skv, long long osb, long long osh, long long oss,
               int causal, int rows_first, int q_slow, float scale_log2) {
  using Gm = Geo<HD>;
  constexpr int ST = Gm::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // every tile on a 1024-byte boundary (the 128-byte swizzle's atom)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qs = base;                         // NC tiles, one per consumer warpgroup
  const uint32_t Ks = Qs + NC * Gm::TILE;           // ST tiles
  const uint32_t Vs = Ks + ST * Gm::TILE;           // ST tiles
  // barriers: full_q, empty_q, full_k[ST], empty_k[ST], full_v[ST], empty_v[ST]
  const uint32_t bars = Vs + ST * Gm::TILE;
  const uint32_t full_q = bars;
  const uint32_t empty_q = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + ST + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 + 2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 3 * ST + s); };

  // Persistent: the block walks items (a q tile of one batch and head) k =
  // 0, 1, ...: item k * gridDim.x + c, with c = blockIdx.x on even rounds and
  // reversed on odd ones. With q_slow the q tile is an item's slowest index,
  // so the longest items go first across every (batch, head); else one
  // head's q tiles are neighbours. The loader fetches the next item's Q and
  // tiles while the consumers finish this one.
  const int nq = (Sq + BQ - 1) / BQ;
  const int items = nq * H * B;
  auto item_of = [&](int k) {
    const int c = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return k * static_cast<int>(gridDim.x) + c;
  };
  auto decode = [&](int i, int& q0, int& h, int& b, int& tiles) {
    const int qt = q_slow ? i / (H * B) : i % nq;
    const int r = q_slow ? i % (H * B) : i / nq;
    h = r % H;
    b = r / H;
    q0 = (nq - 1 - qt) * BQ;  // the last q tiles carry the most work
    const int kv_end = causal ? min(Skv, min(q0 + BQ, Sq)) : Skv;
    tiles = (kv_end + BK - 1) / BK;
  };
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 4 * NC);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * NC);  // one arrival per consumer warp
      mbar_init(empty_v(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread keeps Q and the K and V rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;  // tiles loaded so far, over all items: the ring's position
      for (int k = 0; item_of(k) < items; ++k) {
        int q0, h, b, tiles;
        decode(item_of(k), q0, h, b, tiles);
        mbar_wait(empty_q, (k & 1) ^ 1);
        mbar_expect(full_q, NC * Gm::TILE);
        for (int w = 0; w < NC; ++w)
          for (int p = 0; p < Gm::PANELS; ++p)
            tma_load(Qs + w * Gm::TILE + p * Gm::PANEL, &tq, p * Gm::PW, q0 + 64 * w, h, b,
                     rows_first & 1, full_q);
        for (int j = 0; j < tiles; ++j, ++it) {
          const int s = it % ST;
          const int ph = (it / ST) & 1;
          mbar_wait(empty_k(s), ph ^ 1);
          mbar_expect(full_k(s), Gm::TILE);
          for (int p = 0; p < Gm::PANELS; ++p)
            tma_load(Ks + s * Gm::TILE + p * Gm::PANEL, &tk, p * Gm::PW, j * BK, h / G, b,
                     rows_first & 2, full_k(s));
          mbar_wait(empty_v(s), ph ^ 1);
          mbar_expect(full_v(s), Gm::TILE);
          for (int p = 0; p < Gm::PANELS; ++p)
            tma_load(Vs + s * Gm::TILE + p * Gm::PANEL, &tv, p * Gm::PW, j * BK, h / G, b,
                     rows_first & 4, full_v(s));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns an item's q rows 64 w .. 64 w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wgi - 1;
  const int t = threadIdx.x - 128 * wgi;  // thread in the warpgroup
  const int warp = t >> 5;
  const int lane = t & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const uint32_t Qw = Qs + w * Gm::TILE;
  float acc[HD / 2];  // n8 tiles of the output, as mma.sync's C fragments
  float m[2];         // rows grp and grp + 8 of the warp
  float l[2];         // this lane's share of the row sums
  int wrow = 0;       // the warp's first row in the item

  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // S = Q K^T of the tile in stage s, issued, not waited for
  auto issue_s = [&](float (&sc)[32], int s) {
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk * 16 / Gm::PW) * Gm::PANEL + (kk * 16 % Gm::PW) * 2;
      wgmma_ss_n64(sc, make_desc(Qw + off, 16, 8 * Gm::RB, Gm::LAYOUT),
                   make_desc(Ks + s * Gm::TILE + off, 16, 8 * Gm::RB, Gm::LAYOUT), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage s, issued, not waited for
  auto issue_pv = [&](uint32_t (&pa)[BK / 16][4], int s) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t vrow = Vs + s * Gm::TILE + kt * 16 * Gm::RB;
#pragma unroll
      for (int p = 0; p < Gm::PANELS - 1; ++p)
        wgmma_rs<Gm::PW>(&acc[p * Gm::PW / 2], pa[kt],
                         make_desc(vrow + p * Gm::PANEL, Gm::PANEL, 8 * Gm::RB, Gm::LAYOUT));
      constexpr int pl = Gm::PANELS - 1;
      wgmma_rs<Gm::LASTW>(&acc[pl * Gm::PW / 2], pa[kt],
                          make_desc(vrow + pl * Gm::PANEL, Gm::PANEL, 8 * Gm::RB, Gm::LAYOUT));
    }
    wgmma_commit();
  };
  // the mask, the online softmax of one tile's scores, P as the A fragments
  // of P V (k step t covers n tiles 2t and 2t + 1) and the accumulator's
  // correction
  auto softmax = [&](float (&sc)[32], int k0, uint32_t (&pa)[BK / 16][4], float (&corr)[2]) {
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > wrow)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k_pos = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        const int q_pos = wrow + grp + ((i >> 1) & 1) * 8;
        if (k_pos >= Skv || (causal && k_pos > q_pos)) sc[i] = NEG_INF;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    float msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      msc[r] = mx[r] * scale_log2;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = ex2(fmaf(sc[4 * n], scale_log2, -msc[0]));
      const float p1 = ex2(fmaf(sc[4 * n + 1], scale_log2, -msc[0]));
      const float p2 = ex2(fmaf(sc[4 * n + 2], scale_log2, -msc[1]));
      const float p3 = ex2(fmaf(sc[4 * n + 3], scale_log2, -msc[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  };

  float sc[32] = {};
  uint32_t pa[BK / 16][4];
  float corr[2];
  int it = 0;  // tiles consumed so far, over all items: the ring's position
  for (int k = 0; item_of(k) < items; ++k) {
    int q0, h, b, tiles;
    decode(item_of(k), q0, h, b, tiles);
    const int row0 = q0 + 64 * w;
    wrow = row0 + 16 * warp;
    const int kv_end_w = causal ? min(Skv, min(row0 + 64, Sq)) : Skv;
    const int tiles_w = (kv_end_w + BK - 1) / BK;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.0f;
    auto stage = [&](int j) { return (it + j) % ST; };
    auto phase = [&](int j) { return ((it + j) / ST) & 1; };

    // software pipeline (FlashAttention-3's within one warpgroup): the scores
    // of tile j are computed while P V of tile j - 1 runs on the tensor cores;
    // Q goes back to the loader after the item's last S
    mbar_wait(full_q, k & 1);
    mbar_wait(full_k(stage(0)), phase(0));
    issue_s(sc, stage(0));
    wgmma_wait<0>();
    fence_regs(sc);
    release(empty_k(stage(0)));
    if (tiles_w == 1) release(empty_q);
    softmax(sc, 0, pa, corr);
    for (int j = 1; j < tiles_w; ++j) {
      const int s = stage(j);
      const int sp = stage(j - 1);
      mbar_wait(full_k(s), phase(j));
      mbar_wait(full_v(sp), phase(j - 1));
      issue_s(sc, s);
      issue_pv(pa, sp);
      wgmma_wait<1>();  // S of tile j is done; P V of tile j - 1 may run on
      fence_regs(sc);
      release(empty_k(s));
      if (j == tiles_w - 1) release(empty_q);
      uint32_t pn[BK / 16][4];
      softmax(sc, j * BK, pn, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);  // the in-flight product read pa: keep it live until here
      release(empty_v(sp));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int u = 0; u < BK / 16; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[u][e] = pn[u][e];
    }
    mbar_wait(full_v(stage(tiles_w - 1)), phase(tiles_w - 1));
    issue_pv(pa, stage(tiles_w - 1));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release(empty_v(stage(tiles_w - 1)));
    // tiles past this warpgroup's last row (causal): handed back unread
    for (int j = tiles_w; j < tiles; ++j) {
      mbar_wait(full_k(stage(j)), phase(j));
      release(empty_k(stage(j)));
      mbar_wait(full_v(stage(j)), phase(j));
      release(empty_v(stage(j)));
    }
    it += tiles;

    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-30f);
    }
    bf16* op = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wrow + grp + 8 * half;
        if (r < Sq)
          *reinterpret_cast<uint32_t*>(op + r * oss + 8 * n + 2 * tig) = pack_bf16(
              acc[4 * n + 2 * half] / denom[half], acc[4 * n + 2 * half + 1] / denom[half]);
      }
    }
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

// ---- fp32: FMAs from shared memory
namespace f32 {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int RI = BQ / 16;   // rows per thread
constexpr int CJ = BK / 16;   // score columns per thread

template <int HD>
constexpr size_t smem_bytes() {
  // Qs: BQ x (HD + 1), Kt: HD x (BK + 1), Vs: BK x HD, Ps: BQ x (BK + 1);
  // the +1 columns keep the transposing stores and the row reads off one bank
  return sizeof(float) *
         (BQ * (HD + 1) + HD * (BK + 1) + BK * HD + BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o, int G, int Sq, int Skv,
         long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
         long long kss, long long vsb, long long vsh, long long vss, long long osb,
         long long osh, long long oss, int causal, float scale) {
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
  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + (h / G) * ksh;
  const float* vp = v + b * vsb + (h / G) * vsh;
  float* op = o + b * osb + h * osh;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int gq = q0 + r;
    Qs[r * (HD + 1) + d] = gq < Sq ? qp[gq * qss + d] : 0.0f;
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
      Kt[d * (BK + 1) + r] = in ? kp[gk * kss + d] : 0.0f;
      Vs[r * HD + d] = in ? vp[gk * vss + d] : 0.0f;
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
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
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
      op[gq * oss + tx + 16 * jj] = acc[i][jj] / denom;
  }
}

}  // namespace f32

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int Sq, int Skv, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  if constexpr (sizeof(T) == 2) {
    // TMA: every start and (batch, head, row) stride 16-byte aligned
    const uintptr_t starts = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    if (starts % 16) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 12; ++i)
      if (st[i] % 8) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tq, tk, tv;
    if (!make_map<HD>(&tq, q, Sq, H, B, st[0], st[1], st[2]) ||
        !make_map<HD>(&tk, k, Skv, KV, B, st[3], st[4], st[5]) ||
        !make_map<HD>(&tv, v, Skv, KV, B, st[6], st[7], st[8]))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows_first = (st[2] <= st[1]) | ((st[5] <= st[4]) << 1) | ((st[8] <= st[7]) << 2);
    constexpr int bytes = Geo<HD>::SMEM;
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    // longest first across every (batch, head) while all of K and V fit in
    // L2; else one head's q tiles together, sharing its K and V there
    int dev = 0;
    int l2 = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    const int q_slow = 4LL * B * KV * Skv * HD <= l2;
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long items = static_cast<long long>((Sq + BQ - 1) / BQ) * H * B;
    const int grid = static_cast<int>(items < sms ? items : sms);  // one block per SM
    attn_fwd_wgmma<HD><<<grid, THREADS, bytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(o), G, H, B, Sq, Skv, st[9], st[10], st[11], causal,
        rows_first, q_slow, scale * LOG2E);
  } else {
    constexpr size_t bytes = f32::smem_bytes<HD>();
    const cudaError_t err = cudaFuncSetAttribute(
        f32::attn_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + f32::BQ - 1) / f32::BQ, H, B);
    f32::attn_fwd<HD><<<grid, f32::THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), G, Sq, Skv, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int Sq, int Skv, const long long* st, int causal,
              float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 112: return launch<T, 112>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Skv, st, causal, scale, s);
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
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Skv, strides, causal, scale, s);
  if (dtype == 1)
    return launch_hd<bf16>(hd, q, k, v, o, B, H, KV, Sq, Skv, strides, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
