// ibn_pointwise: y = act(x @ w + b) for Hopper (sm_90a), fp32 or bf16 in,
// fp32 accumulation, bias and activation fused into the epilogue, y in x's
// type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ibn_conv.py:49
// (ibn_pointwise, _pw_kernel). The TPU version walks an (nn, nf, nk) grid in
// order and carries the fp32 sum over Cin tiles in VMEM scratch. Here a block
// owns one BM x BN output tile and one range of K; nothing is carried between
// launches, and a product is one launch whatever its K.
//
// What bounds it on an H100: the convnets' 1x1 products are thin (Cin and
// Cout from 4 to 1280) with many rows (batch x H x W pixels). At the search's
// proxy size (32 px, batch 64) the 36 shapes' forwards move 0.1-4 MB each and
// their bounds sum to 16 us, under 1 us each; what a launch costs is latency:
// how many SMs it reaches, how long one block's serial chain of loads and
// products is, and the epilogue. The backward's dw = x^T dz has M = Cin,
// N = Cout and K = every pixel (16384 at the proxy, 100352 at 224 px), a few
// output tiles over a long K.
//
// Design:
//   * One launch per product. A product whose output tiles cannot fill the
//     card splits K across the CTAs of a thread-block cluster (2 to 16, the
//     planner in ibn_conv.py chooses). Each CTA accumulates its K range in
//     registers, writes the partial tile to its own shared memory, and after
//     a cluster barrier CTA r sums rows r*BM/S.. of the tile over the S
//     partials through distributed shared memory, in rank order 0..S-1 (so
//     the sum is deterministic), and applies bias, act and the store. No
//     workspace, no second launch.
//   * Asynchronous loads. Operands come through TMA (2-d maps) into a ring of
//     stages, each with an mbarrier that the copy completes; one thread issues
//     the copies, every thread waits on the barrier, and a block barrier after
//     each step hands its stage back. Tiles are panels of 128-byte rows in
//     TMA's 128-byte swizzle, so the fragment loads below read without bank
//     conflicts (K-major) or with two-way ones (MN-major). TMA zero-fills rows
//     and columns past the tensor's edges. A map needs unit stride along one
//     axis and 16-byte-aligned strides and start; the wrapper copies an
//     operand that has not (EfficientNet's squeeze-excite convs have 6 and 10
//     channels), the main path's operands never.
//   * Products on the tensor cores, warp-level mma.sync (see Tile for how the
//     warps share a tile). Fragments are loaded from shared memory in either
//     layout, so x, w, their transposes and dz all go in as they lie: wgmma
//     reads tf32 only K-major, and w (Cin, Cout) and both operands of dw are
//     MN-major. bf16: m16n8k16 directly. fp32: 3xTF32 on m16n8k8: each
//     operand v is split into its tf32 part hi and the rest lo = v - hi, and
//     a product is lo*hi + hi*lo + hi*hi in fp32, which keeps about 21 bits
//     of each operand (plain TF32: 10). Every 4 K steps' products sum in
//     a fresh accumulator that is then added to the running sum in fp32, so
//     the tensor cores' accumulation covers 128 (bf16: 256) terms, not all K;
//     the kernel stays within 1e-4 of fp32 up to dw's K = 100352.
//   * With split K, or warps along K, the epilogue goes through shared memory
//     (the idle ring): the partial tiles of the warps, and of the cluster's
//     CTAs, are summed in a fixed order, then bias and act are applied and y
//     is stored in 16-byte pieces of whole rows. Otherwise each lane stores
//     its accumulators' pairs of columns from registers.
//
// Every mbarrier wait traps after about 2 s (hopper.cuh) instead of spinning
// on a fault of the protocol. PERF.md has the kernel's device times against
// torch.addmm / torch.mm at the search's and the full-width models' shapes,
// and what bounds it there: the time of a K step of the 3xTF32 products on
// one CTA, since a dw with one to three output tiles walks its K on at most
// 16 CTAs each (a cluster's limit).
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int RING = 65536;      // bytes of the load ring
constexpr int MAX_DEVICES = 64;  // devices a process launches on, for the launch cache
constexpr int PROMOTE = 4;       // K steps the tensor cores sum before acc takes them

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int PW = 32;  // elements in a 128-byte panel row
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elem<bf16> {
  static constexpr int PW = 64;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// A (M x K) and B (K x N) tiles of one stage, KP panels of K deep. A K-major
// operand's tile is KP panels of BM (or BN) rows of PW elements; an MN-major
// one's is BM/PW (BN/PW) panels of BK rows of PW elements. 4 warps split a
// 64 x 64 tile 2 x 2 (each a 32 x 32 piece). On a 32 x 32 tile (fp32) each
// warp takes the whole tile and a K slice of 8 of each step (4 warps for a
// step of one panel, 8 for two), so that a warp has 8 independent
// accumulators and no fragment is loaded twice; the deeper step halves the
// block barriers and waits per K on a long K.
template <typename T, int BM, int BN, int KP>
struct Tile {
  static constexpr int PW = Elem<T>::PW;
  static constexpr int BK = PW * KP;  // K per stage
  static constexpr int A_BYTES = BM * BK * static_cast<int>(sizeof(T));
  static constexpr int B_BYTES = BN * BK * static_cast<int>(sizeof(T));
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING / STAGE;
  static constexpr int WM = BM >= 64 ? 2 : 1;  // warps along m, n and K
  static constexpr int WN = BN >= 64 ? 2 : 1;
  static constexpr int WK = BM >= 64 ? 1 : 4 * KP;
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int KSTEP = sizeof(T) == 4 ? 8 : 16;  // K of one mma
  static constexpr int MI = BM / WM / 16;               // m16 pieces per warp
  static constexpr int NI = BN / WN / 8;                // n8 pieces per warp
  static constexpr int RED_PITCH = BN + 4;  // floats per row of a partial tile
  static constexpr int RED_TILE = BM * RED_PITCH;  // floats of a partial tile
  static constexpr int RED_BYTES = WK * RED_TILE * 4;  // one per warp along K
  static constexpr int BODY = STAGES * STAGE > RED_BYTES ? STAGES * STAGE : RED_BYTES;
  static constexpr int SMEM = BODY + 1024 + 8 * STAGES;  // + alignment, barriers
  static_assert(BM % PW == 0 && BN % PW == 0, "MN-major tiles are whole panels");
  static_assert(BK % (KSTEP * WK) == 0, "the warps along K cover a stage's K");
};

// byte offset of element (r, k) of an operand tile of ROWS rows (r is m for
// A, n for B) and BK of K: K-major, panel k / PW holds rows r and columns
// k % PW; MN-major, panel r / PW holds rows k and columns r % PW. 128-byte
// swizzle: the 16-byte chunk c of row q sits at chunk c ^ (q % 8).
template <typename T, int ROWS, int BK, bool KMAJ>
__device__ __forceinline__ uint32_t tile_off(int r, int k) {
  constexpr int PW = Elem<T>::PW;
  const int panel = KMAJ ? k / PW : r / PW;
  const int q = KMAJ ? r : k;
  const int c = (KMAJ ? k % PW : r % PW) * static_cast<int>(sizeof(T));
  return static_cast<uint32_t>(panel * (KMAJ ? ROWS : BK) * 128 + q * 128 +
                               ((((c >> 4) ^ (q & 7)) << 4) | (c & 15)));
}

// act: 0 none, 1 relu, 2 silu
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v / (1.0f + expf(-v));
  return v;
}

// two bf16 of one tile as a register: (r, k) and the element one k on; a
// K-major tile holds them side by side, an MN-major one in two rows
template <int ROWS, int BK, bool KMAJ>
__device__ __forceinline__ uint32_t pair_bf16(const uint8_t* t, int r, int k) {
  if constexpr (KMAJ) {
    return *reinterpret_cast<const uint32_t*>(t + tile_off<bf16, ROWS, BK, true>(r, k));
  } else {
    const uint32_t lo =
        *reinterpret_cast<const uint16_t*>(t + tile_off<bf16, ROWS, BK, false>(r, k));
    const uint32_t hi =
        *reinterpret_cast<const uint16_t*>(t + tile_off<bf16, ROWS, BK, false>(r, k + 1));
    return lo | (hi << 16);
  }
}

// the products of one stage into the warp's accumulators; (wm, wn) is the
// warp's piece in the tile, wk its share of the stage's K
template <typename T, int BM, int BN, int KP, bool AK, bool BK_>
__device__ __forceinline__ void stage_products(const uint8_t* a, const uint8_t* b,
                                               float (&acc)[Tile<T, BM, BN, KP>::MI]
                                                           [Tile<T, BM, BN, KP>::NI][4],
                                               int wm, int wn, int wk, int grp, int tig) {
  using G = Tile<T, BM, BN, KP>;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int kq = 0; kq < G::BK / (8 * G::WK); ++kq) {
      const int kk = (kq * G::WK + wk) * 8;
      uint32_t ah[G::MI][4], al[G::MI][4], bh[G::NI][2], bl[G::NI][2];
#pragma unroll
      for (int i = 0; i < G::MI; ++i) {
        const int m = wm + 16 * i + grp;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m + 8 * (e & 1);
          const int k = kk + tig + 4 * (e >> 1);
          split(*reinterpret_cast<const float*>(a + tile_off<float, BM, G::BK, AK>(r, k)),
                ah[i][e], al[i][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < G::NI; ++j) {
        const int n = wn + 8 * j + grp;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split(*reinterpret_cast<const float*>(
                    b + tile_off<float, BN, G::BK, BK_>(n, kk + tig + 4 * e)),
                bh[j][e], bl[j][e]);
      }
      // pass-major, so that consecutive mma write different accumulators and
      // none waits for the one before it
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  } else {
#pragma unroll
    for (int kq = 0; kq < G::BK / (16 * G::WK); ++kq) {
      const int kk = (kq * G::WK + wk) * 16;
      uint32_t af[G::MI][4], bf[G::NI][2];
#pragma unroll
      for (int i = 0; i < G::MI; ++i) {
        const int m = wm + 16 * i + grp;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          af[i][e] = pair_bf16<BM, G::BK, AK>(a, m + 8 * (e & 1), kk + 2 * tig + 8 * (e >> 1));
      }
#pragma unroll
      for (int j = 0; j < G::NI; ++j) {
        const int n = wn + 8 * j + grp;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bf[j][e] = pair_bf16<BN, G::BK, BK_>(b, n, kk + 2 * tig + 8 * e);
      }
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
}

// One CTA: output tile (blockIdx.x / splits) of tiles_m x tiles_n (m fastest),
// K range [rank * k_chunk, (rank + 1) * k_chunk) of a cluster of `splits`.
template <typename T, int BM, int BN, int KP, bool AK, bool BK_>
__global__ void __launch_bounds__(Tile<T, BM, BN, KP>::THREADS)
ibn_pw(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
       const T* __restrict__ bias, T* __restrict__ y, int M, int K, int N, int tiles_m,
       int splits, int k_chunk, int act) {
  using G = Tile<T, BM, BN, KP>;
  constexpr int ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // every panel on a 1024-byte boundary (the 128-byte swizzle's atom); the
  // same offsets in every CTA of a cluster
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + G::BODY;
  auto full = [&](int s) { return bars + 8 * s; };

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / splits;
  const int rank = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int m0 = (tile % tiles_m) * BM;
  const int n0 = (tile / tiles_m) * BN;
  const int k_begin = rank * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int nk = k_end > k_begin ? (k_end - k_begin + G::BK - 1) / G::BK : 0;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
    for (int s = 0; s < ST; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step kt of this CTA's K range into stage s
  const CUtensorMap* map_a = &ta;
  const CUtensorMap* map_b = &tb;
  auto issue = [&](int kt, int s) {
    const uint32_t a_dst = base + s * G::STAGE;
    const uint32_t b_dst = a_dst + G::A_BYTES;
    const int k0 = k_begin + kt * G::BK;
    mbar_expect(full(s), G::STAGE);
    if constexpr (AK) {
#pragma unroll
      for (int p = 0; p < KP; ++p)
        tma_load_2d(a_dst + p * BM * 128, map_a, k0 + p * G::PW, m0, full(s));
    } else {
#pragma unroll
      for (int p = 0; p < BM / G::PW; ++p)
        tma_load_2d(a_dst + p * G::BK * 128, map_a, m0 + p * G::PW, k0, full(s));
    }
    if constexpr (BK_) {
#pragma unroll
      for (int p = 0; p < KP; ++p)
        tma_load_2d(b_dst + p * BN * 128, map_b, k0 + p * G::PW, n0, full(s));
    } else {
#pragma unroll
      for (int p = 0; p < BN / G::PW; ++p)
        tma_load_2d(b_dst + p * G::BK * 128, map_b, n0 + p * G::PW, k0, full(s));
    }
  };
  if (tid == 0)
    for (int s = 0; s < ST && s < nk; ++s) issue(s, s);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wk = G::WK > 1 ? warp / (G::WM * G::WN) : 0;
  const int wm = (warp % G::WM) * (BM / G::WM);
  const int wn = (warp / G::WM % G::WN) * (BN / G::WN);
  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // every PROMOTE steps' products start from zero and are then added to acc
  // in fp32 (round to nearest): the tensor cores' own accumulation spans
  // PROMOTE steps' sum, not the whole of K
  float part[G::MI][G::NI][4];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    mbar_wait(full(s), (kt / ST) & 1);
    const uint8_t* a = sbase + s * G::STAGE;
    if (kt % PROMOTE == 0) {
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
    }
    stage_products<T, BM, BN, KP, AK, BK_>(a, a + G::A_BYTES, part, wm, wn, wk, grp, tig);
    if (kt % PROMOTE == PROMOTE - 1 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < G::MI; ++i)
#pragma unroll
        for (int j = 0; j < G::NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && kt + ST < nk) issue(kt + ST, s);
  }

  if (G::WK == 1 && splits == 1) {
    // ---- one warp per output element and no split: the epilogue from
    // registers. Lane (grp, tig) holds rows grp, grp + 8 and columns 2 tig,
    // 2 tig + 1 of each 16 x 8 piece, stored as a pair where y's rows allow
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm + 16 * i + grp + 8 * h;
          const int c = n0 + wn + 8 * j + 2 * tig;
          if (r >= M || c >= N) continue;
          float u0 = acc[i][j][2 * h];
          float u1 = acc[i][j][2 * h + 1];
          if (bias != nullptr) {
            u0 += to_f32(bias[c]);
            if (c + 1 < N) u1 += to_f32(bias[c + 1]);
          }
          u0 = apply_act(u0, act);
          u1 = apply_act(u1, act);
          T* yr = y + static_cast<long long>(r) * N + c;
          if (pairs) {
            if constexpr (sizeof(T) == 4) {
              *reinterpret_cast<float2*>(yr) = make_float2(u0, u1);
            } else {
              *reinterpret_cast<uint32_t*>(yr) = pack_bf16(u0, u1);
            }
          } else {
            yr[0] = from_f32<T>(u0);
            if (c + 1 < N) yr[1] = from_f32<T>(u1);
          }
        }
    return;
  }

  // ---- the epilogue through shared memory. Each warp's partial tile goes
  // there (the ring is idle: every stage was waited for and read), the warps
  // along K are summed in order, and with split K the CTAs of the cluster are
  // too: CTA r sums rows r * BM / splits .. of the tile over the ranks, 0
  // first, through distributed shared memory. Then bias, act and 16-byte
  // stores of whole rows.
  __syncthreads();
  float* red = reinterpret_cast<float*>(sbase);
  {
    float* mine = red + wk * G::RED_TILE;
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + 16 * i + grp + 8 * h;
          const int c = wn + 8 * j + 2 * tig;
          *reinterpret_cast<float2*>(mine + r * G::RED_PITCH + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
  }
  constexpr int C4 = BN / 4;
  if constexpr (G::WK > 1) {
    __syncthreads();
    for (int t = tid; t < BM * C4; t += G::THREADS) {
      float4* v = reinterpret_cast<float4*>(red + (t / C4) * G::RED_PITCH + 4 * (t % C4));
      float4 sum = *v;
#pragma unroll
      for (int q = 1; q < G::WK; ++q) {
        const float4 p = v[q * G::RED_TILE / 4];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      *v = sum;
    }
  }
  if (splits > 1)
    cluster_sync();  // every partial of the cluster is written
  else
    __syncthreads();
  const int rows = BM / splits;
  const bool vec = N % 4 == 0;  // y's rows start on 16 bytes (8 for bf16)
  for (int t = tid; t < rows * C4; t += G::THREADS) {
    const int r = rank * rows + t / C4;
    const int c = 4 * (t % C4);
    const int gr = m0 + r;
    const int gc = n0 + c;
    const uint32_t off = base + static_cast<uint32_t>((r * G::RED_PITCH + c) * 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < splits; ++q) {
      const float4 p = splits > 1 ? ld_cluster_f4(map_cluster(off, static_cast<uint32_t>(q)))
                                  : *reinterpret_cast<const float4*>(sbase + (off - base));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (gr >= M || gc >= N) continue;
    float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = min(gc + e, N - 1);
      if (bias != nullptr) u[e] += to_f32(bias[cc]);
      u[e] = apply_act(u[e], act);
    }
    T* yr = y + static_cast<long long>(gr) * N + gc;
    if (vec && gc + 4 <= N) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(yr) = make_float4(u[0], u[1], u[2], u[3]);
      } else {
        *reinterpret_cast<uint2*>(yr) = make_uint2(pack_bf16(u[0], u[1]), pack_bf16(u[2], u[3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gc + e < N) yr[e] = from_f32<T>(u[e]);
    }
  }
  if (splits > 1) cluster_sync();  // no CTA leaves while another still reads its partial
}

// a 2-d operand as a TMA map: `inner` elements with unit stride, `outer`
// rows `stride` elements apart, boxes of PW x box_rows in the 128-byte swizzle
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, long long inner, long long outer,
              long long stride, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride * static_cast<long long>(sizeof(T)))};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(Elem<T>::PW), static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, Elem<T>::TMA, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void* a;
  const void* b;
  const void* bias;
  void* y;
  int M, K, N;
  long long sa, sb;  // the outer stride of A and of B, in elements
  int act, splits, k_chunk;
};

template <typename T, int BM, int BN, int KP, bool AK, bool BK_>
int launch_cfg(const Args& g, cudaStream_t stream) {
  using G = Tile<T, BM, BN, KP>;
  auto kernel = ibn_pw<T, BM, BN, KP, AK, BK_>;
  // the shared-memory limit and the cluster-size attribute, set at the first
  // launch on each device, so later launches ask the driver nothing
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  CUtensorMap ta, tb;
  // A (M x K): K-major, rows m of K elements; else rows k of M elements.
  // B (K x N): K-major, rows n of K elements; else rows k of N elements.
  const bool ok = (AK ? make_map<T>(&ta, g.a, g.K, g.M, g.sa, BM)
                      : make_map<T>(&ta, g.a, g.M, g.K, g.sa, G::BK)) &&
                  (BK_ ? make_map<T>(&tb, g.b, g.K, g.N, g.sb, BN)
                       : make_map<T>(&tb, g.b, g.N, g.K, g.sb, G::BK));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = (g.M + BM - 1) / BM;
  const long long blocks =
      static_cast<long long>(tiles_m) * ((g.N + BN - 1) / BN) * g.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, static_cast<const T*>(g.bias),
                           static_cast<T*>(g.y), g.M, g.K, g.N, tiles_m, g.splits, g.k_chunk,
                           g.act);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM, int BN, int KP>
int launch_layout(const Args& g, int a_kmajor, int b_kmajor, cudaStream_t s) {
  if (a_kmajor && b_kmajor) return launch_cfg<T, BM, BN, KP, true, true>(g, s);
  if (a_kmajor) return launch_cfg<T, BM, BN, KP, true, false>(g, s);
  if (b_kmajor) return launch_cfg<T, BM, BN, KP, false, true>(g, s);
  return launch_cfg<T, BM, BN, KP, false, false>(g, s);
}

}  // namespace

// dtype: 0 fp32, 1 bf16. y = act(a @ b + bias): a (M, K) with outer stride sa
// (rows m when a_kmajor, else rows k), b (K, N) with outer stride sb (rows n
// when b_kmajor, else rows k), bias (N,) or null, y a contiguous (M, N).
// tile: 0 for 64 x 64, 1 for 32 x 32, 2 for 32 x 32 with K steps of two
// panels (1 and 2: fp32 only). splits: CTAs per cluster along K (1, 2, 4, 8
// or 16), each taking k_chunk of K (a multiple of the K step: 32 for fp32
// tiles 0 and 1, 64 for the others). Returns a CUDA error code (0 when the
// launch was accepted).
extern "C" int ibn_pointwise_launch(int dtype, const void* a, const void* b, const void* bias,
                                    void* y, int M, int K, int N, long long sa, long long sb,
                                    int a_kmajor, int b_kmajor, int act, int tile, int splits,
                                    int k_chunk, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > 16 || (splits & (splits - 1)) ||
      k_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{a, b, bias, y, M, K, N, sa, sb, act, splits, k_chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tile == 0) return launch_layout<float, 64, 64, 1>(g, a_kmajor, b_kmajor, s);
  if (dtype == 0 && tile == 1) return launch_layout<float, 32, 32, 1>(g, a_kmajor, b_kmajor, s);
  if (dtype == 0 && tile == 2) return launch_layout<float, 32, 32, 2>(g, a_kmajor, b_kmajor, s);
  if (dtype == 1 && tile == 0) return launch_layout<bf16, 64, 64, 1>(g, a_kmajor, b_kmajor, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// whether a cluster of 16 CTAs of this body fits on the current device (0 or
// 1), or a negative CUDA error code
template <typename T, int BM, int BN, int KP>
int fits_16() {
  using G = Tile<T, BM, BN, KP>;
  auto kernel = ibn_pw<T, BM, BN, KP, false, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return 0;
  }
  return clusters >= 1 ? 1 : 0;
}

// the largest cluster (8 or 16 CTAs) a split-K launch may use on the current
// device, for every body, or a negative CUDA error code
extern "C" int ibn_pointwise_max_cluster() {
  const int fits[4] = {fits_16<float, 64, 64, 1>(), fits_16<float, 32, 32, 1>(),
                       fits_16<float, 32, 32, 2>(), fits_16<bf16, 64, 64, 1>()};
  for (int f : fits)
    if (f < 0) return f;
  return fits[0] && fits[1] && fits[2] && fits[3] ? 16 : 8;
}
