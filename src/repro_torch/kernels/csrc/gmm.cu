// gmm: the grouped (per-expert) matmul y[e] = x[e] @ w[e] for Hopper
// (sm_90a). x (E, C, D), w (E, D, F), fp32 or bf16 in, fp32 accumulation,
// y (E, C, F) in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm.py:44 (gmm,
// _gmm_kernel), which the MoE layer's expert products compute
// (repro/models/moe.py::expert_ffn, the three "ecd,edf->ecf" einsums over the
// dispatch buffers). The TPU version walks an (E, C/bc, F/bf, D/bd) grid with
// the contraction axis sequential and an fp32 accumulator in VMEM scratch;
// here one launch covers every expert and a block runs the whole D loop of
// an output tile with the accumulator in registers, so nothing is carried
// between blocks.
//
// Two bodies, chosen by the launcher from the type:
//   bf16: wgmma with TMA and warp specialisation, persistent. One CTA per SM
//         walks output tiles expert-major (the C tiles fastest, then the F
//         tiles, then the expert), so the CTAs in flight share about four
//         experts' x and w in L2. Warpgroup 0 loads: one thread issues TMA
//         copies of K steps of 64 into a ring of stages, each with a "full"
//         mbarrier (TMA bytes) and an "empty" one (one arrival per consumer
//         warp that reads it); the ring runs on across tiles, so the next
//         tile's first steps land while this tile's epilogue stores. Each
//         operand's map is 3-d over its own layout, the axis of unit stride
//         first, E last, so a box never crosses an expert, and TMA
//         zero-fills past C, D and F; boxes are 64 elements of that axis in
//         the 128-byte swizzle. Its layout is a template argument, and the
//         wgmma descriptors and transpose bits follow it:
//           x K-major (D contiguous, the forward's and dx's dy): a step is a
//             box of 64 columns of D by the tile's rows; x MN-major (C
//             contiguous: dw's xᵀ, a transposed view of the saved x): a box
//             of 64 rows by 64 of D per consumer warpgroup;
//           w MN-major (F contiguous, the MoE layer's weights and dw's dy): a
//             step is BN/64 boxes of 64 columns by 64 rows of D; w K-major (D
//             contiguous: dx's wᵀ, a transposed view of the weight): CL
//             boxes of 64 columns of D by BN/CL rows of F.
//         So the backward's products read wᵀ and xᵀ where they lie: the
//         copies of them that an earlier design made (2.08 of its 2.85 ms at
//         the training shapes) are gone. The consumer warpgroups run
//         wgmma.m64nNk16 (bf16 in, fp32 accumulate) with A and B from shared
//         memory, one commit group per step, keeping one group in flight
//         while the step before it goes back to the loader. The epilogue
//         stores bf16 from registers: a transpose across each quad of lanes
//         (two shfl.xor rounds) gives each lane 8 consecutive columns,
//         stored as 16 bytes, masking rows past C and columns past F. Two
//         shapes:
//           C > 64: 128 x 256 tiles, two consumer warpgroups of 64 rows
//             (setmaxnreg moves registers from the loader to them), 4
//             stages of 48 KB, in clusters of two CTAs that take two C tiles
//             of one expert and F tile: each loads its x box and half of the
//             w boxes, which TMA multicasts into both, so a stage's empty
//             barrier counts the consumer warps of both CTAs, and a loader
//             waits for the last stages to come back before it leaves (its
//             partner still signals its barriers). When C is one tile (65 to
//             128 rows) the partner multiplies zeros;
//           C <= 64 (decode: C = 32 at batch 8): 64 x 128 tiles, one consumer
//             warpgroup, no cluster, 9 stages of 24 KB. That product is bound
//             by bytes (w is 346 MB at qwen2-moe-a2.7b's shape, x 8 MB): what
//             matters is w in flight on every SM, 8 stages of 16 KB of w per
//             SM, over twice what the memory's rate times its latency asks
//             for. The rows past C are zeros that wgmma multiplies at no cost
//             in bytes; swapping A and B (F as the 64 rows) would fill them
//             but put x, not w, in the ring's wide boxes and add a transposed
//             epilogue, for no bytes saved. At C = 32 the tensor work is 2x
//             what the product needs and still 1/5 of the byte bound.
//         It takes operands TMA can describe: unit stride along either of
//         the last two axes, the other strides positive multiples of 8
//         elements (16 bytes), 16-byte-aligned starts, and F a multiple of 8
//         (the epilogue's 16-byte stores into y's rows); the wrapper (gmm.py)
//         copies other bf16 operands into zero-padded contiguous ones first.
//         Every mbarrier wait traps after about 2 s (mbar_wait) instead of
//         spinning on a fault of the protocol: the trap ends the process's
//         CUDA context (every later CUDA call of that process fails), not
//         one launch. The tile width and cluster of the C > 64 body won
//         the comparisons in PERF.md (128 wide, and no cluster, lost);
//   fp32: ibn_pointwise's 64 x 64 tile of fp32 FMAs (4 x 4 outputs per
//         thread, K steps of 16), with the expert as the grid's z index.
//         Operands are read through their (expert, row, column) strides, so
//         strided views need no copy; ragged C, D and F are masked in the
//         loaders (zeros past the edge) and the store. No TF32: fp32 stays
//         fp32.
//
// What bounds it on an H100: qwen2-moe-a2.7b's prefill of 8 x 1024 tokens
// gives (60, 688, 2048) @ (60, 2048, 1408) in bf16 (gate and up; down is
// (60, 688, 1408) @ (60, 1408, 2048)), 238 GFLOP against 0.63 GB: bound by
// operations, 0.24 ms at the bf16 tensor-core peak. Decode at batch 8 gives
// C = 32: 11 GFLOP against 0.35 GB of weights, bound by bytes, 0.10 ms. The
// first version of this kernel (mma.sync m16n8k16, 128 x 128 tiles copied
// with cp.async through a 3-stage ring, a block per tile) took 1.13 ms and
// 0.18 ms there; this one about 0.39 ms and 0.13 ms, against 0.35 ms and
// 0.12 ms for torch.bmm (PERF.md). What bounds the prefill products now: a
// build that skips the output stores is 3% faster, and the 128 x 256 tiles
// compute 768 x 1536 outputs of each expert's 688 x 1408 (F = 1408 is 5.5
// tiles) for 82% useful work. The backward's two products at the training
// step's shapes take 0.36-0.42 ms each, dx + dw 0.73-0.80 ms against 0.68-0.76
// ms for two torch.bmm calls (scripts/backward_kernels.py, PERF.md): dw's
// contraction is C = 688, 11 steps of 64, so a tile's epilogue weighs more
// than in the forward: a build whose stores are never taken runs dw in 0.37
// ms against 0.44 (scripts/gmm_variants.py), the ring running on across
// tiles hiding the rest.
#include <cstdint>

#include "hopper.cuh"

namespace {

// ---- bf16 on wgmma, with TMA and warp specialisation
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;             // K per stage: a 128-byte row of bf16, the swizzle span
constexpr int PANEL = 64 * 128;    // bytes of a 64 x 64 box in the 128-byte swizzle
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use
constexpr int SMEM_EXTRA = 1024 + 256;  // alignment to 1024 bytes, barriers
// registers per thread after setmaxnreg (168 at launch with 384 threads):
// the loader gives up what the consumers take
constexpr int LOADER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MAX_DEVICES = 64;  // devices a process launches on, for launch_bf16's cache

// NC consumer warpgroups of 64 rows x BN, in clusters of CL CTAs along C;
// as many stages as shared memory holds
template <int NC, int BN, int CL>
struct Body {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PANELS = (BN + 63) / 64;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + PANELS * PANEL;
  static constexpr int STAGES = (SMEM_MAX - SMEM_EXTRA) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + SMEM_EXTRA;
  static_assert(PANELS % CL == 0, "each CTA of a cluster loads as many of w's boxes");
};

// the 4 x 4 transpose of 32-bit values across the 4 lanes of a quad: lane t
// holds v[0..3] = M[t][0..3] and gets M[0..3][t]
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int t) {
  // swap within lane pairs: the even lane keeps column 0 and 2 of its pair's
  // 2 x 2 blocks, the odd lane columns 1 and 3
  const bool odd = t & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  const uint32_t u0 = odd ? r0 : v[0];
  const uint32_t u1 = odd ? v[1] : r0;
  const uint32_t u2 = odd ? r1 : v[2];
  const uint32_t u3 = odd ? v[3] : r1;
  // swap the off-diagonal 2 x 2 blocks between lanes t and t ^ 2
  const bool high = t & 2;
  const uint32_t s0 = __shfl_xor_sync(0xffffffffu, high ? u0 : u2, 2);
  const uint32_t s1 = __shfl_xor_sync(0xffffffffu, high ? u1 : u3, 2);
  return high ? make_uint4(s0, s1, u2, u3) : make_uint4(u0, u1, s0, s1);
}

template <int N, int A_MN, int B_MN>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 128 || N == 256, "wgmma is written out for n128 and n256 only");
  if constexpr (N == 128) wgmma_ss_n128<A_MN, B_MN>(d, a, b, accumulate);
  if constexpr (N == 256) wgmma_ss_n256<A_MN, B_MN>(d, a, b, accumulate);
}

// A_MN: x is MN-major (unit stride along C, a transposed view); else K-major
// (unit stride along D). B_MN: w is MN-major (unit stride along F); else
// K-major (unit stride along D, a transposed view)
template <int NC, int BN, int CL, int A_MN, int B_MN>
__global__ void __launch_bounds__(Body<NC, BN, CL>::THREADS, 1)
gmm_bf16_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               bf16* __restrict__ y, int C, int F, int groups_c, int tiles_f, int groups,
               int nk) {
  using G = Body<NC, BN, CL>;
  constexpr int ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // every stage on a 1024-byte boundary (the 128-byte swizzle's atom); the
  // same offsets in every CTA of a cluster
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + ST * G::STAGE;
  auto a_at = [&](int s) { return base + s * G::STAGE; };
  auto b_at = [&](int s) { return base + s * G::STAGE + G::A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  // A cluster walks groups of CL C tiles that share an expert and an F tile
  // (group g: expert g / (groups_c * tiles_f), then the C tiles fastest);
  // rank r of the cluster takes the group's C tile r
  const int rank = CL > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int first = blockIdx.x / CL;
  const int stride = gridDim.x / CL;
  auto decode = [&](int g, int& e, int& m0, int& n0) {
    const int per_e = groups_c * tiles_f;
    e = g / per_e;
    const int r = g - e * per_e;
    m0 = ((r % groups_c) * CL + rank) * G::BM;
    n0 = (r / groups_c) * BN;
  };
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC * CL);  // one arrival per consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL > 1)
    cluster_sync();  // the partners' barriers exist before anyone signals them
  else
    __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread keeps the ring full. It loads its own x box,
    // and w's boxes p = rank, rank + CL, ... into every CTA of the cluster,
    // so a stage's empty barrier waits for the consumers of all of them
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOADER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;  // steps loaded so far, over all tiles: the ring's position
      for (int g = first; g < groups; g += stride) {
        int e, m0, n0;
        decode(g, e, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          mbar_expect(full(s), G::STAGE);
          // x: K-major, one box of 64 K columns by the tile's rows; MN-major,
          // a box of 64 rows (M, contiguous) by 64 K rows per warpgroup
          if constexpr (A_MN) {
#pragma unroll
            for (int p = 0; p < NC; ++p)
              tma_load_3d(a_at(s) + p * PANEL, &tx, m0 + 64 * p, kt * BK, e, full(s));
          } else {
            tma_load_3d(a_at(s), &tx, kt * BK, m0, e, full(s));
          }
          // w: MN-major, boxes p = rank, rank + CL, ... of 64 columns (N) by
          // 64 K rows; K-major, box `rank` of BN / CL rows (N) by 64 K
          // columns. Each goes to the same offset of every CTA of the cluster
          if constexpr (B_MN) {
#pragma unroll
            for (int p = rank; p < G::PANELS; p += CL) {
              if constexpr (CL > 1)
                tma_load_multicast_3d(b_at(s) + p * PANEL, &tw, n0 + 64 * p, kt * BK, e,
                                      full(s), (1 << CL) - 1);
              else
                tma_load_3d(b_at(s) + p * PANEL, &tw, n0 + 64 * p, kt * BK, e, full(s));
            }
          } else {
            constexpr int ROWS = BN / CL;
            if constexpr (CL > 1)
              tma_load_multicast_3d(b_at(s) + rank * ROWS * 128, &tw, kt * BK, n0 + rank * ROWS,
                                    e, full(s), (1 << CL) - 1);
            else
              tma_load_3d(b_at(s), &tw, kt * BK, n0, e, full(s));
          }
        }
      }
      // a cluster's CTAs signal each other's barriers: before leaving, wait
      // until every consumer of the cluster has handed back every stage
      if constexpr (CL > 1)
        for (int k = 0; k < ST; ++k, ++it) mbar_wait(empty(it % ST), ((it / ST) & 1) ^ 1);
    }
    return;
  }

  // ---- consumers: warpgroup w owns a tile's rows 64 w .. 64 w + 63 (rows
  // past C are zeros from TMA, multiplied and not stored)
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int w = wgi - 1;
  const int t128 = threadIdx.x - 128 * wgi;  // thread in the warpgroup
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  float acc[BN / 2];  // n8 tiles of the output, as mma.sync's C fragments
  // stage 0's descriptors. This warpgroup's 64 rows of A start PANEL bytes
  // into the stage per warpgroup in either layout (64 rows of 128 bytes, or
  // one 64-row-wide panel). A K-major operand is rows of 128 bytes of K, 8
  // rows a 1024-byte swizzle atom (SBO), and a k16 step is 32 bytes along
  // the row; an MN-major one is 64-element panels PANEL apart (LBO), K rows
  // of 128 bytes in 8-row atoms (SBO), and a k16 step is 16 rows, 2048
  // bytes. A stage or a k16 step adds its offset / 16.
  const uint64_t desc_a = make_desc(a_at(0) + w * PANEL, A_MN ? PANEL : 16, 1024);
  const uint64_t desc_b = make_desc(b_at(0), B_MN ? PANEL : 16, 1024);
  constexpr int A_STEP = A_MN ? 2048 / 16 : 32 / 16;
  constexpr int B_STEP = B_MN ? 2048 / 16 : 32 / 16;

  // hands stage s back to every CTA of the cluster (lane j of each warp
  // signals rank j): all of them wrote into it
  auto release = [&](int s) {
    __syncwarp();
    if constexpr (CL > 1) {
      if (lane < CL) mbar_arrive_cluster(empty(s), lane);
    } else if (lane == 0) {
      mbar_arrive(empty(s));
    }
  };

  int it = 0;  // steps consumed so far, over all tiles: the ring's position
  for (int g = first; g < groups; g += stride) {
    int e, m0, n0;
    decode(g, e, m0, n0);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % ST;
      mbar_wait(full(s), (it / ST) & 1);
      fence_regs(acc);
      wgmma_fence();
      const uint64_t so = (s * G::STAGE) >> 4;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma<BN, A_MN, B_MN>(acc, desc_a + so + kk * A_STEP, desc_b + so + kk * B_STEP,
                              kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the step before this one is done with its stage
      fence_regs(acc);
      if (kt > 0) release((it - 1) % ST);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release((it - 1) % ST);

    // the epilogue: lane tig of a quad holds columns 2 tig, 2 tig + 1 of
    // each 8-column block of its rows; a 4 x 4 transpose across the quad
    // (two shfl.xor rounds) gives it all 8 columns of block 4 q + tig, so
    // each lane stores 16 bytes and a warp 64 contiguous bytes per row
    const int row0 = m0 + 64 * w + 16 * warp + grp;
    bf16* ye = y + static_cast<long long>(e) * C * F;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      bf16* yr = ye + static_cast<long long>(r < C ? r : 0) * F;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pack_bf16(acc[4 * (4 * q + j) + 2 * half], acc[4 * (4 * q + j) + 2 * half + 1]);
        const uint4 out = quad_transpose(v, tig);
        const int col = n0 + 8 * (4 * q + tig);
        if (r < C && col < F) *reinterpret_cast<uint4*>(yr + col) = out;
      }
    }
  }
}

// a bf16 operand as a 3-d TMA map (inner, outer, expert) over its own
// layout: `inner` the axis of unit stride, `s_outer` and `s_expert` the
// other two axes' element strides; 64-element x box_rows boxes in the
// 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int experts,
              long long s_row, long long s_expert, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(experts)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * s_row),
                           static_cast<cuuint64_t>(2 * s_expert)};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BN, int CL, int A_MN, int B_MN>
int launch_bf16(const void* x, const void* w, void* y, int E, int C, int D, int F,
                const long long* s, cudaStream_t stream) {
  using G = Body<NC, BN, CL>;
  CUtensorMap tx, tw;
  // x (E, C, D): (D, C, E) boxes of 64 x BM, or MN-major (C, D, E) of 64 x 64;
  // w (E, D, F): (F, D, E) boxes of 64 x 64, or K-major (D, F, E) of 64 x BN / CL
  const bool ok = (A_MN ? make_map(&tx, x, C, D, E, s[2], s[0], 64)
                        : make_map(&tx, x, D, C, E, s[1], s[0], G::BM)) &&
                  (B_MN ? make_map(&tw, w, F, D, E, s[4], s[3], 64)
                        : make_map(&tw, w, D, F, E, s[5], s[3], BN / CL));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int groups_c = ((C + G::BM - 1) / G::BM + CL - 1) / CL;
  const int tiles_f = (F + BN - 1) / BN;
  const long long groups = static_cast<long long>(E) * groups_c * tiles_f;
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gmm_bf16_wgmma<NC, BN, CL, A_MN, B_MN>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  // the clusters that fit on each device at once (one CTA per SM), found at
  // the first launch there together with the shared-memory limit, so the
  // model's launches (72 a prefill, 72 a decode step) ask the driver nothing
  // more; 0: not asked yet
  static int clusters_on[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (clusters_on[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = sms / CL;
    if (CL > 1) {
      cfg.gridDim = dim3(clusters * CL);
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    clusters_on[dev] = clusters;
  }
  const int clusters = clusters_on[dev];
  cfg.gridDim = dim3(CL * static_cast<int>(groups < clusters ? groups : clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, static_cast<bf16*>(y), C, F, groups_c,
                           tiles_f, static_cast<int>(groups), (D + BK - 1) / BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---- fp32 FMA (ibn_pointwise's tile loop with an expert index)
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int FMA_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(FMA_THREADS)
gmm_f32_fma(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
            int C, int D, int F, long long sxe, long long sxc, long long sxd, long long swe,
            long long swd, long long swf) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int e = blockIdx.z;
  const float* xe = x + e * sxe;
  const float* we = w + e * swe;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool a_k_fast = (sxd == 1);
  const bool b_n_fast = (swf == 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // one K step's loads go into registers (all in flight at once) and are
  // stored to shared memory; the next step's loads are issued before this
  // step's products, so their latency overlaps the math
  constexpr int LA = BM * BK / FMA_THREADS;
  constexpr int LB = BK * BN / FMA_THREADS;
  float ra[LA];
  float rb[LB];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * FMA_THREADS;
      const int gm = m0 + (a_k_fast ? idx / BK : idx % BM);
      const int gk = k0 + (a_k_fast ? idx % BK : idx / BM);
      ra[l] = (gm < C && gk < D) ? xe[gm * sxc + gk * sxd] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * FMA_THREADS;
      const int gk = k0 + (b_n_fast ? idx / BN : idx % BK);
      const int gn = n0 + (b_n_fast ? idx % BN : idx / BK);
      rb[l] = (gk < D && gn < F) ? we[gk * swd + gn * swf] : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = tid + l * FMA_THREADS;
      As[a_k_fast ? idx % BK : idx / BM][a_k_fast ? idx / BK : idx % BM] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = tid + l * FMA_THREADS;
      Bs[b_n_fast ? idx / BN : idx % BK][b_n_fast ? idx % BN : idx / BK] = rb[l];
    }
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);
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

  float* ye = y + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < F) ye[static_cast<long long>(gm) * F + gn] = acc[i][j];
    }
  }
}

}  // namespace

namespace {

// the bf16 body at x's and w's layouts (x_t: x has unit stride along C, not
// D; w_t: w has unit stride along D, not F)
template <int NC, int BN, int CL>
int launch_layouts(int x_t, int w_t, const void* x, const void* w, void* y, int E, int C, int D,
                   int F, const long long* s, cudaStream_t st) {
  if (x_t && w_t) return wg::launch_bf16<NC, BN, CL, 1, 0>(x, w, y, E, C, D, F, s, st);
  if (x_t) return wg::launch_bf16<NC, BN, CL, 1, 1>(x, w, y, E, C, D, F, s, st);
  if (w_t) return wg::launch_bf16<NC, BN, CL, 0, 0>(x, w, y, E, C, D, F, s, st);
  return wg::launch_bf16<NC, BN, CL, 0, 1>(x, w, y, E, C, D, F, s, st);
}

// a TMA map describes the 3-d operand with strides s (expert, row, column)
// at this layout: unit stride along the column (t 0) or the row (t 1), the
// other two strides positive multiples of 8 elements (16 bytes)
bool tma_strides(const long long* s, int t) {
  const long long other = t ? s[2] : s[1];
  return s[t ? 1 : 2] == 1 && s[0] > 0 && other > 0 && s[0] % 8 == 0 && other % 8 == 0;
}

}  // namespace

// dtype: 0 fp32, 1 bf16. strides: 6 element strides, (expert, row, column)
// of x then of w; y is a contiguous (E, C, F) tensor. x_t, w_t: each bf16
// operand's layout, 0 with unit stride along its last axis, 1 along its
// middle one (a transposed view: dy @ w^T gives w_t 1, x^T @ dy x_t 1); the
// fp32 body reads any strides and ignores them. Returns a CUDA error code (0
// when the launch was accepted); bf16 operands that the bf16 body does not
// take return cudaErrorInvalidValue.
extern "C" int gmm_launch(int dtype, const void* x, const void* w, void* y, int E, int C,
                          int D, int F, const long long* strides, int x_t, int w_t,
                          void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || D <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // TMA: strides at the layouts given, 16-byte-aligned starts; F a
    // multiple of 8 for the epilogue's 16-byte stores
    const bool ok = tma_strides(s, x_t) && tma_strides(s + 3, w_t) && F % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
    if (!ok || (x_t != 0 && x_t != 1) || (w_t != 0 && w_t != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    if (C <= 64) return launch_layouts<1, 128, 1>(x_t, w_t, x, w, y, E, C, D, F, s, st);
    return launch_layouts<2, 256, 2>(x_t, w_t, x, w, y, E, C, D, F, s, st);
  }
  if (dtype == 0) {
    const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
    gmm_f32_fma<<<grid, FMA_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        C, D, F, s[0], s[1], s[2], s[3], s[4], s[5]);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
