// Fused 1x1-conv + BatchNorm forward for Hopper (sm_90a):
//
//     y[M,N]  = act(x * a + b) @ W          (act = relu when relu_in; the
//                                            prologue is skipped without a)
//     s1[N]   = sum over the M real rows of y      (f32)
//     s2[N]   = sum over the M real rows of y*y    (f32)
//
// with y in x's dtype and s1, s2 sums of the unrounded f32 product.  The
// prologue is folded in f32 and rounded to x's dtype before the product.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas/conv_bn.py
// (_fwd_impl -> _fwd_kernel), which runs the 1x1 convs of every ResNet-50
// bottleneck.  A 1x1 conv over NHWC is [N*H*W, Cin] @ [Cin, Cout].  That
// kernel walks M in order on one core and carries s1 and s2 in VMEM from one
// grid step to the next; here blocks run in parallel in no order, and the
// statistics are summed across blocks in a fixed order in the same launch.
//
// What bounds it on the H100: 2 M K N operations against M K + K N + M N
// elements moved.  f32 runs every product in three TF32 passes (the JAX
// kernel asks for Precision.HIGHEST: 165 TFLOP/s of f32-accurate work on the
// tensor cores, where the CUDA cores' FMA peak is 67), and most of
// ResNet-50's shapes are bound by those operations; bf16 (989 TFLOP/s) is
// bound by the bytes of x and y.
//
// What the design does about it: the GEMM core of gemm_sm90.cuh (one
// producer warpgroup: a TMA thread and 96 prep threads; two consumer
// warpgroups of 64 rows; wgmma fed by TMA through a ring of stages) on tiles
// of 128 rows x 128 columns, each contracting its share of K in 128-byte
// chunks (32 f32, 64 bf16 columns of x):
//
//   * Persistent blocks, one an SM at most (conv_bn.fwd_plan): a block keeps
//     one column tile and walks row tiles R apart, and its producer loads the
//     next tile's first stages while the consumers store the last one's y.
//     At ResNet-50's small K (64-256) a tile is a few stages, and a block per
//     tile spent most of its time starting and ending.
//   * A = xhat: the x tile and the chunk of a and b come by TMA, and the prep
//     threads fold the tile in place (x a + b with the plain version's
//     rounding points, relu; bf16 rounded to bf16 again), once per 128
//     columns of N.  bf16 wgmma reads A from shared memory; f32 takes each
//     lane's fragment by ldmatrix and splits it into TF32 hi and lo in
//     registers (a fold there too left the persistent loop no registers:
//     ptxas spilled it).
//   * B = W.  bf16 wgmma takes W [K, N] N-major as it is, two boxes of 64
//     columns a stage.  TF32 wgmma takes only a K-major B, so in f32 a small
//     kernel of this library (mbf_wt_kernel, launched first by the same
//     entry point) writes W^T [N, K'] once a call, every row tile reads it by
//     TMA (a transpose per stage would redo it in each of the M / 128 row
//     tiles), and the prep threads split each tile in place into TF32 hi and
//     lo (split halves in device memory would double W's traffic through L2,
//     which bounds the f32 loop beside the tensor cores).
//   * f32: three TF32 passes a product (mma3), the tile's 128 columns as two
//     halves of 64, each stage's half in a fresh tile added in f32 (the
//     tensor core's adds round toward zero, and chained over K that bias
//     would reach the f32 limit).  bf16: one pass, chained, one stage's
//     products in flight while the next stage's are issued.
//   * Split-K: where the (M, N) tiles do not fill one wave of the card's SMs,
//     a block takes one tile's share of the chunks instead; the last split of
//     a tile to arrive adds the partials in split order (gemm_sm90.cuh's
//     splitk_sum) before the epilogue, so y repeats bit for bit.
//   * Epilogue: s1 and s2 from the unrounded accumulator, over the tile's
//     rows by a reduce-scatter across each warp's lanes into running sums in
//     shared memory, then, once a block, over the blocks of a column tile by
//     two levels of arrival counts, each level in a fixed order
//     (col_sums_tables): the statistics come out of the one launch and repeat
//     bit for bit on a card.  y goes through a staging tile in shared memory
//     and out by TMA stores (from registers where its rows are no multiple of
//     16 bytes).  At K = 64 these two steps are most of a tile's time: with
//     three shuffles per sum and 4-byte stores from registers they took 7 of
//     the 8 us of a bf16 tile on the H100.
//
// Any K and N, any M: the TMA gives zeros past the tensors.  Past K, x, W
// and the chunk of a and b read zeros, so the tail folds to exactly 0 and
// never adds act(b) W.  Rows past M read zeros and fold to act(b): they are
// neither stored nor counted in s1 and s2.  Nothing past N is written.
//
// Requirements checked and met by the Python wrapper (conv_bn.py):
// contiguous row-major x (rows of ldx elements, a multiple of 16 bytes,
// zero past K) and W (bf16: rows of ldw elements, a multiple of 16 bytes,
// zero past N; f32: any ldw >= N), 16-byte aligned, a and b [K] f32 or
// null; the plan's blocks, K splits and the rows of its column-sum tables;
// its scratch, all in one f32 buffer: s1 and s2 [2, N], the column-sum
// tables [2, rows + groups, N], the partials [slices, M, N] when split, W^T
// [N, K'] in f32 (K' = K rounded up to 4), and n_counts int32 arrival
// counts, which the entry point zeroes.  Every entry point returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for tensor
// maps the CUDA driver refuses).

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int MF_BM = 128, MF_BN = 128;   // tile: rows of M, columns of N (one column-sum block)
constexpr int MF_SPLIT_GROUP = 8;         // K splits summed first in groups of this many
constexpr int MF_WT = 32;                 // the weight transpose's square tile

struct MfArgs {
  const float* a;       // [K] or null (no prologue)
  void* y;              // [M, N]
  float* part;          // [slices, M, N] (splits > 1)
  float* stats;         // [2, rows + groups, N]: column sums of each block, then group
  int* counts;          // zeros: split-K per tile (splits > 1), then the column sums'
  float* s1;            // [N]
  float* s2;            // [N]
  int M, N, K, chunks, splits, tiles_m, tiles_n, rows, relu_in;
  int tma_y;            // y's rows are a multiple of 16 bytes: y by TMA stores
};

struct alignas(64) MfMaps {
  CUtensorMap x;        // [M, ldx]: boxes [128 rows, 128 bytes]
  CUtensorMap w;        // bf16: W [K, ldw], boxes [64 rows, 128 bytes];
                        // f32: W^T [N, K'], boxes [128 rows, 128 bytes]
  CUtensorMap a, b;     // [K] f32: boxes of one chunk
  CUtensorMap y;        // [M, N] (tma_y): boxes [128 rows, 128 bytes]
  MfArgs p;
};

// Shared memory: ST stages of the x tile [128 rows, CK], the W tile (f32: W^T
// [128 rows of N, CK] split in place by prep, its lo beside it; bf16: [CK
// rows of K, 128 columns]) and a, b [CK]; the running column sums of the
// consumer warps; the y tile [128 rows, 128 columns] in the TMA's boxes of
// 128-byte rows; barriers.
template <bool F32>
struct MfSmem {
  static constexpr int CK = F32 ? 32 : 64;                 // K columns of a stage
  static constexpr int ST = F32 ? 3 : 4;
  static constexpr int A_TILE = MF_BM * 128, B_TILE = MF_BN * 128;
  static constexpr int B0 = A_TILE, AB0 = B0 + (F32 ? 2 : 1) * B_TILE;
  static constexpr int TX = A_TILE + B_TILE;               // the TMA's bytes, a and b aside
  static constexpr int STAGE = AB0 + 1024;
  static constexpr int RED = ST * STAGE;
  static constexpr int Y0 = RED + 2 * 8 * MF_BN * 4;
  static constexpr int BARS = Y0 + MF_BM * MF_BN * (F32 ? 4 : 2);
  static constexpr size_t BYTES = 1024 + BARS + 8 * 3 * ST;
};

// The column sums v of a 32-column quarter q of the tile over a thread's
// rows (v[i], i < 8: the sum of column 32 q + 8 (i >> 1) + 2 t + (i & 1); v[8
// + i]: of its squares) added over the warp's 8 g by a reduce-scatter, each
// step keeping half of the values and adding the partner's (14 shuffles,
// each sum in a fixed order), then to the warp's running sums in red
// ([2][8 warps][128]): lane g ends with values 8 b0 + 4 b1 + 2 b2 + i (b: the
// bits of g, i < 2).
__device__ __forceinline__ void mf_sums_quarter(const float (&v)[16], float* red, int q, int warp,
                                                int g, int t) {
  const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
  float w[8], x[4], z[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = (b0 ? v[8 + i] : v[i]) + __shfl_xor_sync(0xffffffffu, b0 ? v[i] : v[8 + i], 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = (b1 ? w[4 + i] : w[i]) + __shfl_xor_sync(0xffffffffu, b1 ? w[i] : w[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (b2 ? x[2 + i] : x[i]) + __shfl_xor_sync(0xffffffffu, b2 ? x[i] : x[2 + i], 16);
  const int base = 8 * b0 + 4 * b1 + 2 * b2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int vi = base + i, k = vi & 7;
    red[(8 * (vi >> 3) + warp) * MF_BN + 32 * q + 8 * (k >> 1) + 2 * t + (k & 1)] += z[i];
  }
}

// prep: one stage's x tile [128 rows, CK] folded in place (x a + b, relu;
// bf16 rounded to bf16 again), ab: a | b of the chunk.  Thread pt takes the
// 16-byte chunks pt, pt + GEMM_PREP, ...: always the same logical chunk j of
// a row (GEMM_PREP % 8 == 0), so the same columns of a and b.
template <bool F32>
__device__ __forceinline__ void mf_fold(unsigned char* xt, const float* ab, int relu_in, int pt) {
  constexpr int PER = F32 ? 4 : 8, CK = F32 ? 32 : 64;   // columns of a chunk, of the tile
  const int j = pt & 7;
  float fa[PER], fb[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    fa[e] = ab[PER * j + e];
    fb[e] = ab[CK + PER * j + e];
  }
  for (int q = pt; q < MF_BM * 8; q += GEMM_PREP) {
    const int row = q >> 3;
    uint4* at = reinterpret_cast<uint4*>(xt + row * 128 + ((j ^ (row & 7)) << 4));
    uint4 v = *at;
    if constexpr (F32) {
      float* f = reinterpret_cast<float*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = xhat_of(f[e], fa[e], fb[e], relu_in);
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(xhat_of(f.x, fa[2 * e], fb[2 * e], relu_in),
                                     xhat_of(f.y, fa[2 * e + 1], fb[2 * e + 1], relu_in));
      }
    }
    *at = v;
  }
}

// Work item i: tile (mt, nt) and K split z (tiles in row order, the splits
// of a tile a wave of tiles apart), its chunks [c0, c0 + units).
struct MfItem {
  int mt, nt, z, c0, units;
};

__device__ __forceinline__ MfItem mf_item(const MfArgs& a, int i) {
  const int tiles = a.tiles_m * a.tiles_n;
  const int z = i / tiles, r = i - z * tiles, mt = r / a.tiles_n;
  const int c0 = z * a.chunks / a.splits;
  return {mt, r - mt * a.tiles_n, z, c0, (z + 1) * a.chunks / a.splits - c0};
}

// A split tile's arrival counts: splitk_sum's one, or past a group of
// splits one per group and one more.
__device__ __forceinline__ int mf_per_tile(const MfArgs& a) {
  return a.splits > MF_SPLIT_GROUP ? (a.splits + MF_SPLIT_GROUP - 1) / MF_SPLIT_GROUP + 1 : 1;
}

// Block blockIdx.x takes work items blockIdx.x, blockIdx.x + gridDim.x, ...:
// with a grid of rows x tiles_n blocks, one column tile nt and the row tiles
// mt = blockIdx.x / tiles_n + R k (R = rows); split, one item.  The ring's
// units count on across items.  Item (mt, nt): rows [m0, m0 + 128), columns
// [n0, n0 + 128).  Consumer warpgroup wg owns rows m0 + 64 wg .. + 63:
// accumulator entry 4 j + 2 h + e of lane 4 g + t of its warp wq is row m0 +
// 64 wg + 16 wq + g + 8 h, column n0 + 8 j + 2 t + e (j < 16).
template <bool F32>
__device__ __forceinline__ void mf_body(const MfMaps& p) {
  using L = MfSmem<F32>;
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int CK = L::CK, ST = L::ST;
  extern __shared__ __align__(128) unsigned char mf_smem[];
  __shared__ int last;
  unsigned char* sp = smem_1024(mf_smem);
  const uint32_t su = smem_u32(sp);
  const uint32_t bars = su + L::BARS;
  const Ring<ST> ring{bars, bars + 8 * ST, bars + 16 * ST};
  const MfArgs& a = p.p;
  const int tid = threadIdx.x, lane = tid & 31;
  const int items = a.tiles_m * a.tiles_n * a.splits;
  const bool pro = a.a != nullptr;
  if (tid == 0) {
    ring.init(GEMM_PREP);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* red = reinterpret_cast<float*>(sp + L::RED);
  for (int i = tid; i < 2 * 8 * MF_BN; i += blockDim.x) red[i] = 0.f;
  __syncthreads();

  if (tid >= CONSUMERS) {
    const int pw = tid - CONSUMERS;
    if (pw == 0) {
      // ------------------------------------------------------- producer
      const uint32_t tx = L::TX + (pro ? 2 * CK * 4 : 0);
      int u = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const MfItem it = mf_item(a, i);
        for (int c = 0; c < it.units; ++c, ++u) {
          const uint32_t base = su + ring.acquire(u) * L::STAGE, bar = ring.full_bar(u);
          const int k = (it.c0 + c) * CK, n0 = it.nt * MF_BN;
          mbar_expect_tx(bar, tx);
          tma_load(base, &p.x, bar, k, it.mt * MF_BM, 0);
          if constexpr (F32) {
            tma_load(base + L::B0, &p.w, bar, k, n0, 0);
          } else {
            tma_load(base + L::B0, &p.w, bar, n0, k, 0);
            tma_load(base + L::B0 + CK * 128, &p.w, bar, n0 + 64, k, 0);
          }
          if (pro) {
            tma_load(base + L::AB0, &p.a, bar, k, 0, 0);
            tma_load(base + L::AB0 + CK * 4, &p.b, bar, k, 0, 0);
          }
        }
      }
    } else if (pw >= 32) {
      // ----------------------------------------------------------- prep
      // x folded in place; f32: W^T split in place into TF32 hi and lo
      int u = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int units = mf_item(a, i).units;
        for (int c = 0; c < units; ++c, ++u) {
          unsigned char* st = sp + ring.wait_full(u) * L::STAGE;
          if (pro)
            mf_fold<F32>(st, reinterpret_cast<const float*>(st + L::AB0), a.relu_in, pw - 32);
          if constexpr (F32)
            split_in_place(st + L::B0, st + L::B0 + L::B_TILE, L::B_TILE, pw - 32, GEMM_PREP);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          ring.arrive_ready(u);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wg = tid / WG_THREADS, wq = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int warp = tid / 32, r0 = 64 * wg + 16 * wq;   // the warp's first row of a tile
  bool owns = false;                  // some tile's sums are in red
  int u = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const MfItem it = mf_item(a, i);
    const int n0 = it.nt * MF_BN, u0 = u;
    float acc[64];
    zero(acc);
    if constexpr (F32) {
      // four 8-column k-steps a stage, three TF32 passes a half into a fresh
      // tile; A(row r0 + g + 8 (i & 1), column t + 4 (i >> 1)) in register i
      // (flash_attention_sm90.cuh's a_split_rows), split here
      const int j8 = lane >> 3, lr = r0 + (lane & 7) + 8 * (j8 & 1);
      const bool two = n0 + 64 < a.N;   // the second half holds columns of N
      for (int c = 0; c < it.units; ++c) {
        const uint32_t base = su + ring.wait_ready(u0 + c) * L::STAGE;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t d[4];
          ldmatrix4(d, base + f32_at<MF_BM>(lr, 8 * kk + 4 * (j8 >> 1)));
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(d[e]), ah[kk][e], al[kk][e]);
        }
        const uint32_t wt = base + L::B0;
        auto half = [&](auto hc) {
          constexpr int H = decltype(hc)::value;
          float tile[32];
          zero(tile);
          reg_fence(tile);
          reg_fence(ah);
          reg_fence(al);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma3(tile, ah[kk], al[kk], desc_f32<MF_BN>(wt + H * 64 * 128, 8 * kk),
                 desc_f32<MF_BN>(wt + L::B_TILE + H * 64 * 128, 8 * kk));
          wg_commit();
          wg_wait();
          reg_fence(tile);
          reg_fence(ah);
          reg_fence(al);
          add_half<H>(acc, tile);
        };
        half(std::integral_constant<int, 0>());
        if (two) half(std::integral_constant<int, 1>());
        ring.release(u0 + c, lane);
      }
    } else {
      // four 16-column k-steps a stage (m64n128), one pass chained in acc, A
      // (the warpgroup's 64 rows of the folded x tile) and B from shared
      // memory, one stage's products in flight while the next is issued
      for (int c = 0; c < it.units; ++c) {
        const uint32_t base = su + ring.wait_ready(u0 + c) * L::STAGE;
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_kn(acc, desc_sw128(base + wg * 64 * 128, 32 * kk),
                      desc_n<MF_BN, CK>(base + L::B0, 16 * kk, 0), 1);
        wg_commit();
        wg_wait1();
        if (c > 0) ring.release(u0 + c - 1, lane);   // its products are done
      }
      wg_wait();
      reg_fence(acc);
      ring.release(u0 + it.units - 1, lane);
    }
    u += it.units;

    const int mr = it.mt * MF_BM + r0 + g;   // this thread's rows: mr, mr + 8
    if (a.splits > 1) {
      const bool mine = splitk_sum<8, MF_SPLIT_GROUP>(
          acc, a.part, (size_t)a.M * a.N, it.z, a.splits,
          a.counts + (it.mt * a.tiles_n + it.nt) * mf_per_tile(a), &last, [&](int e) -> long long {
            const int m = mr + 8 * ((e >> 1) & 1), n = n0 + 8 * (e >> 2) + 2 * t + (e & 1);
            return m < a.M && n < a.N ? (long long)m * a.N + n : -1;
          });
      if (!mine) continue;
    }
    owns = true;
    // the column sums of the f32 accumulator over the tile's real rows, a
    // 32-column quarter at a time, added to the warp's running sums
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (mr + 8 * h >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = acc[16 * q + 4 * (e >> 1) + 2 * h + (e & 1)];
          v[e] += x;
          v[8 + e] += x * x;
        }
      }
      mf_sums_quarter(v, red, q, warp, g, t);
    }
    if (a.tma_y) {
      // y through the staging tile (its rows and columns past M and N are
      // not stored), written once the last tile's store has read it
      if (tid == 0) tma_store_read();
      consumers_sync(1);
      const uint32_t yt = su + L::Y0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * t;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (F32)
            st_shared(yt + f32_at<MF_BM>(r, c), v0, v1);
          else
            st_shared(yt + (c >> 6) * (MF_BM * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                          ((c & 7) << 1),
                      pack_bf16(v0, v1));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync(1);
      if (tid == 0) {
        constexpr int BX = F32 ? 32 : 64;   // columns of a box
#pragma unroll
        for (int bx = 0; bx < MF_BN / BX; ++bx)
          if (n0 + BX * bx < a.N)
            tma_store(&p.y, yt + bx * MF_BM * 128, n0 + BX * bx, it.mt * MF_BM, 0);
        tma_adds_commit();
      }
    } else {
      // rows of y that are no multiple of 16 bytes: stored from registers
      T* y = static_cast<T*>(a.y);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mr + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col >= a.N) continue;
          T* out = y + (size_t)row * a.N + col;
          out[0] = from_f32<T>(acc[4 * j + 2 * h]);
          if (col + 1 < a.N) out[1] = from_f32<T>(acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  if (tid == 0) tma_store_read();   // the block's smem stays until the last store has read it
  if (!owns) return;   // uniform over the block (splitk_sum's answer)
  // the block's sums over its tiles: row `first.mt` of the tables (split,
  // the tile's; else the block's, blockIdx.x / tiles_n)
  const MfItem first = mf_item(a, blockIdx.x);
  const int split_counts = a.splits > 1 ? a.tiles_m * a.tiles_n * mf_per_tile(a) : 0;
  const ColSums cs{a.stats, a.counts + split_counts, a.s1, a.s2, a.N, a.rows, a.tiles_n};
  consumers_sync(1);
  col_sums_tables<MF_BN>(red, cs, first.mt, first.nt, &last);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbf_f32_kernel(const __grid_constant__ MfMaps p) {
  mf_body<true>(p);
}

__global__ void __launch_bounds__(GEMM_THREADS, 1) mbf_bf16_kernel(const __grid_constant__ MfMaps p) {
  mf_body<false>(p);
}

// The f32 weight as TF32 wgmma takes it: W [K, ldw] -> W^T [N, ldk], zeros
// in the columns past K.  A block transposes a 32 x 32 tile (rows k0..,
// columns n0.. of W) through shared memory, reading and writing whole rows.
// A copy, no product: the GEMM's operand in the layout the tensor core
// needs, once a call.
__global__ void __launch_bounds__(256) mbf_wt_kernel(const float* __restrict__ w,
                                                     float* __restrict__ wt, int K, int N,
                                                     int ldw, int ldk) {
  __shared__ float tile[MF_WT][MF_WT + 1];
  const int k0 = blockIdx.x * MF_WT, n0 = blockIdx.y * MF_WT;
  const int tx = threadIdx.x % MF_WT, ty = threadIdx.x / MF_WT;
  for (int r = ty; r < MF_WT; r += 256 / MF_WT) {
    const int k = k0 + r, n = n0 + tx;
    tile[r][tx] = k < K && n < N ? w[(size_t)k * ldw + n] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < MF_WT; r += 256 / MF_WT) {
    const int n = n0 + r, k = k0 + tx;
    if (n < N && k < ldk) wt[(size_t)n * ldk + k] = tile[tx][r];
  }
}

template <bool F32>
int launch(const void* x, const void* w, const void* a, const void* b, void* y, void* sums,
           void* stats, void* part, void* wt, void* counts, int n_counts, int M, int N, int K,
           int ldx, int ldw, int splits, int blocks, int rows, int relu_in, void* stream) {
  using L = MfSmem<F32>;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int ldk = (K + 3) / 4 * 4;
  MfMaps p;
  MfArgs& q = p.p;
  q.a = static_cast<const float*>(a);
  q.y = y;
  q.part = static_cast<float*>(part);
  q.stats = static_cast<float*>(stats);
  q.counts = static_cast<int*>(counts);
  q.s1 = static_cast<float*>(sums);
  q.s2 = q.s1 + N;
  q.M = M;
  q.N = N;
  q.K = K;
  q.chunks = (K + L::CK - 1) / L::CK;
  q.splits = splits;
  q.tiles_m = (M + MF_BM - 1) / MF_BM;
  q.tiles_n = (N + MF_BN - 1) / MF_BN;
  q.rows = rows;
  q.relu_in = relu_in;
  q.tma_y = (size_t)N * (F32 ? 4 : 2) % 16 == 0;
  if (!(tma_map_sw128(&p.x, x, F32, ldx, M, 1, MF_BM, 1) &&
        (F32 ? tma_map_sw128(&p.w, wt, true, ldk, N, 1, MF_BN, 1)
             : tma_map_sw128(&p.w, w, false, ldw, K, 1, L::CK, 1)) &&
        (a == nullptr || (vec_map(&p.a, a, K, L::CK) && vec_map(&p.b, b, K, L::CK))) &&
        (!q.tma_y || tma_map_sw128(&p.y, y, F32, N, M, 1, MF_BM, 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n_counts * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F32) {
    mbf_wt_kernel<<<dim3((ldk + MF_WT - 1) / MF_WT, (N + MF_WT - 1) / MF_WT), 256, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(wt), K, N, ldw, ldk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_kernel(F32 ? mbf_f32_kernel : mbf_bf16_kernel, dim3(blocks), GEMM_THREADS,
                       L::BYTES, s, p);
}

}  // namespace

extern "C" {

// The kernel's tiles, which the wrapper's plan must use: the tile's rows and
// columns, and the K columns of a stage in f32 and in bf16 (i = 0..3).
int matmul_bn_act_tile(int i) {
  const int sizes[4] = {MF_BM, MF_BN, MfSmem<true>::CK, MfSmem<false>::CK};
  return i >= 0 && i < 4 ? sizes[i] : -1;
}

// x [M, ldx], W [K, ldw] (rows zero past K, N), a, b [K] or null; y [M, N];
// the scratch of the plan: sums [2, N] (s1, s2), stats, part (splits > 1),
// wt (f32: W^T), counts [n_counts] (zeroed here); the plan's K splits,
// blocks and column-sum table rows.
int matmul_bn_act_f32(const void* x, const void* w, const void* a, const void* b, void* y,
                      void* sums, void* stats, void* part, void* wt, void* counts, int n_counts,
                      int M, int N, int K, int ldx, int ldw, int splits, int blocks, int rows,
                      int relu_in, void* stream) {
  return launch<true>(x, w, a, b, y, sums, stats, part, wt, counts, n_counts, M, N, K, ldx, ldw,
                      splits, blocks, rows, relu_in, stream);
}

int matmul_bn_act_bf16(const void* x, const void* w, const void* a, const void* b, void* y,
                       void* sums, void* stats, void* part, void* wt, void* counts, int n_counts,
                       int M, int N, int K, int ldx, int ldw, int splits, int blocks, int rows,
                       int relu_in, void* stream) {
  return launch<false>(x, w, a, b, y, sums, stats, part, wt, counts, n_counts, M, N, K, ldx, ldw,
                       splits, blocks, rows, relu_in, stream);
}

}  // extern "C"
